"""Span tracing of the port: the Chrome-trace recorder, the tracer the
model code reaches, and device time of a span by CUDA events.

  * :class:`Tracer`: complete ("X") events with a ``span_id`` and the
    ``parent_id`` of the span open around each on its thread, in memory as
    µs after the tracer's ``_t0`` (a ``time.perf_counter`` value) and
    written on the profiler's clock (:meth:`Tracer.write`), so a span trace
    and a ``torch.profiler`` trace of the same run overlay in one Perfetto
    view.
  * The active tracer: :func:`activate` makes a tracer the one the model's
    spans (:func:`span`, :func:`device_span`) record into while a call
    runs on the calling thread.  The serving executor activates its
    telemetry's tracer for each prefill and decode or verify step; with
    none active (every untraced run, and training) a span is the shared
    :data:`NULL_SPAN`.  The active tracer and the stack of open spans are
    per thread (:data:`local`), so two serve loops on two threads each
    record their own spans with their own parents.  Hot call sites test
    ``tracing.local.tracer is None`` first, so that nothing is computed or
    allocated for a span when tracing is off.
  * Device time: while a tracer is active with ``device=True`` (the
    executor's prefill), a :func:`device_span` over a CUDA tensor records a
    pair of timing events on the current stream, from a pool the tracer
    reuses.  :meth:`Tracer.resolve_device_spans` turns completed pairs into
    the span's ``args["device_s"]``; the serve loop calls it after the
    prefill's sync, so tracing adds no synchronization.  ``device_s`` is
    stream time from the span's first kernel to its last, and holds the
    device's idle between them where the host launches more slowly than
    the device runs.  Decode and verify steps are not timed on the device:
    their spans are host spans.

This module imports nothing of the package, so the models can import it.
Cost with tracing on, on an H100 machine's host: a model span ~3 µs, one
timed on the device ~30 µs with its event pair, and ~8 µs to resolve the
pair (``Event.query``, ``elapsed_time``); a decode step of qwen2-1.5b opens
~225 host spans, and a prefill as many timed ones.  The recorded events are
held for the run, so the garbage collector's passes over them grow with it.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

#: kineto writes a trace's timestamps as µs after a base time that it
#: rounds down to a multiple of this many seconds, and states the base in
#: the file's ``baseTimeNanoseconds`` (``libkineto::ChromeTraceBaseTime``)
KINETO_BASE_S = 7_889_238


class _NullSpan:
    """Shared do-nothing context manager: the disabled span (the hot loop
    allocates nothing per span when tracing is off)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def _plain(args: dict) -> dict:
    """``args`` with its numpy scalars made Python ones, in place (the
    dict is the call's own keyword dict)."""
    for k, v in args.items():
        if isinstance(v, np.generic):
            args[k] = v.item()
    return args


class _Local(threading.local):
    """Per-thread tracing state: the active tracer, whether its model
    spans record device time, and the ids of the spans open on the
    thread."""

    def __init__(self):
        self.tracer: Optional["Tracer"] = None
        self.device = False
        self.stack: List[int] = []


#: this thread's tracing state (``local.tracer`` None: tracing off)
local = _Local()

#: span ids, unique in the process: a parent may be another tracer's span
_ids = itertools.count(1)


class _Span:
    """One span of a :class:`Tracer`, recorded when it closes (also when
    its body raises)."""

    __slots__ = ("tracer", "name", "cat", "args", "timed", "id", "parent",
                 "t0", "range", "start")

    def __init__(self, tracer, name, cat, args, timed=False):
        self.tracer, self.name, self.cat = tracer, name, cat
        self.args, self.timed = args, timed
        self.range = self.start = None

    def __enter__(self):
        tr = self.tracer
        self.t0 = tr._now_us()
        if tr.annotate_device:
            # stamped inside the range's entry: the span starts before it
            # and ends after its exit, so the two nest
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.id = next(_ids)
        stack = local.stack
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        if self.timed:
            self.start = tr._record()
        return tr

    def __exit__(self, *exc):
        tr = self.tracer
        args = _plain(self.args)
        if self.start is not None:
            tr._pending.append((args, self.start, tr._record()))
        local.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        t1 = tr._now_us()
        tr.events.append({
            "name": self.name, "cat": self.cat, "ph": "X", "ts": self.t0,
            "dur": t1 - self.t0, "pid": tr._pid, "tid": 0,
            "span_id": self.id, "parent_id": self.parent, "args": args,
        })
        return False


class Tracer:
    """Chrome-trace-event recorder (complete "X" events, µs timestamps).

    Spans nest by construction: a thread's spans are stamped with
    monotonic ``time.perf_counter`` reads, so a child span lies inside its
    parent, and each X event names the ``span_id`` of the span open around
    it on its thread.  With
    ``annotate_device`` every span also enters
    ``torch.profiler.record_function``.  ``write()`` dumps the standard
    ``{"traceEvents": [...]}`` wrapper that perfetto / chrome://tracing load
    directly."""

    def __init__(self, *, annotate_device: bool = False):
        self.events: List[dict] = []
        self.annotate_device = annotate_device
        # the two clocks read together: in memory a span is µs after _t0
        # (perf_counter), in the file µs after kineto's base time
        wall_ns, perf_ns = time.time_ns(), time.perf_counter_ns()
        self._t0 = perf_ns / 1e9
        self.base_ns = (wall_ns // 10 ** 9 // KINETO_BASE_S
                        * KINETO_BASE_S * 10 ** 9)
        self._offset_us = (wall_ns - self.base_ns) / 1e3
        self._pid = os.getpid()
        # device timing: (span args, start event, end event) awaiting a
        # sync, and the idle events
        self._pending: List[tuple] = []
        self._free: list = []
        self.events.append({
            "name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
            "args": {"name": "repro_torch.serving"},
        })

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def span(self, name: str, cat: str = "serving", **args) -> _Span:
        return _Span(self, name, cat, args)

    def _record(self):
        """A pooled timing event recorded on the current stream."""
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record()
        return ev

    def resolve_device_spans(self) -> None:
        """Write ``device_s`` into each span whose event pair the device has
        passed and return the events to the pool; nothing waits for a pair
        still running (after the serve loop's syncs, none is)."""
        pending, self._pending = self._pending, []
        for pair in pending:
            args, start, end = pair
            if end.query():
                args["device_s"] = start.elapsed_time(end) / 1e3
                self._free += (start, end)
            else:
                self._pending.append(pair)

    def instant(self, name: str, cat: str = "serving", **args):
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self._now_us(), "pid": self._pid, "tid": 0,
            "args": _plain(args),
        })

    def counter(self, name: str, **values):
        """Chrome-trace counter ("C") sample: perfetto renders one counter
        track named ``name`` with a series per keyword."""
        self.events.append({
            "name": name, "ph": "C", "ts": self._now_us(),
            "pid": self._pid, "tid": 0,
            "args": _plain(values),
        })

    def write(self, path: str):
        """Write the trace with every ``ts`` as µs after ``base_ns`` (the
        file's ``baseTimeNanoseconds``), as kineto writes a
        ``torch.profiler`` trace: the two overlay.  A span's written end
        is its end on that clock, so rounding keeps nesting.  A span still
        running on the device is written without its ``device_s``."""
        self.resolve_device_spans()
        off = self._offset_us
        out = []
        for ev in self.events:
            if "ts" in ev:
                ts = ev["ts"] + off
                if ev["ph"] == "X":
                    ev = dict(ev, ts=ts, dur=ev["ts"] + ev["dur"] + off - ts)
                else:
                    ev = dict(ev, ts=ts)
            out.append(ev)
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": self.base_ns}, f)


# ---------------------------------------------------------------------------
# The active tracer
# ---------------------------------------------------------------------------


class _Activation:
    __slots__ = ("tracer", "device", "prev")

    def __init__(self, tracer: Tracer, device: bool):
        self.tracer, self.device = tracer, device

    def __enter__(self):
        self.prev = (local.tracer, local.device)
        local.tracer, local.device = self.tracer, self.device
        return self.tracer

    def __exit__(self, *exc):
        local.tracer, local.device = self.prev
        return False


def activate(tracer: Optional[Tracer], *, device: bool = False):
    """Context manager: ``tracer`` is this thread's active tracer for the
    body, its model spans timed on the device with ``device`` (a no-op for
    None); the previous one is active again after it."""
    return NULL_SPAN if tracer is None else _Activation(tracer, device)


def span(name: str, **args):
    """A span of the active tracer, or :data:`NULL_SPAN` with none."""
    t = local.tracer
    return NULL_SPAN if t is None else _Span(t, name, "model", args)


def device_span(name: str, x, **args):
    """A span of the active tracer that also times the device's stream over
    its body when the tracer was activated with ``device`` and ``x`` is a
    CUDA tensor (see :meth:`Tracer.resolve_device_spans`), or
    :data:`NULL_SPAN` with none."""
    t = local.tracer
    return NULL_SPAN if t is None else _Span(
        t, name, "model", args, local.device and x.is_cuda)
