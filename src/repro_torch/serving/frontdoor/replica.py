"""One engine replica behind the front door (port of
``repro/serving/frontdoor/replica.py``, bound to the port's engine).

A :class:`Replica` wraps a ``ServingEngine`` plus a live ``ServeLoop``
(``run_forever`` on a daemon worker thread) and exposes the thread-safe
surface the router and HTTP server need: ``submit`` with per-request
token/finish callbacks, ``cancel`` (client disconnects ride the engine's
existing cancellation lifecycle — slot and blocks free at the loop's next
sweep), and ``stats`` (queue depth, modeled cost hint, prefix-cache
gauges) for routing decisions.

Callbacks fire ON THE REPLICA'S WORKER THREAD: keep them cheap and
thread-safe (the HTTP server bridges them onto its event loop with
``call_soon_threadsafe``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from repro_torch.serving.engine import ServeReport, ServingEngine
from repro_torch.serving.queue import Request


class RequestHandle:
    """Per-request callback registration + terminal-state latch."""

    __slots__ = ("request", "on_token", "on_finish", "notified")

    def __init__(self, request: Request,
                 on_token: Optional[Callable[[int, int], None]] = None,
                 on_finish: Optional[Callable[[Request], None]] = None):
        self.request = request
        self.on_token = on_token
        self.on_finish = on_finish
        self.notified = False


class Replica:
    """A named engine replica running a live serve loop."""

    def __init__(self, engine: ServingEngine, *, name: str = "r0",
                 n_slots: int = 4, cache_T: int = 256,
                 num_blocks: Optional[int] = None, sched_cfg=None,
                 poll_s: float = 0.001):
        self.name = name
        self.engine = engine
        self.poll_s = poll_s
        # an explicit cache_T is REQUIRED here: the loop is built over an
        # empty request list, so the usual derive-from-requests default
        # would size the cache for nothing
        self.loop = engine.make_loop([], n_slots=n_slots, cache_T=cache_T,
                                     num_blocks=num_blocks,
                                     sched_cfg=sched_cfg)
        self.loop.on_token = self._on_token
        self.loop.on_step_end = self._on_step_end
        self._handles: Dict[int, RequestHandle] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.report: Optional[ServeReport] = None
        self.error: Optional[BaseException] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Replica":
        if self._thread is not None:
            raise RuntimeError(f"replica {self.name} already started")
        self._thread = threading.Thread(
            target=self._run, name=f"replica-{self.name}", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        try:
            self.report = self.loop.run_forever(poll_s=self.poll_s)
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised
            self.error = e
            raise
        finally:
            # a normal drain leaves no handles; after a worker crash the
            # in-flight ones would wait forever — fire their on_finish so
            # callers unblock (the request is still non-terminal, which
            # is how they can tell)
            with self._lock:
                orphans = [h for h in self._handles.values()
                           if not h.notified]
                for h in orphans:
                    h.notified = True
                self._handles.clear()
            for h in orphans:
                if h.on_finish is not None:
                    h.on_finish(h.request)

    def close(self, join: bool = True) -> Optional[ServeReport]:
        """Stop accepting work, drain in-flight requests, and (with
        ``join``) wait for the worker to exit and return its report.
        Re-raises (wrapped) if the worker died on an exception."""
        self.loop.close()
        if join and self._thread is not None:
            self._thread.join()
            if self.error is not None:
                raise RuntimeError(
                    f"replica {self.name} worker died") from self.error
        return self.report

    # -- request surface ----------------------------------------------------

    def submit(self, request: Request,
               on_token: Optional[Callable[[int, int], None]] = None,
               on_finish: Optional[Callable[[Request], None]] = None) -> int:
        """Enqueue one request; returns its request_id.  ``on_token(tok,
        index)`` fires once per FRESH token (replay re-emissions after a
        preemption are suppressed upstream), ``on_finish(request)`` once
        when it reaches a terminal state."""
        if self.error is not None:
            raise RuntimeError(
                f"replica {self.name} worker died") from self.error
        handle = RequestHandle(request, on_token, on_finish)
        with self._lock:
            self._handles[int(request.request_id)] = handle
        try:
            self.loop.submit(request)
        except RuntimeError:
            with self._lock:
                self._handles.pop(int(request.request_id), None)
            raise
        return int(request.request_id)

    def cancel(self, request_id: int) -> None:
        """Cancel an in-flight request (idempotent; unknown ids no-op).
        The loop's next sweep evicts it and frees its slot/blocks — this
        is the client-disconnect path."""
        self.engine.cancel(int(request_id))

    # -- loop hooks (worker thread) -----------------------------------------

    def _on_token(self, req: Request, tok: int, index: int):
        with self._lock:
            handle = self._handles.get(int(req.request_id))
        if handle is not None and handle.on_token is not None:
            handle.on_token(int(tok), int(index))

    def _on_step_end(self, loop):
        done = []
        with self._lock:
            for rid, handle in self._handles.items():
                if handle.request.is_terminal and not handle.notified:
                    handle.notified = True
                    done.append(rid)
            finished = [self._handles.pop(rid) for rid in done]
        for handle in finished:
            if handle.on_finish is not None:
                handle.on_finish(handle.request)

    # -- routing inputs -----------------------------------------------------

    @property
    def block_size(self) -> int:
        return int(self.engine.serve_cfg.block_size)

    def stats(self) -> dict:
        """Routing-relevant load snapshot (thread-safe, approximate: the
        worker may move a request between stages mid-read)."""
        loop = self.loop
        with loop._inbox_lock:
            inbox = len(loop._inbox)
        out = {
            "name": self.name,
            "queue_depth": (inbox + len(loop.arrivals) + len(loop.rq)
                            + len(loop.active)),
            "active_slots": len(loop.active),
            "n_slots": int(loop.n_slots),
            # cost-aware routing hint: running mean of modeled BitParticle
            # array cycles per processed token (0.0 until the probe's
            # first hw_estimate sample lands)
            "cost_hint_cycles_per_token": float(
                loop.cost_hint_cycles_per_token),
        }
        pool = getattr(loop.cm, "pool", None)
        if pool is not None:
            out["prefix_hit_blocks"] = int(pool.n_prefix_hits)
            out["blocks_in_use"] = int(pool.n_live)
        return out
