"""The port's span tracing (``repro_torch.tracing``) and the serve loop's
records that ride it, on the CPU; one test on the card.

  * With no active tracer a model span is the shared ``NULL_SPAN`` and no
    tracer gets an event; the executor's tracer is active only for the
    length of its call, and only on the thread that activated it, which
    keeps its own stack of open spans.
  * Device time is asked for in the executor's prefill only: a decode
    step's spans are host spans.
  * Spans carry ``span_id`` / ``parent_id``, and the written trace keeps
    their nesting on the profiler's clock: each span starts where its
    ``record_function`` range does in a ``torch.profiler`` trace of the
    same serve (within 5 ms on the CPU, 1 ms on the card, where the
    prefill's attention and dense spans also carry their device time).
  * A request submitted during a slow step counts its wait in the loop's
    inbox (``inbox_wait_s``), and the step records count the K1 and K2
    launches of their step.

The card's test carries the ``cuda`` marker and skips here.  This file
imports no JAX, so that it also runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tracing.py
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import serving, tracing
from repro_torch.configs.base import get_arch
from repro_torch.core.bp_matmul import quantized_matmul
from repro_torch.kernels.bitparticle_matmul import ops as k1_ops
from repro_torch.kernels.paged_attention import ops as k2_ops
from repro_torch.models import api, attention


def _cfg(layers=1):
    return get_arch("qwen2-1.5b").reduced().replace(
        num_layers=layers, d_model=32, d_ff=64, vocab_size=64, head_dim=8,
        matmul_mode="bp_exact")


def _loop(tel=None, *, device="cpu", faults=None, n_requests=3,
          max_new_tokens=6, layers=1):
    cfg = _cfg(layers)
    eng = serving.ServingEngine(cfg, api.init(cfg, device=device),
                                serving.ServeConfig(
                                    cache_backend="paged", block_size=4,
                                    telemetry=tel, faults=faults),
                                device=device)
    rng = np.random.default_rng(0)
    reqs = [serving.Request(prompt=rng.integers(2, 64, 10),
                            max_new_tokens=max_new_tokens, arrival_time=0.0)
            for _ in range(n_requests)]
    return eng.make_loop(reqs, n_slots=3, cache_T=24, num_blocks=24)


def _model_calls(device="cpu"):
    """One prefill attention, one decode attention and one quantized
    matmul."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 4, 8, generator=g).to(device)
    k = torch.randn(2, 4, 2, 8, generator=g).to(device)
    attention.flash_attention(q, k, k)
    attention.decode_attention(q[:, :1], k, k, 2)
    w = torch.randint(-127, 128, (8, 16), dtype=torch.int8, generator=g)
    quantized_matmul(q.reshape(-1, 8), k1_ops.kmajor(w.to(device)),
                     torch.ones(16, device=device), "bp_exact")


def _spans(tr):
    return [e for e in tr.events if e["ph"] == "X"]


def test_no_active_tracer_gives_the_null_span_and_records_nothing():
    assert tracing.local.tracer is None
    assert tracing.span("x", a=1) is tracing.NULL_SPAN
    assert tracing.device_span("x", torch.ones(1)) is tracing.NULL_SPAN
    assert tracing.activate(None) is tracing.NULL_SPAN
    tr = tracing.Tracer()
    _model_calls()
    assert _spans(tr) == []
    with tracing.activate(tr):
        assert tracing.local.tracer is tr
        _model_calls()
    assert tracing.local.tracer is None
    spans = _spans(tr)
    assert [e["name"] for e in spans] == ["attention", "attention", "dense"]
    assert spans[0]["args"] == {"rows": 2, "q_len": 4, "kv_len": 4}
    assert spans[1]["args"] == {"rows": 2, "q_len": 1, "kv_len": 4}
    assert spans[2]["args"] == {"m": 32, "k": 8, "n": 16}
    # the CPU has no device time
    assert all("device_s" not in e["args"] for e in spans)
    _model_calls()
    assert len(_spans(tr)) == 3
    with pytest.raises(RuntimeError), tracing.activate(tr):
        raise RuntimeError("boom")
    assert tracing.local.tracer is None


def test_only_the_activating_thread_records():
    """The active tracer and the open spans are per thread: a tracer held
    by one thread records nothing of another's calls, a second thread's
    own tracer gets its spans with that thread's parents, and a nested
    activation gives the outer tracer back when it ends."""
    mine, other = tracing.Tracer(), tracing.Tracer()
    seen = {}
    inside = threading.Barrier(2, timeout=30)

    def elsewhere():
        seen["span"] = tracing.span("x")
        with tracing.activate(other), other.span("step"):
            seen["active"] = tracing.local.tracer
            inside.wait()                  # the main thread's span is open
            _model_calls()
            inside.wait()

    with tracing.activate(mine), mine.span("outer"):
        th = threading.Thread(target=elsewhere)
        th.start()
        inside.wait()
        with tracing.span("mine_inner"):
            inside.wait()
        th.join(timeout=30)
        assert not th.is_alive()
        with tracing.activate(other):       # nested: back to mine after
            assert tracing.local.tracer is other
        assert tracing.local.tracer is mine
    assert seen == {"span": tracing.NULL_SPAN, "active": other}
    assert tracing.local.tracer is None
    by = {e["name"]: e for e in _spans(mine)}
    assert set(by) == {"outer", "mine_inner"}
    assert by["mine_inner"]["parent_id"] == by["outer"]["span_id"]
    theirs = _spans(other)
    assert [e["name"] for e in theirs] == ["attention", "attention", "dense",
                                           "step"]
    step = theirs[-1]
    assert step["parent_id"] is None
    assert all(e["parent_id"] == step["span_id"] for e in theirs[:3])


class _FakeEvent:
    """Stands in for ``torch.cuda.Event`` on the CPU: records the host
    clock, and has passed as soon as it is recorded."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class _CudaLike:
    """A tensor's device attributes as a CUDA tensor has them."""

    is_cuda = True


def test_device_time_only_where_the_activation_asks_for_it(monkeypatch):
    """A span over a CUDA tensor records an event pair only under
    ``activate(..., device=True)``; the pair becomes ``device_s`` when
    resolved, and its events go back to the pool."""
    monkeypatch.setattr(tracing.torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    tr, x = tracing.Tracer(), _CudaLike()
    with tracing.activate(tr):
        with tracing.device_span("attention", x, rows=1):
            pass
    assert _FakeEvent.made == 0 and tr._pending == []
    for _ in range(2):
        with tracing.activate(tr, device=True):
            with tracing.device_span("attention", x, rows=1):
                time.sleep(0.002)
            with tracing.device_span("dense", torch.ones(1), m=1):
                pass                        # a CPU tensor: not timed
        assert len(tr._pending) == 1
        tr.resolve_device_spans()
        assert tr._pending == [] and len(tr._free) == 2
    assert _FakeEvent.made == 2             # the second pair reused them
    spans = _spans(tr)
    assert [("device_s" in e["args"]) for e in spans] == [
        False, True, False, True, False]
    assert all(e["args"]["device_s"] >= 0.002 for e in spans
               if "device_s" in e["args"])


def test_the_executor_times_the_device_in_prefill_only(monkeypatch):
    """The model's spans ask for device time inside the executor's prefill
    and not inside a decode step, whose spans stay host spans."""
    asked = []
    device_span = tracing.device_span

    def spy(name, x, **args):
        asked.append((name, tracing.local.device, tracing.local.stack[-1]))
        return device_span(name, x, **args)

    monkeypatch.setattr(tracing, "device_span", spy)
    tel = serving.Telemetry(trace_path=None, annotate_device=True)
    tel.tracer.annotate_device = False
    _loop(tel, n_requests=2, max_new_tokens=3).run()
    by_id = {e["span_id"]: e for e in _spans(tel.tracer)}

    def under(span_id):
        while by_id[span_id]["name"] not in ("prefill", "decode_forward"):
            span_id = by_id[span_id]["parent_id"]
        return by_id[span_id]["name"]

    seen = {(under(parent), device) for _, device, parent in asked}
    assert seen == {("prefill", True), ("decode_forward", False)}
    assert tracing.local.device is False and tracing.local.tracer is None


def test_span_ids_name_the_enclosing_span():
    tr = tracing.Tracer()
    with tr.span("outer"):
        with tr.span("mid", n=np.int64(2)):
            with tr.span("inner"):
                pass
        with tr.span("second"):
            pass
    by = {e["name"]: e for e in _spans(tr)}
    assert by["outer"]["parent_id"] is None
    assert by["mid"]["parent_id"] == by["outer"]["span_id"]
    assert by["inner"]["parent_id"] == by["mid"]["span_id"]
    assert by["second"]["parent_id"] == by["outer"]["span_id"]
    assert len({e["span_id"] for e in by.values()}) == 4
    assert by["mid"]["args"] == {"n": 2}      # ids sit beside args


def _check_overlay(tmp_path, device, tol_us):
    """A traced, profiled serve writes a span trace and a profiler trace
    on one clock: each span starts within ``tol_us`` of its
    ``record_function`` range, the two files name the same base time, and
    the written spans nest as their ids say."""
    tel = serving.Telemetry(trace_path=str(tmp_path / "spans.json"),
                            profile_dir=str(tmp_path / "prof"),
                            annotate_device=True)
    _loop(tel, device=device).run()
    tel.close()
    mine = json.loads((tmp_path / "spans.json").read_text())
    prof = json.loads(open(tel.profile_paths[0]).read())
    assert mine["baseTimeNanoseconds"] == prof["baseTimeNanoseconds"]
    spans = [e for e in mine["traceEvents"] if e["ph"] == "X"]
    ranges = [e for e in prof["traceEvents"]
              if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in spans}
    assert {"prefill", "install", "sample", "match_prefix", "register",
            "decode", "decode_forward", "attention", "dense"} <= names
    for name in names:
        a = sorted(e["ts"] for e in spans if e["name"] == name)
        b = sorted(float(e["ts"]) for e in ranges if e["name"] == name)
        assert len(a) == len(b), name
        worst = max(abs(x - y) for x, y in zip(a, b))
        assert worst <= tol_us, (name, worst)
    by_id = {e["span_id"]: e for e in spans}
    for e in spans:
        p = by_id.get(e["parent_id"])
        if p is not None:
            assert p["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"]
    return spans, by_id


def test_the_written_trace_lines_up_with_the_profilers(tmp_path):
    spans, _ = _check_overlay(tmp_path, "cpu", 5_000.0)
    assert all("device_s" not in e["args"] for e in spans)


@pytest.mark.cuda
def test_the_written_trace_lines_up_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device timing runs on the card")
    spans, by_id = _check_overlay(tmp_path, "cuda", 1_000.0)
    model = [e for e in spans if e["name"] in ("attention", "dense")]
    timed = [e for e in model if by_id[e["parent_id"]]["name"] == "prefill"]
    assert timed and all(e["args"]["device_s"] > 0 for e in timed)
    # a decode step's spans are host spans
    assert len(timed) < len(model)
    assert all("device_s" not in e["args"] for e in model
               if by_id[e["parent_id"]]["name"] == "decode_forward")
    # device time inside a prefill cannot pass the prefill's wall, which
    # ends in a sync
    inside = {}
    for e in timed:
        p = by_id[e["parent_id"]]
        inside[p["span_id"]] = (inside.get(p["span_id"], 0.0)
                                + e["args"]["device_s"])
    assert inside
    for pid, dev_s in inside.items():
        assert dev_s * 1e6 <= by_id[pid]["dur"]


def test_a_request_submitted_during_a_slow_step_counts_its_inbox_wait():
    faults = serving.FaultInjector(schedule=[("slow", 2)], slow_s=0.6)
    slept = threading.Event()
    t_sleep = []
    delay = faults.delay

    def marked_delay(**ctx):
        if faults._checks.get("slow", 0) == 2:
            t_sleep.append(time.perf_counter())
            slept.set()
        delay(**ctx)

    faults.delay = marked_delay
    loop = _loop(faults=faults, n_requests=1, max_new_tokens=8)
    out = {}
    th = threading.Thread(
        target=lambda: out.update(rep=loop.run_forever(poll_s=0.001)))
    th.start()
    try:
        assert slept.wait(timeout=60)
        time.sleep(0.1)
        late = serving.Request(prompt=np.arange(2, 12), max_new_tokens=2)
        loop.submit(late)
    finally:
        loop.close()
        th.join(timeout=60)
    assert not th.is_alive() and "rep" in out
    left = t_sleep[0] + faults.slow_s - late.wall_received_at
    assert left > 0.3
    recs = {r["request_id"]: r for r in loop.stream
            if r["kind"] == "request"}
    assert recs[late.request_id]["inbox_wait_s"] >= left
    first = [r for r in recs.values() if r["request_id"] != late.request_id]
    assert first[0]["inbox_wait_s"] is None     # built with the loop


def test_step_records_count_the_kernel_launches(monkeypatch):
    """The plain versions launch nothing, so wrapped calls bump the
    counters as the kernels would; each step record's counts are the
    calls made since the previous step record."""
    calls = []
    loop = _loop(n_requests=3, max_new_tokens=5, layers=2)

    def counted(mod, fn_name, key, tag):
        fn = getattr(mod, fn_name)

        def wrapped(*a, **kw):
            mod.LAUNCHES[key] += 1
            calls.append((tag, len(loop.stream)))
            return fn(*a, **kw)

        monkeypatch.setattr(mod, fn_name, wrapped)
        monkeypatch.setitem(mod.LAUNCHES, key, mod.LAUNCHES[key])

    counted(k1_ops, "bp_matmul", "bp_matmul", "k1")
    counted(k2_ops, "paged_attention", "paged_attention", "k2")
    k1_0 = k1_ops.LAUNCHES["bp_matmul"]
    k2_0 = k2_ops.LAUNCHES["paged_attention"]
    loop.run()
    steps = [(i, r) for i, r in enumerate(loop.stream)
             if r["kind"] in ("prefill", "decode", "verify")]
    prev = -1
    for i, r in steps:
        for tag in ("k1", "k2"):
            made = sum(1 for t, n in calls if t == tag and prev < n <= i)
            assert r[f"{tag}_launches"] == made, (i, r["kind"], tag)
        prev = i
    decodes = [r for _, r in steps if r["kind"] == "decode"]
    assert decodes and all(r["k1_launches"] == 7 * 2 and
                           r["k2_launches"] == 2 for r in decodes)
    assert sum(r["k1_launches"] for _, r in steps) == \
        k1_ops.LAUNCHES["bp_matmul"] - k1_0
    assert sum(r["k2_launches"] for _, r in steps) == \
        k2_ops.LAUNCHES["paged_attention"] - k2_0
