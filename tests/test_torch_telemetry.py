"""The telemetry sinks of the PyTorch port (``repro_torch.serving.telemetry``)
against the JAX package's.

  * The golden record schema (``STEP_SCHEMA``, ``SCHEMA_VERSION``) is the
    reference's, key for key.
  * ``reduce_stream`` folds every record kind (the step records, the
    lifecycle records, the fault-ladder records and ``hw_estimate``) to the
    reference's ``StreamSummary``, field for field, on the same stream;
    ``percentiles`` equals the reference's.
  * A served run's JSONL file parses back to the live records, and the
    report equals the fold of the file (a paged serve whose small pool
    preempts and whose pool-pressure rung degrades).
  * The Chrome trace parses, its spans nest, and the metrics logger flushes
    every line and closes on exit.
  * ``profile_dir`` writes a ``torch.profiler`` trace per serve, and a sink
    that was asked for and fails raises.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.serving import telemetry as jtel
from repro_torch import serving
from repro_torch.configs.base import get_arch
from repro_torch.models import api
from repro_torch.serving import telemetry as ttel


def _cfg():
    return get_arch("qwen2-1.5b").reduced().replace(
        num_layers=1, d_model=32, d_ff=64, vocab_size=64, head_dim=8,
        matmul_mode="bp_exact")


def _prompts(n=3, seed=0):
    rng = np.random.default_rng(seed)
    system = rng.integers(2, 64, 8)
    return [np.concatenate([system, rng.integers(2, 64, 3 + i)]).astype(
        np.int32) for i in range(n)]


def _serve(tel, *, probe=None, backend="paged", num_blocks=8, **kw):
    cfg = _cfg()
    eng = serving.ServingEngine(cfg, api.init(cfg, device="cpu"),
                                serving.ServeConfig(
                                    max_new_tokens=6, cache_backend=backend,
                                    block_size=4, pool_pressure_limit=1,
                                    telemetry=tel, probe=probe),
                                device="cpu")
    loop = eng.make_loop([serving.Request(prompt=p, max_new_tokens=6,
                                          arrival_time=0.0)
                          for p in _prompts()], n_slots=3, cache_T=24,
                         num_blocks=num_blocks, **kw)
    return loop, loop.run()


def test_schema_is_the_references():
    assert ttel.SCHEMA_VERSION == jtel.SCHEMA_VERSION
    assert ttel.STEP_SCHEMA == jtel.STEP_SCHEMA


def _synthetic_stream():
    """Every record kind the fold reads, with the reference's key sets."""
    rng = np.random.default_rng(0)
    gauges = dict(blocks_in_use=3, prefix_hit_blocks=1, cow_blocks=0,
                  peak_blocks_in_use=4, h2d_bytes=40, d2h_bytes=12)
    recs = [{"kind": "run"}]
    for step in range(6):
        recs.append(dict(kind="prefill", step=step, phases={
            "dispatch_s": float(rng.random())}, new_sync=step % 2 == 0,
            committed_tokens=2, active_slots=2, **gauges))
        recs.append(dict(kind="decode" if step % 3 else "verify", step=step,
                         phases={"dispatch_s": float(rng.random())},
                         occupancy=float(rng.random()),
                         committed_tokens=3, divergence=step,
                         active_slots=3, drafted_tokens=4,
                         accepted_tokens=2, chunk_tokens=step, **gauges))
        recs.append(dict(kind="hw_estimate", step=step,
                         act_bit_sparsity=float(rng.random()),
                         act_value_sparsity=float(rng.random()),
                         weight_bit_sparsity=0.6,
                         array_utilization=float(rng.random()),
                         cycles={"bp_exact": 1.5 + step,
                                 "adas": 2.0 * step},
                         mac_energy_pj={"bp_exact": 0.3 * step}))
    recs += [dict(kind="preempt", discarded_tokens=3),
             dict(kind="reject"), dict(kind="cancel"), dict(kind="timeout"),
             dict(kind="fault", injected=True), dict(kind="fault"),
             dict(kind="retry"), dict(kind="degrade"),
             dict(kind="recover"), dict(kind="unknown")]
    for rid, cls in enumerate(("interactive", "batch", "interactive")):
        recs.append(dict(kind="request", slo_class=cls,
                         queue_wait_s=0.1 * rid or None,
                         ttft_wall_s=0.2 * rid, itl_wall_s=[0.01, 0.02]))
    return recs


def test_fold_equals_the_references_on_every_record_kind():
    recs = _synthetic_stream()
    got = dataclasses.asdict(ttel.reduce_stream(recs))
    want = dataclasses.asdict(jtel.reduce_stream(recs))
    assert got == want
    assert got["n_hw_samples"] == 6 and got["n_degrades"] == 1
    assert got["n_faults"] == 2 and got["n_injected_faults"] == 1
    for qs in ((50, 90, 99), (10, 50)):
        samples = [0.3, None, 0.1, 0.7, 0.2]
        assert ttel.percentiles(samples, qs) == jtel.percentiles(samples, qs)
    assert ttel.percentiles([None]) is None


@pytest.mark.parametrize("probed", [False, True], ids=["plain", "probed"])
def test_report_equals_the_fold_of_the_written_file(tmp_path, probed):
    path = tmp_path / "m.jsonl"
    probe = serving.SparsityProbe(probe_every=1, n_mc=500) if probed else None
    with serving.Telemetry(metrics_path=str(path)) as tel:
        loop, rep = _serve(tel, probe=probe)
    records = serving.read_jsonl(str(path))
    assert records == loop.stream
    for r in records:
        assert ttel.STEP_SCHEMA[r["kind"]] <= set(r), r["kind"]
        assert r["schema"] == ttel.SCHEMA_VERSION
    kinds = {r["kind"] for r in records}
    assert {"run", "prefill", "decode", "preempt", "degrade",
            "request"} <= kinds
    assert ("hw_estimate" in kinds) == probed
    s = serving.reduce_stream(records)
    assert dataclasses.asdict(s) == dataclasses.asdict(
        serving.reduce_stream(loop.stream))
    for field in ("prefill_s", "decode_s", "steps", "n_syncs",
                  "total_new_tokens", "slot_utilization", "max_divergence",
                  "n_preemptions", "prefix_hit_blocks", "peak_blocks_in_use",
                  "n_degrades", "committed_tokens_per_step"):
        assert getattr(rep, field) == getattr(s, field), field
    assert rep.n_preemptions > 0 and rep.n_degrades > 0
    assert rep.queue_wait == serving.percentiles(s.queue_wait_samples)
    assert (rep.hw_measured is not None) == probed


def test_second_serve_appends_to_the_same_file(tmp_path):
    path = tmp_path / "m.jsonl"
    with serving.Telemetry(metrics_path=str(path)) as tel:
        _, rep1 = _serve(tel, backend="slab")
        n1 = len(serving.read_jsonl(str(path)))
        _, rep2 = _serve(tel, backend="slab")
    records = serving.read_jsonl(str(path))
    assert len(records) == 2 * n1
    assert [r["kind"] for r in records].count("run") == 2
    assert rep1.total_new_tokens == rep2.total_new_tokens


def _check_nesting(spans):
    """Every span lies inside each span it overlaps (one host thread)."""
    spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    for i, a in enumerate(spans):
        for b in spans[i + 1:]:
            if b["ts"] >= a["ts"] + a["dur"]:
                break
            assert b["ts"] + b["dur"] <= a["ts"] + a["dur"] + 1e-3, (a, b)


def test_chrome_trace_parses_and_nests(tmp_path):
    path = tmp_path / "t.json"
    tel = serving.Telemetry(trace_path=str(path))
    _serve(tel, probe=serving.SparsityProbe(probe_every=1, n_mc=500))
    trace = json.loads(path.read_text())       # flushed when the serve ends
    events = trace["traceEvents"]
    assert trace["displayTimeUnit"] == "ms"
    assert events[0]["ph"] == "M"
    spans = [e for e in events if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert {"serve", "prefill", "install", "decode", "commit",
            "preempt"} <= names
    serve = next(e for e in spans if e["name"] == "serve")
    assert all(serve["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= serve["ts"] + serve["dur"] + 1e-3 for e in spans)
    _check_nesting(spans)
    counters = [e for e in events if e["ph"] == "C"]
    assert {e["name"] for e in counters} == {"sparsity", "hw_model"}
    tel.close()


def test_tracer_span_records_args_and_nests():
    tr = ttel.Tracer()
    with tr.span("outer", n=np.int64(3)):
        with tr.span("inner", x=np.float32(0.5)):
            tr.instant("tick", k=1)
        tr.counter("c", v=np.int32(2))
    spans = [e for e in tr.events if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["inner", "outer"]
    assert spans[1]["args"] == {"n": 3} and type(spans[1]["args"]["n"]) is int
    _check_nesting(spans)
    json.dumps(tr.events)                       # plain values only


def test_disabled_handle_is_a_no_op(tmp_path):
    tel = serving.Telemetry()
    assert not tel.enabled
    assert tel.span("x") is ttel.NULL_SPAN
    tel.emit({"kind": "run"})
    tel.instant("x")
    tel.counter("x", a=1)
    tel.start_profile()
    tel.stop_profile()
    tel.close()
    tel.count("h2d_bytes", 7)
    assert tel.counters["h2d_bytes"] == 7
    assert list(tmp_path.iterdir()) == []


def test_metrics_logger_flushes_each_line_and_closes(tmp_path):
    path = tmp_path / "sub" / "m.jsonl"
    with ttel.MetricsLogger(str(path)) as log:
        log.log({"kind": "run", "x": 1.5})
        assert serving.read_jsonl(str(path)) == [{"kind": "run", "x": 1.5}]
        with pytest.raises(TypeError):
            log.log({"kind": "run", "x": np.float32(1.5)})  # not plain
    assert log._f.closed


def test_profile_dir_writes_a_torch_profiler_trace(tmp_path):
    tel = serving.Telemetry(profile_dir=str(tmp_path / "prof"),
                            annotate_device=True)
    assert tel.enabled and tel.tracer is not None
    _serve(tel, backend="slab")
    assert len(tel.profile_paths) == 1
    trace = json.loads(open(tel.profile_paths[0]).read())
    names = {e.get("name") for e in trace["traceEvents"]}
    # the host spans, annotated into the profiler's timeline
    assert {"serve", "prefill", "decode"} <= names


def test_a_failing_sink_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    tel = serving.Telemetry(profile_dir=str(blocker / "prof"))
    with pytest.raises(OSError):
        _serve(tel, backend="slab")
    assert tel._profiler is None               # stopped, not left running
    with pytest.raises(OSError):
        serving.Telemetry(metrics_path=str(blocker / "m.jsonl"))
    tel = serving.Telemetry(trace_path=str(blocker / "t.json"))
    with pytest.raises(OSError):
        _serve(tel, backend="slab")
