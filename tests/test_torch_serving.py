"""Serving in the PyTorch port against the JAX engine.

Both engines get the same weights (the reference's ``api.init`` with
``PRNGKey(0)``, handed to the port through
``repro_torch.convert.params_from_numpy``; each engine quantizes them to
int8 itself in the bp_* modes) and the same requests, made with numpy.
Greedy ``serve()`` token streams must be identical to the reference's, and
so must the report's counters, on the workloads of ``test_serving.py``:
simultaneous arrivals, staggered arrivals with heterogeneous lengths under
lead window 2, and a burst larger than the slot pool.

The reference engine runs jitted in a subprocess started with
``XLA_FLAGS=--xla_allow_excess_precision=false``, so that every bf16
operation rounds to bf16 as the program says and as PyTorch's eager
operations do.  With XLA's default, a fusion keeps some bf16 intermediates
in float32, which moves a logit by one bf16 unit in the last place, and the
random-init model's logits are flat enough that such a unit flips argmax
ties (seen with these weights: a top-2 margin of 0.015625, one unit at the
logits' magnitude).  A stream that parts from the reference is reported
with its first differing position and the top-2 margin of the port's logits
there, so a flip at a near-tie shows as one and is never hidden.

Sampling with temperature cannot reproduce ``jax.random``'s streams; it is
held to fixed-seed determinism within the port.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import serving as tserving
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy

HERE = pathlib.Path(__file__).resolve().parent
SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128, head_dim=16)
MODES = {"bf16": False, "bp_exact": True, "bp_approx": True}  # -> int8 KV


@dataclasses.dataclass(frozen=True)
class Workload:
    prompt_len: int
    max_new: tuple
    arrivals: tuple
    n_slots: int
    lead_window: int = 4
    max_waiting: int = 1 << 30
    cache_T: int = None


WORKLOADS = {
    "simultaneous": Workload(6, (8,) * 4, (0.0,) * 4, n_slots=4),
    "staggered-hetero-E2": Workload(6, (8, 3, 8, 5, 1),
                                    (0.0, 1.0, 2.0, 3.0, 4.0), n_slots=2,
                                    lead_window=2),
    "burst-over-slots": Workload(5, (4,) * 7, (0.0,) * 7, n_slots=2),
    # one slot, two waiting places, and a last request too long for the
    # cache: admission control and up-front rejection
    "admission-control": Workload(5, (4,) * 6 + (12,), (0.0,) * 7,
                                  n_slots=1, lead_window=0, max_waiting=2,
                                  cache_T=9),
}
REPORT_FIELDS = ("steps", "n_syncs", "total_new_tokens", "n_rejected",
                 "peak_active_slots", "max_divergence", "slot_utilization")


def _prompts(wl: Workload, seed=1):
    return np.random.default_rng(seed).integers(
        2, SMALL["vocab_size"], (len(wl.max_new), wl.prompt_len)).astype(
            np.int32)


def _serve(pkg, engine, wl: Workload, prompts):
    reqs = [pkg.Request(prompt=prompts[i].copy(),
                        max_new_tokens=wl.max_new[i],
                        arrival_time=wl.arrivals[i], request_id=i)
            for i in range(len(wl.max_new))]
    return engine.serve(reqs, n_slots=wl.n_slots, cache_T=wl.cache_T,
                        sched_cfg=pkg.SchedulerConfig(
                            lead_window=wl.lead_window,
                            max_waiting=wl.max_waiting))


def _summary(report):
    """What both engines must agree on: per-request tokens and finish
    reasons, and the report's counters."""
    return {"tokens": {str(r.request_id): np.asarray(r.tokens).tolist()
                       for r in report.results},
            "finish": {str(r.request_id): r.finish_reason
                       for r in report.results},
            "report": {f: getattr(report, f) for f in REPORT_FIELDS}}


def write_reference(path: str) -> None:
    """Run every (mode, workload) through the JAX engine; write the
    summaries as JSON.  Runs in the subprocess that the ``reference``
    fixture starts."""
    import jax
    from repro import serving as jserving
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import api as japi

    base = jax_get_arch("qwen2-1.5b").reduced().replace(**SMALL)
    params = japi.init(jax.random.PRNGKey(0), base)
    out = {}
    for mode, int8kv in MODES.items():
        eng = jserving.ServingEngine(
            base.replace(matmul_mode=mode, kv_cache_int8=int8kv), params,
            jserving.ServeConfig(max_new_tokens=8, temperature=0.0))
        for name, wl in WORKLOADS.items():
            out[f"{mode}/{name}"] = _summary(
                _serve(jserving, eng, wl, _prompts(wl)))
    out["params"] = {
        "/".join(str(k.key) for k in path): {
            "dtype": str(leaf.dtype),
            "value": np.asarray(leaf, np.float32).tolist()}
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    pathlib.Path(path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_reference") / "reference.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), str(HERE),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_serving as t; t.write_reference({str(out)!r})"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _port_params(reference):
    """The reference's weights (float32 on the wire, each leaf with its own
    dtype's values) as the port's parameter tree."""
    tree, dtypes = {}, {}
    for path, leaf in reference["params"].items():
        *parents, name = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = np.asarray(leaf["value"], np.float32)
        dtypes[path] = getattr(torch, leaf["dtype"])

    def cast(node, path=""):
        if isinstance(node, dict):
            return {k: cast(v, f"{path}/{k}".lstrip("/"))
                    for k, v in node.items()}
        return node.to(dtypes[path])

    return cast(params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module")
def engines(reference):
    params = _port_params(reference)
    base = get_arch("qwen2-1.5b").reduced().replace(**SMALL)
    return {mode: tserving.ServingEngine(
        base.replace(matmul_mode=mode, kv_cache_int8=int8kv), params,
        tserving.ServeConfig(max_new_tokens=8, temperature=0.0),
        device="cpu") for mode, int8kv in MODES.items()}


def _flip_report(engine, prompts, got, want):
    """One line per differing stream: where it parts, both tokens, and the
    top-2 margin of the port's logits at that point (prompt plus the shared
    prefix, one fresh prefill)."""
    lines = []
    for rid in sorted(want, key=int):
        g, w = got.get(rid, []), want[rid]
        if g == w:
            continue
        j = next((k for k in range(min(len(g), len(w))) if g[k] != w[k]),
                 min(len(g), len(w)))
        seq = np.concatenate([prompts[int(rid)], np.asarray(w[:j], np.int32)])
        logits, _ = engine.executor.prefill({"tokens": seq[None]},
                                            len(seq) + 1)
        top = torch.topk(logits[0].float(), 2)
        lines.append(
            f"request {rid}: first differs at token {j} (port {g[j:j + 1]}, "
            f"reference {w[j:j + 1]}); port top-2 {top.indices.tolist()} "
            f"margin {float(top.values[0] - top.values[1]):.6g}")
    return "\n".join(lines)


@pytest.mark.parametrize("mode", list(MODES),
                         ids=["bf16", "bp_exact-int8kv", "bp_approx-int8kv"])
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_greedy_serve_matches_reference(reference, engines, mode, workload):
    wl = WORKLOADS[workload]
    prompts = _prompts(wl)
    want = reference[f"{mode}/{workload}"]
    got_rep = _serve(tserving, engines[mode], wl, prompts)
    got = _summary(got_rep)
    assert got["tokens"] == want["tokens"], (
        "token streams differ:\n"
        + _flip_report(engines[mode], prompts, got["tokens"],
                       want["tokens"]))
    assert got["finish"] == want["finish"]
    for field in REPORT_FIELDS:
        assert got["report"][field] == pytest.approx(
            want["report"][field]), field
    assert got_rep.deployment is None      # cost models not ported yet


def test_bridge_carries_the_reference_weights(reference, engines):
    # the serving engines above run on exactly the reference's weights
    emb = np.asarray(reference["params"]["embed/table"]["value"],
                     np.float32)
    got = engines["bf16"].params["embed"]["table"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), emb)


def test_generate_matches_serve(engines):
    eng = engines["bp_exact"]
    wl = Workload(6, (8, 5, 8), (0.0, 0.0, 1.0), n_slots=2)
    prompts = _prompts(wl, seed=4)
    static = eng.generate({"tokens": prompts}, max_new_tokens=8)
    assert static.tokens.shape == (3, 8) and static.steps == 8
    served = _summary(_serve(tserving, eng, wl, prompts))["tokens"]
    for i in range(3):
        assert served[str(i)] == static.tokens[i, :wl.max_new[i]].tolist()


def test_eos_finishes_at_prefill_without_decode(engines):
    base = engines["bp_exact"]
    prompts = _prompts(Workload(4, (8, 8), (0.0, 0.0), 2), seed=8)
    first = base.generate({"tokens": prompts}, max_new_tokens=1).tokens[:, 0]
    eng = tserving.ServingEngine(
        base.cfg, base.params,
        tserving.ServeConfig(max_new_tokens=8, eos_id=int(first[0])),
        device="cpu")
    rep = eng.serve([tserving.Request(prompt=prompts[0], max_new_tokens=8)],
                    n_slots=2)
    assert rep.results[0].finish_reason == "eos"
    assert rep.results[0].tokens.tolist() == [int(first[0])]
    assert rep.steps == 0 and rep.total_new_tokens == 1


def test_temperature_sampling_is_seeded_within_the_port(engines):
    base = engines["bp_exact"]
    eng = tserving.ServingEngine(
        base.cfg, base.params,
        tserving.ServeConfig(max_new_tokens=6, temperature=1.5),
        device="cpu")
    wl = Workload(6, (6,) * 3, (0.0, 0.0, 1.0), n_slots=2)
    prompts = _prompts(wl, seed=9)
    a = _summary(_serve(tserving, eng, wl, prompts))["tokens"]
    b = _summary(_serve(tserving, eng, wl, prompts))["tokens"]
    greedy = _summary(_serve(tserving, base, wl, prompts))["tokens"]
    assert a == b
    assert a != greedy
    assert all(len(t) == 6 for t in a.values())


def test_cancel_frees_the_slot(engines):
    eng = engines["bf16"]
    wl = Workload(5, (8,) * 3, (0.0, 0.0, 0.0), n_slots=2)
    prompts = _prompts(wl, seed=10)
    loop = eng.make_loop(
        [tserving.Request(prompt=prompts[i], max_new_tokens=8, request_id=i)
         for i in range(3)], n_slots=2)

    def cancel_after_first_step(lp):
        if lp.sched.n_decode_steps == 1:
            eng.cancel(0)

    loop.on_step_end = cancel_after_first_step
    rep = loop.run()
    by_id = {r.request_id: r for r in rep.results}
    assert by_id[0].finish_reason == "cancelled"
    assert 0 < len(by_id[0].tokens) < 8
    assert by_id[1].finish_reason == by_id[2].finish_reason == "length"
    assert rep.n_cancelled == 1
    assert loop.cm.n_active == 0
