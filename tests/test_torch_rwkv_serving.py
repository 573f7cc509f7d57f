"""Serving the RWKV-6 family in the PyTorch port against the JAX engine.

Both engines get the same weights (the reference's ``api.init`` with
``PRNGKey(0)`` on ``test_serving.py``'s rwkv reduction, handed to the port
through ``repro_torch.convert.params_from_numpy``; in bp_exact and
bp_approx each engine quantizes them to int8 itself) and the same
requests, made with numpy.  Greedy ``serve()`` token streams and finish
reasons must equal the reference's on two workloads: ``test_serving.py``'s
recurrent workload (three 6-token prompts, staggered, on two slots: the
step recurrence) and one whose prompts are 64 and 128 tokens long (the chunked WKV form; the
port runs the WKV6 kernel's plain version on the CPU).  The recurrent
family prefills exact-length groups only (no right padding), as the
reference's engine does.

The reference engine runs jitted in a subprocess started with
``XLA_FLAGS=--xla_allow_excess_precision=false``, so that every bf16
operation rounds to bf16 as the program says and as PyTorch's eager
operations do (see ``test_torch_serving.py``).  A stream that parts from
the reference is reported with its first differing position and the top-2
margin of the port's logits there, so a flip at a near-tie shows as one and
is never hidden.
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
from repro_torch.models import api

HERE = pathlib.Path(__file__).resolve().parent
SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128)
MODES = ("bf16", "bp_exact", "bp_approx")


@dataclasses.dataclass(frozen=True)
class Workload:
    prompt_lens: tuple
    max_new: tuple
    arrivals: tuple
    n_slots: int


WORKLOADS = {
    # tests/test_serving.py::TestRecurrentFamilies
    "staggered-step": Workload((6, 6, 6), (5, 2, 4), (0.0, 1.0, 2.0), 2),
    # every prefill takes the chunked form (64 = 1 chunk, 128 = 2)
    "chunked": Workload((64, 128, 64), (4, 3, 5), (0.0, 0.0, 1.0), 2),
}


def _prompts(wl: Workload, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, SMALL["vocab_size"], n).astype(np.int32)
            for n in wl.prompt_lens]


def _serve(pkg, engine, wl: Workload, prompts):
    reqs = [pkg.Request(prompt=prompts[i].copy(),
                        max_new_tokens=wl.max_new[i],
                        arrival_time=wl.arrivals[i], request_id=i)
            for i in range(len(prompts))]
    return engine.serve(reqs, n_slots=wl.n_slots)


def _summary(report):
    return {"tokens": {str(r.request_id): np.asarray(r.tokens).tolist()
                       for r in report.results},
            "finish": {str(r.request_id): r.finish_reason
                       for r in report.results},
            "steps": report.steps, "n_syncs": report.n_syncs}


def write_reference(path: str) -> None:
    """Run every (mode, workload) through the JAX engine; write the
    summaries and the weights.  Runs in the subprocess that the
    ``reference`` fixture starts."""
    import jax
    from repro import serving as jserving
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import api as japi

    base = jax_get_arch("rwkv6-7b").reduced().replace(**SMALL)
    params = japi.init(jax.random.PRNGKey(0), base)
    out = {}
    for mode in MODES:
        eng = jserving.ServingEngine(
            base.replace(matmul_mode=mode), params,
            jserving.ServeConfig(max_new_tokens=5, temperature=0.0))
        for name, wl in WORKLOADS.items():
            out[f"{mode}/{name}"] = _summary(
                _serve(jserving, eng, wl, _prompts(wl)))
    out["params"] = {
        "/".join(str(k.key) for k in p): {
            "dtype": str(leaf.dtype),
            "value": np.asarray(leaf, np.float32).tolist()}
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    pathlib.Path(path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_rwkv_reference") / "reference.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), str(HERE),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_rwkv_serving as t; "
         f"t.write_reference({str(out)!r})"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _port_params(reference):
    """The reference's weights (float32 on the wire, each leaf cast back to
    its own dtype) as the port's parameter tree."""
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


def _cfg(mode="bf16"):
    return get_arch("rwkv6-7b").reduced().replace(**SMALL, matmul_mode=mode)


@pytest.fixture(scope="module")
def engines(reference):
    params = _port_params(reference)
    return {mode: tserving.ServingEngine(
        _cfg(mode), params,
        tserving.ServeConfig(max_new_tokens=5, temperature=0.0),
        device="cpu") for mode in MODES}


def _flip_report(engine, prompts, got, want):
    """One line per differing stream: where it parts, both tokens, and the
    top-2 margin of the port's logits at that point."""
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


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_greedy_serve_matches_reference(reference, engines, mode, workload):
    wl = WORKLOADS[workload]
    prompts = _prompts(wl)
    want = reference[f"{mode}/{workload}"]
    rep = _serve(tserving, engines[mode], wl, prompts)
    got = _summary(rep)
    assert got["tokens"] == want["tokens"], (
        "token streams differ:\n"
        + _flip_report(engines[mode], prompts, got["tokens"],
                       want["tokens"]))
    assert got["finish"] == want["finish"]
    assert got["steps"] == want["steps"]
    assert got["n_syncs"] == want["n_syncs"]


def test_bridge_carries_the_reference_weights(reference, engines):
    u = np.asarray(reference["params"]["layers/tm/bonus_u"]["value"],
                   np.float32)
    got = engines["bf16"].params["layers"]["tm"]["bonus_u"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), u)


@pytest.mark.parametrize("mode", MODES)
def test_serve_matches_generate(engines, mode):
    """Continuous batching equals one static ``generate()`` per request (an
    exact-length group of one): no right padding reaches the state."""
    eng = engines[mode]
    wl = Workload((64, 6, 100, 64), (4, 5, 3, 4), (0.0, 0.0, 1.0, 2.0), 2)
    prompts = _prompts(wl, seed=4)
    served = _summary(_serve(tserving, eng, wl, prompts))["tokens"]
    for i, p in enumerate(prompts):
        g = eng.generate({"tokens": p[None]}, max_new_tokens=wl.max_new[i])
        assert served[str(i)] == g.tokens[0].tolist(), i


def test_recurrent_family_prefills_exact_length_groups(engines):
    eng = engines["bf16"]
    wl = Workload((6, 9, 6), (3, 3, 3), (0.0, 0.0, 0.0), 3)
    loop = eng.make_loop(
        [tserving.Request(prompt=p, max_new_tokens=3, request_id=i)
         for i, p in enumerate(_prompts(wl, seed=5))], n_slots=3)
    assert loop.sched.bucketing == "exact" and not loop.ragged
    loop.run()
    pads = sorted(r["pad_to"] for r in loop.stream if r["kind"] == "prefill")
    assert pads == [6, 9]                     # two groups, no padding


def test_paged_backend_and_verify_paths_raise(engines):
    cfg = _cfg()
    params = engines["bf16"].params
    with pytest.raises(ValueError, match="slab"):
        tserving.make_cache_manager(
            cfg, 2, 16, backend="paged",
            executor=tserving.SingleDeviceExecutor(cfg, device="cpu"))
    eng = tserving.ServingEngine(
        cfg, params, tserving.ServeConfig(cache_backend="paged"),
        device="cpu")
    with pytest.raises(ValueError, match="slab"):
        eng.serve([tserving.Request(prompt=np.arange(2, 8, dtype=np.int32),
                                    max_new_tokens=2)], n_slots=1)
    for kw in (dict(draft="prompt_lookup"), dict(prefill_chunk=4)):
        with pytest.raises(ValueError, match="no multi-token verify path"):
            tserving.ServingEngine(cfg, params, tserving.ServeConfig(**kw),
                                   device="cpu")
    assert not api.supports_verify(cfg)
