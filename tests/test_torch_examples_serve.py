"""``examples_torch/serve_lm.py`` against the JAX engine, and
``examples_torch/estimate_deployment.py --measured`` against the JAX
example's.

  * Greedy streams through the example's own functions (``parse_args``,
    ``build_engine``, ``make_workload``, ``run``) at a small width, with
    the reference's ``api.init`` weights converted by ``params_from_numpy``,
    equal the reference ``ServingEngine``'s on the same numpy workload, in
    bf16, bp_exact with an int8 KV cache, bp_approx with an int8 KV cache
    (slab) and bp_exact on the paged store; so do the report's counters.
    The reference runs jitted in a subprocess with
    ``--xla_allow_excess_precision=false`` (``test_torch_serving.py`` says
    why); a parting stream is reported with its top-2 margin.
  * Temperature 0.8 twice with the same seeds gives identical streams, every
    token in the padded vocabulary the logits span (the reference samples
    over it too: its serving logits do not mask the padding).
  * ``--probe 2 --metrics`` writes ``hw_estimate`` records, and both
    packages' ``measured_report`` print the same text from that file;
    ``main`` runs on the CPU with ``--device cpu``.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import numpy as np
import pytest

import torch_parity
from repro_torch.configs.base import get_arch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples_torch"))
import estimate_deployment  # noqa: E402
import serve_lm  # noqa: E402

# (mode, cache backend); the bp_* modes use an int8 KV cache
CASES = (("bf16", "slab"), ("bp_exact", "slab"), ("bp_approx", "slab"),
         ("bp_exact", "paged"))
WORKLOAD_ARGS = ["--requests", "6", "--tokens", "12", "--temperature", "0",
                 "--device", "cpu"]
REPORT_FIELDS = ("steps", "n_syncs", "total_new_tokens", "peak_active_slots",
                 "max_divergence")


def _cfg():
    return get_arch("qwen2-1.5b").reduced().replace(**torch_parity.SMALL)


def _args(mode, backend, extra=()):
    return serve_lm.parse_args(WORKLOAD_ARGS + ["--mode", mode,
                                                "--cache-backend", backend,
                                                *extra])


def write_reference(out_dir) -> None:
    """The reference engine on the example's workload in every case (runs
    in the subprocess ``run_reference`` starts)."""
    import jax
    from repro import serving as jserving
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import api as japi
    from repro.models.layers import quantize_dense_params

    base = jax_get_arch("qwen2-1.5b").reduced().replace(**torch_parity.SMALL)
    params = japi.init(jax.random.PRNGKey(0), base)
    qparams = quantize_dense_params(params)
    out = {}
    for mode, backend in CASES:
        args = _args(mode, backend)
        wl = serve_lm.make_workload(_cfg(), args)
        cfg = base.replace(matmul_mode=mode, kv_cache_int8=mode != "bf16")
        eng = jserving.ServingEngine(
            cfg, params if mode == "bf16" else qparams,
            jserving.ServeConfig(max_new_tokens=args.tokens, temperature=0.0,
                                 cache_backend=backend,
                                 block_size=args.block_size))
        reqs = [jserving.Request(prompt=r.prompt, max_new_tokens=
                                 r.max_new_tokens,
                                 arrival_time=r.arrival_time,
                                 request_id=r.request_id)
                for r in wl.requests()]
        rep = eng.serve(reqs, n_slots=args.slots, cache_T=wl.cache_T,
                        sched_cfg=jserving.SchedulerConfig(
                            lead_window=args.lead_window))
        out[f"{mode}/{backend}"] = torch_parity.summary(rep, REPORT_FIELDS)
    torch_parity.save_reference(out_dir, out, params)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return torch_parity.run_reference(
        "test_torch_examples_serve", tmp_path_factory.mktemp("serve_lm_ref"))


@pytest.mark.parametrize("mode,backend", CASES,
                         ids=[f"{m}-{b}" for m, b in CASES])
def test_greedy_streams_equal_reference(reference, mode, backend):
    args = _args(mode, backend)
    cfg = _cfg()
    engine = serve_lm.build_engine(cfg, reference["params"], args)
    assert engine.cfg.kv_cache_int8 == (mode != "bf16")
    wl = serve_lm.make_workload(cfg, args)
    report, _ = serve_lm.run(engine, wl, args)
    got = torch_parity.summary(report, REPORT_FIELDS)
    want = reference[f"{mode}/{backend}"]
    assert got["tokens"] == want["tokens"], torch_parity.flip_report(
        engine, wl.prompts, got["tokens"], want["tokens"])
    assert got["finish"] == want["finish"]
    assert got["report"] == want["report"]
    assert report.cache_backend == backend


def test_sampling_is_seeded():
    args = _args("bp_exact", "slab", ["--temperature", "0.8"])
    assert args.temperature == 0.8
    cfg = _cfg()
    engine = serve_lm.build_engine(cfg, serve_lm.init_params(cfg, "cpu"),
                                   args)
    wl = serve_lm.make_workload(cfg, args)
    runs = [serve_lm.run(engine, wl, args, warmup=i == 0)[0]
            for i in range(2)]
    streams = [{r.request_id: np.asarray(r.tokens).tolist()
                for r in rep.results} for rep in runs]
    assert streams[0] == streams[1]
    toks = [t for ts in streams[0].values() for t in ts]
    assert len(toks) == runs[0].total_new_tokens > 0
    assert all(0 <= t < cfg.vocab_padded for t in toks)


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def test_probed_serve_feeds_measured_report(tmp_path):
    path = str(tmp_path / "run.jsonl")
    args = _args("bp_exact", "slab", ["--probe", "2", "--metrics", path])
    cfg = _cfg()
    engine = serve_lm.build_engine(cfg, serve_lm.init_params(cfg, "cpu"),
                                   args)
    report, _ = serve_lm.run(engine, serve_lm.make_workload(cfg, args), args)
    assert report.hw_measured is not None and report.deployment is not None
    recs = [json.loads(line) for line in open(path)]
    assert sum(r["kind"] == "hw_estimate" for r in recs) == \
        report.hw_measured["n_samples"] > 0
    spec = importlib.util.spec_from_file_location(
        "reference_estimate_deployment",
        ROOT / "examples" / "estimate_deployment.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    rc_port, port_text = _printed(estimate_deployment.measured_report, path)
    rc_ref, ref_text = _printed(ref.measured_report, path)
    assert rc_port == rc_ref == 0
    assert port_text == ref_text
    assert estimate_deployment.main(["--measured", path]) == 0


def test_main_runs_on_cpu(capsys):
    report = serve_lm.main(["--device", "cpu", "--requests", "2",
                            "--tokens", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "mode=bp_exact, device=cpu" in out
    assert "BitParticle deployment estimate" in out
    assert [r.finish_reason for r in report.results] == ["length"] * 2
