"""The hardware-cost probe of the PyTorch port against the JAX package's.

  * The probed model entry points (``api.prefill_probed``,
    ``decode_step_probed``, ``verify_step_probed`` and their paged forms)
    return the stats the reference's tap collects when the same entry point
    is jitted under ``probe_tap()`` on the same int8 weights and tokens:
    equal rows, per layer plus no trailing row (qwen2 ties its lm head),
    logits equal to the unprobed entry point's.
  * Probed greedy serves on the slab and paged stores, without and with the
    prompt-lookup drafter, on the workloads of ``test_probe.py`` (3
    repeated-phrase prompts, bp_exact, int8 KV, probe_every=1), against the
    reference engine run in a subprocess (``torch_parity.run_reference``):
      - token streams equal the reference's and the port's own unprobed
        streams;
      - one ``hw_estimate`` record per prefill and per step, at the
        reference's steps and phases; their activation and weight rates
        and per-layer lists within 1e-6 of the reference's, the energies
        within 1e-9 relative of the reference's energy model at those
        rates, the modeled cycles within 4 standard errors
        of the Monte-Carlo tables (from the tables' own sample variances,
        both sides), and the array simulation's utilization and cycles per
        step within twice the reference's own spread between probe seeds 0
        and 1;
      - the probe's device-to-host bytes per step record equal the
        reference's;
      - every record validates against the reference's ``STEP_SCHEMA``,
        and the report equals the fold of the written JSONL file.
  * ``ServeReport.deployment`` and the weight profile against the
    reference's (cycles within 4 standard errors), the cost hint, probe
    subsampling, and the refusal of unsupported configurations.
"""

import json

import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.core import cost_model as jcm
from repro.core import probe as jprobe
from repro.serving.telemetry import STEP_SCHEMA
from repro_torch import serving as tserving
from repro_torch.configs.base import get_arch
from repro_torch.core import cost_model as tcm
from repro_torch.models import api
from repro_torch.serving import probe as tprobe

N_MC = 2000
MAX_NEW = 6
CASES = [f"{b}-{d}" for b in ("slab", "paged")
         for d in ("none", "prompt_lookup")]
STEP_KINDS = ("prefill", "decode", "verify")


def _cfg(get):
    return get("qwen2-1.5b").reduced().replace(
        matmul_mode="bp_exact", kv_cache_int8=True, **tp.SMALL)


def _prompts():
    """Repeated-phrase prompts (the prompt-lookup drafter needs
    material)."""
    rng = np.random.default_rng(11)
    phrase = rng.integers(2, tp.SMALL["vocab_size"], 4)
    return [np.concatenate([phrase, phrase,
                            rng.integers(2, tp.SMALL["vocab_size"], 2 + i),
                            phrase]).astype(np.int32) for i in range(3)]


def _engine(pkg, params, cfg, case, probe=None, telemetry=None, **kw):
    backend, draft = case.split("-", 1)
    return pkg.ServingEngine(cfg, params, pkg.ServeConfig(
        max_new_tokens=MAX_NEW, temperature=0.0, cache_backend=backend,
        block_size=4, draft=draft, num_draft_tokens=3, probe=probe,
        telemetry=telemetry), **kw)


def _run(pkg, eng):
    reqs = [pkg.Request(prompt=p.copy(), max_new_tokens=MAX_NEW,
                        arrival_time=0.0, request_id=i)
            for i, p in enumerate(_prompts())]
    loop = eng.make_loop(reqs, n_slots=3, cache_T=32, num_blocks=40,
                         sched_cfg=pkg.SchedulerConfig(lead_window=2))
    return loop, loop.run()


def _tokens(rep):
    return {str(r.request_id): np.asarray(r.tokens).tolist()
            for r in rep.results}


def write_reference(out_dir: str) -> None:
    """Run every probed serve through the JAX engine, with probe seeds 0
    and 1 (called in the subprocess)."""
    import jax
    from repro import serving as jserving
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import api as japi

    from repro.models.layers import quantize_dense_params as jquant

    cfg = _cfg(jax_get_arch)
    params = japi.init(jax.random.PRNGKey(0), cfg)
    out = {"cases": {}, "entry": _reference_entry_stats(jquant(params), cfg)}
    for case in CASES:
        for seed in (0, 1):
            eng = _engine(jserving, params, cfg, case,
                          probe=jserving.SparsityProbe(
                              probe_every=1, n_mc=N_MC, seed=seed))
            loop, rep = _run(jserving, eng)
            out["cases"][f"{case}/{seed}"] = {
                "tokens": _tokens(rep),
                "hw": [r for r in loop.stream if r["kind"] == "hw_estimate"],
                "d2h": [[r["kind"], r["d2h_bytes"]] for r in loop.stream
                        if r["kind"] in STEP_KINDS],
                "hw_measured": rep.hw_measured,
                "deployment": rep.deployment,
                "weight_profile": eng.weight_sparsity_profile(),
            }
    tp.save_reference(out_dir, out, params)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference("test_torch_probe",
                            tmp_path_factory.mktemp("jax_probe_reference"))


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    """Per case: the port's unprobed and probed (seed 0, with metrics and
    trace sinks) serves."""
    cfg = _cfg(get_arch)
    out = {}
    for case in CASES:
        d = tmp_path_factory.mktemp(f"probe_{case}")
        off = _run(tserving, _engine(tserving, reference["params"], cfg,
                                     case, device="cpu"))
        with tserving.Telemetry(metrics_path=str(d / "m.jsonl"),
                                trace_path=str(d / "t.json")) as tel:
            eng = _engine(tserving, reference["params"], cfg, case,
                          probe=tserving.SparsityProbe(
                              probe_every=1, n_mc=N_MC, seed=0),
                          telemetry=tel, device="cpu")
            loop, rep = _run(tserving, eng)
        out[case] = {"off": off[1], "loop": loop, "rep": rep, "engine": eng,
                     "file": tserving.read_jsonl(str(d / "m.jsonl")),
                     "trace": json.loads((d / "t.json").read_text())}
    return out


# ---------------------------------------------------------------------------
# the probed entry points against the reference's compiled tap
# ---------------------------------------------------------------------------

ENTRIES = ["prefill", "prefill_ragged", "decode", "verify", "decode_paged",
           "verify_paged"]
ENTRY_LENS = np.asarray([12, 5], np.int32)


def _entry_inputs(entry):
    """(prompt tokens (2, 12) with a ragged row, fed tokens, block tables
    or None) of one entry-point case."""
    tokens = tp.tokens(3, (2, 12))
    tokens[1, 5:] = 0
    feed = tp.tokens(4, (2, 3 if entry.startswith("verify") else 1))
    # 2 slots x 4 pages of 4 positions: the prefill cache laid out in pages
    # 1..8 (page 0 is the trash page)
    tables = (np.arange(1, 9, dtype=np.int32).reshape(2, 4)
              if entry.endswith("paged") else None)
    return tokens, feed, tables


def _to_pages(cache, xp):
    """A (L, 2, 16, ...) slab prefill cache as (L, 9, 4, ...) pages."""
    return {k: xp.concatenate([xp.zeros_like(v[:, :1, :4]),
                               v.reshape(v.shape[0], 8, 4, *v.shape[3:])],
                              axis=1) for k, v in cache.items()}


def _entry_name(entry):
    return (("decode_step" if entry.startswith("decode") else "verify_step")
            + ("_paged" if entry.endswith("paged") else ""))


def _reference_entry_stats(jparams, jcfg):
    """Each entry point jitted under the reference's tap (called in the
    subprocess): the stats its compiled program collects."""
    import jax
    import jax.numpy as jnp
    from repro.models import api as japi

    out = {}
    for entry in ENTRIES:
        tokens, feed, tables = _entry_inputs(entry)
        if entry.startswith("prefill"):
            lens = ENTRY_LENS if entry == "prefill_ragged" else None

            def run(p, b):
                return japi.prefill(p, jcfg, b, 16, prompt_lens=lens)
            args = (jparams, {"tokens": jnp.asarray(tokens)})
        else:
            _, cache = jax.jit(lambda p, b: japi.prefill(p, jcfg, b, 16))(
                jparams, {"tokens": jnp.asarray(tokens)})
            batch = {"tokens": jnp.asarray(feed),
                     "cache_len": jnp.asarray(ENTRY_LENS)}
            if tables is not None:
                cache = _to_pages(cache, jnp)
                batch["block_tables"] = jnp.asarray(tables)
            batch["cache"] = cache
            fn = getattr(japi, _entry_name(entry))

            def run(p, b, fn=fn):
                return fn(p, jcfg, b)
            args = (jparams, batch)

        def tapped(*a, run=run):
            with jprobe.probe_tap():
                run(*a)
                return jprobe.collect()
        out[entry] = np.asarray(jax.jit(tapped)(*args)).tolist()
    return out


@pytest.mark.parametrize("entry", ENTRIES)
def test_probed_entry_points_match_reference_tap(reference, entry):
    cfg = _cfg(get_arch)
    from repro_torch.models.layers import quantize_dense_params
    params = quantize_dense_params(reference["params"])
    tokens, feed, tables = _entry_inputs(entry)
    tok = torch.as_tensor(tokens).long()
    if entry.startswith("prefill"):
        kw = ({"prompt_lens": torch.as_tensor(ENTRY_LENS).long()}
              if entry == "prefill_ragged" else {})
        got = api.prefill_probed(params, cfg, {"tokens": tok}, 16, **kw)
        plain = api.prefill(params, cfg, {"tokens": tok}, 16, **kw)
    else:
        _, cache = api.prefill(params, cfg, {"tokens": tok}, 16)
        batch = {"tokens": torch.as_tensor(feed).long(),
                 "cache_len": torch.as_tensor(ENTRY_LENS).long()}
        if tables is not None:
            cache = _to_pages(cache, torch)
            batch["block_tables"] = torch.as_tensor(tables)
        name = _entry_name(entry)
        got = getattr(api, name + "_probed")(params, cfg, dict(
            batch, cache={k: v.clone() for k, v in cache.items()}))
        plain = getattr(api, name)(params, cfg, dict(
            batch, cache={k: v.clone() for k, v in cache.items()}))
    stats = got[2]
    assert stats.dtype == torch.float32
    assert stats.shape == (cfg.num_layers, 3)       # tied head: no tail row
    np.testing.assert_array_equal(stats.numpy(),
                                  np.asarray(reference["entry"][entry],
                                             np.float32))
    assert torch.equal(got[0], plain[0])            # the probe reads only


def test_collector_adds_a_tail_row_only_for_an_untied_head():
    cfg = get_arch("qwen2-1.5b").reduced().replace(
        matmul_mode="bp_exact", tie_embeddings=False, **tp.SMALL)
    from repro_torch.models.layers import quantize_dense_params
    params = quantize_dense_params(api.init(cfg, device="cpu"))
    tokens = torch.as_tensor(tp.tokens(5, (2, 8))).long()
    _, _, stats = api.prefill_probed(params, cfg, {"tokens": tokens}, 8)
    assert stats.shape == (cfg.num_layers + 1, 3)
    # the lm head quantizes the 2 last positions' d_model activations
    assert float(stats[-1, 1]) == 2 * cfg.d_model
    with pytest.raises(ValueError, match="unsupported"):
        api.prefill_probed(params, cfg.replace(matmul_mode="bf16"),
                           {"tokens": tokens}, 8)


# ---------------------------------------------------------------------------
# probed serves against the reference engine
# ---------------------------------------------------------------------------

def _hw(run):
    return [r for r in run["loop"].stream if r["kind"] == "hw_estimate"]


@pytest.mark.parametrize("case", CASES)
def test_probe_keeps_token_streams(reference, runs, case):
    run = runs[case]
    got = _tokens(run["rep"])
    assert got == _tokens(run["off"])
    assert got == reference["cases"][f"{case}/0"]["tokens"]
    assert got == reference["cases"][f"{case}/1"]["tokens"]


def _cycle_se(model):
    """Per method: the largest standard error of a difference between two
    independent Monte-Carlo table entries, from the port's own samples at
    every grid point."""
    out = {}
    for method in tprobe.PROBE_METHODS:
        m = "bit_serial" if method == "adas" else method
        pts = ([(a, w) for a in tprobe._GRID for w in tprobe._GRID]
               if method in ("bp_exact", "bp_approx")
               else [(a, None) for a in tprobe._GRID])
        var = max(float(tcm.cycle_samples(
            m, *tcm.mc_operands(a, model.n_mc, model.seed, w)).var())
            for a, w in pts)
        out[method] = np.sqrt(2.0 * var / model.n_mc)
    return out


@pytest.mark.parametrize("case", CASES)
def test_hw_records_match_reference(reference, runs, case):
    got = _hw(runs[case])
    want = reference["cases"][f"{case}/0"]["hw"]
    assert [(r["step"], r["phase"]) for r in got] == \
        [(r["step"], r["phase"]) for r in want]
    assert {r["phase"] for r in got} >= {"prefill", "decode" if "none" in
                                         case else "verify"}
    se = _cycle_se(runs[case]["engine"].serve_cfg.probe._model)
    for g, w in zip(got, want):
        assert g["n_layers"] == w["n_layers"] == tp.SMALL["num_layers"]
        for key in ("act_bit_sparsity", "act_value_sparsity",
                    "weight_bit_sparsity"):
            assert abs(g[key] - w[key]) <= 1e-6, key
        for key in ("per_layer_act_bit_sparsity",
                    "per_layer_act_value_sparsity"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-6)
        assert set(g["cycles"]) == set(w["cycles"]) == set(
            tprobe.PROBE_METHODS)
        op_bs = 0.5 * (g["act_bit_sparsity"] + g["weight_bit_sparsity"])
        for m in tprobe.PROBE_METHODS:
            assert g["mac_energy_pj"][m] == pytest.approx(
                jcm.mac_energy_pj(m, op_bs), rel=1e-9)
            assert abs(g["cycles"][m] - w["cycles"][m]) <= 4 * se[m], m


@pytest.mark.parametrize("case", CASES)
def test_array_model_within_reference_seed_spread(reference, runs, case):
    got = _hw(runs[case])
    ref0 = reference["cases"][f"{case}/0"]["hw"]
    ref1 = reference["cases"][f"{case}/1"]["hw"]
    for key in ("array_utilization", "array_cycles_per_step"):
        spread = max(abs(a[key] - b[key]) for a, b in zip(ref0, ref1))
        dev = max(abs(g[key] - w[key]) for g, w in zip(got, ref0))
        assert dev <= 2 * spread, (key, dev, spread)
        assert all(0.0 < g["array_utilization"] <= 1.0 for g in got)


@pytest.mark.parametrize("case", CASES)
def test_probe_bytes_and_schema_match_reference(reference, runs, case):
    stream = runs[case]["loop"].stream
    got = [[r["kind"], r["d2h_bytes"]] for r in stream
           if r["kind"] in STEP_KINDS]
    assert got == reference["cases"][f"{case}/0"]["d2h"]
    for r in stream:
        assert STEP_SCHEMA[r["kind"]] <= set(r), r["kind"]


@pytest.mark.parametrize("case", CASES)
def test_report_is_the_fold_of_the_written_file(runs, case):
    run = runs[case]
    rep, stream, records = run["rep"], run["loop"].stream, run["file"]
    assert records == stream              # the file holds the live records
    s = tserving.reduce_stream(records)
    assert s == tserving.reduce_stream(stream)
    hw = rep.hw_measured
    assert hw["n_samples"] == s.n_hw_samples == len(_hw(run)) > 0
    n = s.n_hw_samples
    assert hw["act_bit_sparsity"] == s.hw_act_bit_sparsity / n
    assert hw["array_utilization"] == s.hw_array_utilization / n
    assert hw["cycles"] == {k: v / n for k, v in s.hw_cycles.items()}
    assert hw["mac_energy_pj"] == {k: v / n
                                   for k, v in s.hw_mac_energy_pj.items()}
    for field in ("steps", "total_new_tokens", "prefill_s", "decode_s",
                  "n_preemptions", "drafted_tokens", "accepted_tokens"):
        assert getattr(rep, field) == getattr(s, field), field
    events = run["trace"]["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    assert {"serve", "prefill"} <= {e["name"] for e in spans}
    counters = {e["name"] for e in events if e["ph"] == "C"}
    assert counters == {"sparsity", "hw_model"}


@pytest.mark.parametrize("case", CASES)
def test_cost_hint_is_cycles_per_processed_token(runs, case):
    loop = runs[case]["loop"]
    cycles = tokens = 0
    for r in loop.stream:
        if r["kind"] == "prefill":
            n = r["prompt_tokens"] + r["committed_tokens"]
        elif r["kind"] in ("decode", "verify"):
            n = r["committed_tokens"] + r.get("chunk_tokens", 0)
        elif r["kind"] == "hw_estimate":
            cycles += r["array_cycles_per_step"]
            tokens += max(n, 1)
    assert loop.cost_hint_cycles_per_token == pytest.approx(cycles / tokens)
    assert loop.cost_hint_cycles_per_token > 0


def test_deployment_and_weight_profile_match_reference(reference, runs):
    want = reference["cases"]["slab-none/0"]
    eng = runs["slab-none"]["engine"]
    got = runs["slab-none"]["rep"].deployment
    assert got["mode"] == want["deployment"]["mode"] == "bp_exact"
    assert [e["layer"] for e in got["per_layer"]] == \
        [e["layer"] for e in want["deployment"]["per_layer"]]
    for g, w in zip(got["per_layer"], want["deployment"]["per_layer"]):
        assert abs(g["bit_sparsity"] - w["bit_sparsity"]) <= 1e-6
        assert g["mac_energy_pj"] == pytest.approx(
            jcm.mac_energy_pj("bp_exact", g["bit_sparsity"]), rel=1e-9)
        samples = tcm.cycle_samples(
            "bp_exact", *tcm.mc_operands(g["bit_sparsity"], 20_000, 0))
        se = np.sqrt(2.0 * float(samples.var()) / samples.numel())
        assert abs(g["avg_cycles_per_mac"] - w["avg_cycles_per_mac"]) \
            <= 4 * se
    prof, wprof = eng.weight_sparsity_profile(), want["weight_profile"]
    for key in ("bit_sparsity", "value_sparsity"):
        assert prof[key] == pytest.approx(wprof[key], abs=1e-9)
    np.testing.assert_allclose(prof["per_layer_bit_sparsity"],
                               wprof["per_layer_bit_sparsity"], atol=1e-9)
    assert prof["tail_bit_sparsity"] is wprof["tail_bit_sparsity"] is None
    assert runs["slab-none"]["off"].hw_measured is None


def test_null_probe_and_subsampling(reference):
    cfg = _cfg(get_arch)
    eng = _engine(tserving, reference["params"], cfg, "slab-none",
                  device="cpu")
    loop = eng.make_loop([tserving.Request(prompt=_prompts()[0],
                                           max_new_tokens=2)], n_slots=1,
                         cache_T=32)
    assert loop.probe is tserving.NULL_PROBE and not loop.probe.enabled
    assert not tserving.NULL_PROBE.should_sample(0)
    assert loop.cost_hint_cycles_per_token == 0.0
    eng = _engine(tserving, reference["params"], cfg, "slab-none",
                  probe=tserving.SparsityProbe(probe_every=2, n_mc=N_MC),
                  device="cpu")
    loop, _ = _run(tserving, eng)
    decodes = [r["step"] for r in loop.stream if r["kind"] == "decode"]
    hw = [r["step"] for r in loop.stream
          if r["kind"] == "hw_estimate" and r["phase"] == "decode"]
    # a decode sampled at clock c records step c + 1
    assert hw == [s for s in decodes if (s - 1) % 2 == 0]
    assert 0 < len(hw) < len(decodes)


def test_unsupported_configs_raise(reference):
    probe = tserving.SparsityProbe(probe_every=1, n_mc=N_MC)
    cfg = _cfg(get_arch).replace(matmul_mode="bf16")
    assert not tserving.probe_supported(cfg)
    assert tserving.probe_supported(cfg.replace(matmul_mode="bp_approx"))
    eng = _engine(tserving, reference["params"], cfg, "slab-none",
                  probe=probe, device="cpu")
    with pytest.raises(ValueError, match="probe"):
        eng.serve([tserving.Request(prompt=_prompts()[0],
                                    max_new_tokens=2)], n_slots=1,
                  cache_T=32)
    rwkv = get_arch("rwkv6-7b").reduced().replace(matmul_mode="bp_exact")
    assert not tserving.probe_supported(rwkv)
