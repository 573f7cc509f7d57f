"""Speculative decoding in the PyTorch port against the JAX package.

  * ``PromptLookupDrafter`` proposes what the reference's drafter proposes,
    on the reference's cases (``test_speculative.py``) and on seeded random
    contexts.
  * ``SingleDeviceExecutor.verify_sample_fn`` gives the reference's (B, S)
    greedy grid on one cache and step (slab and paged, int8 KV on and off).
  * Greedy ``serve()`` with ``draft`` in {prompt_lookup, model (a
    self-draft: the target's own config and weights)} gives the reference's
    token streams on the workloads of ``test_speculative.py`` (staggered
    heterogeneous arrivals on the slab and paged stores, bp_exact and
    bp_approx with an int8 KV cache, a paged pool so small it preempts, EOS
    inside a multi-token commit), and the port's own non-speculative
    streams.  A parting is reported with the top-2 margin of the port's
    logits where it happens.
  * Counters: ``steps``, ``drafted_tokens`` and ``accepted_tokens`` equal the
    reference's for the prompt-lookup drafter.  The model drafter's
    acceptance depends on argmax near-ties between a one-token draft step
    and the multi-token verify step, so its counters are held equal across
    two port runs and any difference to the reference's is printed; its
    steps must be below the port's non-speculative baseline.
  * Edge cases: the draft cache tracks the target's positions, a paged
    serve leaves no live block, the verify step flags non-finite logits,
    and ``make_drafter`` refuses what the reference refuses.

The reference runs in one subprocess per file run
(``torch_parity.run_reference``).
"""

import dataclasses
from typing import Optional

import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.serving.speculative import PromptLookupDrafter as JaxLookup
from repro.serving.telemetry import STEP_SCHEMA
from repro_torch import serving as tserving
from repro_torch.configs.base import get_arch
from repro_torch.models import api

K = 3
BLOCK_SIZE = 4
REPORT_FIELDS = ("steps", "drafted_tokens", "accepted_tokens",
                 "total_new_tokens", "n_preemptions", "prefix_hit_blocks",
                 "cow_blocks", "peak_blocks_in_use")


@dataclasses.dataclass(frozen=True)
class Workload:
    seed: int
    n: int
    prompt_len: int
    max_new: tuple
    arrivals: tuple
    n_slots: int
    cache_T: Optional[int] = None
    num_blocks: Optional[int] = None


WORKLOADS = {
    # test_speculative.py's staggered heterogeneous stream
    "staggered": Workload(1, 5, 6, (8, 3, 8, 5, 1), (0.0, 1.0, 2.0, 3.0, 4.0),
                          n_slots=2),
    # its quantized-mode stream
    "quantized": Workload(2, 3, 6, (6,) * 3, (0.0, 1.0, 2.0), n_slots=2),
    # its tiny paged pool: three 8-token prompts in 8 usable blocks
    "tiny-pool": Workload(3, 3, 8, (8,) * 3, (0.0,) * 3, n_slots=3,
                          cache_T=24, num_blocks=9),
    # EOS inside a multi-token commit (the EOS id is a token of request 0's
    # greedy stream, picked by the reference run)
    "eos": Workload(4, 2, 5, (8, 8), (0.0, 0.0), n_slots=2),
}


@dataclasses.dataclass(frozen=True)
class Case:
    workload: str
    draft: str
    backend: str = "slab"
    mode: str = "bf16"
    int8kv: bool = False


CASES = {}
for _d in ("prompt_lookup", "model"):
    for _b in ("slab", "paged"):
        CASES[f"staggered-{_b}-{_d}"] = Case("staggered", _d, _b)
    for _m in ("bp_exact", "bp_approx"):
        CASES[f"quantized-{_m}-int8kv-{_d}"] = Case("quantized", _d, "slab",
                                                   _m, True)
    CASES[f"tiny-pool-paged-{_d}"] = Case("tiny-pool", _d, "paged")
    CASES[f"eos-slab-{_d}"] = Case("eos", _d)
MODEL_CASES = [k for k, c in CASES.items() if c.draft == "model"]


def _base_cfg(get):
    return get("qwen2-1.5b").reduced().replace(**tp.SMALL)


def _prompts(wl: Workload):
    return tp.tokens(wl.seed, (wl.n, wl.prompt_len))


def _requests(pkg, wl: Workload):
    prompts = _prompts(wl)
    return [pkg.Request(prompt=prompts[i].copy(),
                        max_new_tokens=wl.max_new[i],
                        arrival_time=wl.arrivals[i], request_id=i)
            for i in range(wl.n)]


def _engine(pkg, params, case: Case, get, *, draft=None, eos=None, **kw):
    cfg = _base_cfg(get).replace(matmul_mode=case.mode,
                                 kv_cache_int8=case.int8kv)
    draft = case.draft if draft is None else draft
    scfg = pkg.ServeConfig(max_new_tokens=8, temperature=0.0,
                           cache_backend=case.backend,
                           block_size=BLOCK_SIZE, draft=draft,
                           num_draft_tokens=K, eos_id=eos)
    if draft == "model":
        kw.update(draft_cfg=cfg, draft_params=params)
    return pkg.ServingEngine(cfg, params, scfg, **kw)


def _serve(pkg, engine, wl: Workload):
    kw = {"num_blocks": wl.num_blocks} if wl.num_blocks else {}
    return engine.serve(_requests(pkg, wl), n_slots=wl.n_slots,
                        cache_T=wl.cache_T, **kw)


# verify grid: three slots (slot 2 free) at positions 5 and 9, four fed
# tokens each
VERIFY_LENS = (5, 9)
VERIFY_CONFIGS = [(b, i) for b in ("slab", "paged") for i in (False, True)]


def _verify_grid(pkg, engine, backend):
    """The (3, 4) greedy grid of one verify step over a cache holding two
    prefilled prompts."""
    cm = pkg.make_cache_manager(engine.cfg, 3, 24, backend=backend,
                                block_size=BLOCK_SIZE,
                                executor=engine.executor)
    cache_T = cm.prefill_T if backend == "paged" else 24
    for i, n in enumerate(VERIFY_LENS):
        toks = tp.tokens(20 + i, (1, n))
        _, src = engine.executor.prefill({"tokens": toks}, cache_T)
        slot = cm.alloc()
        cm.insert(slot, src, n, tokens=toks[0].tolist())
    feed = tp.tokens(30, (3, 4))
    if backend == "paged":
        assert cm.prepare_append([0, 1], [4, 4]) is None
    step = {"tokens": feed, "cache_len": cm.cache_len_vector()}
    if backend == "paged":
        step["block_tables"] = cm.block_tables_device()
    grid, _ = engine.executor.verify_sample_fn(paged=backend == "paged")(
        cm.cache, step)
    return np.asarray(grid)[:2].tolist()


def write_reference(out_dir: str) -> None:
    """Run every case through the JAX engine (called in the subprocess)."""
    import jax
    from repro import serving as jserving
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import api as japi

    # float weights on both sides: each engine quantizes them itself in the
    # bp_* modes
    params = japi.init(jax.random.PRNGKey(0), _base_cfg(jax_get_arch))
    out = {"cases": {}, "verify": {}}
    probe = _engine(jserving, params, Case("eos", "none"), jax_get_arch)
    stream = _serve(jserving, probe, WORKLOADS["eos"]).results[0].tokens
    out["eos_id"] = eos = int(stream[2])
    for name, case in CASES.items():
        eng = _engine(jserving, params, case, jax_get_arch,
                      eos=eos if case.workload == "eos" else None)
        rep = _serve(jserving, eng, WORKLOADS[case.workload])
        out["cases"][name] = tp.summary(rep, REPORT_FIELDS)
    for backend, int8kv in VERIFY_CONFIGS:
        case = Case("staggered", "none", backend, "bf16", int8kv)
        eng = _engine(jserving, params, case, jax_get_arch)
        out["verify"][f"{backend}-{int8kv}"] = _verify_grid(jserving, eng,
                                                            backend)
    tp.save_reference(out_dir, out, params)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference("test_torch_speculative",
                            tmp_path_factory.mktemp("jax_spec_reference"))


def _port_engine(reference, case: Case, **kw):
    return _engine(tserving, reference["params"], case, get_arch,
                   device="cpu", **kw)


@pytest.fixture(scope="module")
def baselines(reference):
    """The port's non-speculative streams, per (workload, store, mode)."""
    out = {}
    for case in CASES.values():
        key = (case.workload, case.backend, case.mode, case.int8kv)
        if key not in out:
            eos = reference["eos_id"] if case.workload == "eos" else None
            eng = _port_engine(reference, dataclasses.replace(
                case, draft="none"), eos=eos)
            out[key] = _serve(tserving, eng, WORKLOADS[case.workload])
    return out


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

# (max_ngram, min_ngram, context, k): the reference's cases, then seeded
# random contexts over a small alphabet (so n-grams repeat)
LOOKUP_CASES = [
    (2, 1, [5, 6, 7, 8, 9, 5, 6], 4),
    (3, 1, [1, 2, 3, 9, 1, 2, 4, 1, 2], 2),
    (3, 1, [1, 2, 3, 4], 4),
    (1, 1, [3, 4, 3, 4, 3, 4], 2),
] + [(int(r.integers(1, 4)), 1, r.integers(2, 6, int(r.integers(2, 40))
                                         ).tolist(), int(r.integers(1, 6)))
     for r in (np.random.default_rng(s) for s in range(8))]


@pytest.mark.parametrize("max_ngram,min_ngram,ctx,k", LOOKUP_CASES)
def test_prompt_lookup_matches_reference(max_ngram, min_ngram, ctx, k):
    ctx = np.asarray(ctx, np.int64)
    got = tserving.PromptLookupDrafter(K, max_ngram=max_ngram,
                                       min_ngram=min_ngram)._lookup(ctx, k)
    want = JaxLookup(K, max_ngram=max_ngram,
                     min_ngram=min_ngram)._lookup(ctx, k)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_prompt_lookup_propose_all_respects_caps():
    d = tserving.PromptLookupDrafter(4, max_ngram=1)
    req = tserving.Request(prompt=np.asarray([3, 4, 3, 4, 3], np.int32),
                           max_new_tokens=8)
    req.tokens = [4]
    # context 3 4 3 4 3 4: the last 4 recurs at position 3, then 3 4 follow
    out = d.propose_all({0: req, 1: req}, {0: 1})
    assert out[0].tolist() == [3] and out[1].tolist() == [3, 4]


# ---------------------------------------------------------------------------
# the executor's verify step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,int8kv", VERIFY_CONFIGS,
                         ids=[f"{b}-{'int8kv' if i else 'bf16kv'}"
                              for b, i in VERIFY_CONFIGS])
def test_verify_grid_matches_reference(reference, backend, int8kv):
    eng = _port_engine(reference, Case("staggered", "none", backend, "bf16",
                                       int8kv))
    got = _verify_grid(tserving, eng, backend)
    assert got == reference["verify"][f"{backend}-{int8kv}"]
    assert all(t >= 0 for row in got for t in row)


def test_verify_flags_non_finite_logits_per_slot(reference):
    eng = _port_engine(reference, Case("staggered", "none"))
    cm = tserving.make_cache_manager(eng.cfg, 2, 16, executor=eng.executor)
    for i in range(2):
        toks = tp.tokens(40 + i, (1, 6))
        _, src = eng.executor.prefill({"tokens": toks}, 16)
        cm.insert(cm.alloc(), src, 6)
    cm.cache["k"][:, 1] = float("nan")        # poison slot 1's keys
    grid, _ = eng.executor.verify_sample_fn()(
        cm.cache, {"tokens": tp.tokens(41, (2, 3)),
                   "cache_len": cm.cache_len_vector()})
    assert grid.dtype == torch.int32 and grid.shape == (2, 3)
    assert (grid[0] >= 0).all() and (grid[1] == -1).all()


# ---------------------------------------------------------------------------
# greedy serve: token identity and counters
# ---------------------------------------------------------------------------

def _port_serve(reference, name):
    case = CASES[name]
    eos = reference["eos_id"] if case.workload == "eos" else None
    eng = _port_engine(reference, case, eos=eos)
    return eng, _serve(tserving, eng, WORKLOADS[case.workload])


@pytest.mark.parametrize("name", list(CASES))
def test_spec_serve_matches_reference(reference, name):
    case = CASES[name]
    want = reference["cases"][name]
    eng, rep = _port_serve(reference, name)
    got = tp.summary(rep, REPORT_FIELDS)
    prompts = _prompts(WORKLOADS[case.workload])
    assert got["tokens"] == want["tokens"], (
        "token streams differ:\n"
        + tp.flip_report(eng, prompts, got["tokens"], want["tokens"]))
    assert got["finish"] == want["finish"]
    assert rep.draft == case.draft
    if case.draft == "prompt_lookup":
        for field in REPORT_FIELDS:
            assert got["report"][field] == want["report"][field], field
    else:
        # the acceptance of a model drafter moves with near-ties between
        # its one-token step and the verify step: printed, not held
        diff = {f: (got["report"][f], want["report"][f])
                for f in REPORT_FIELDS
                if got["report"][f] != want["report"][f]}
        if diff:
            print(f"{name}: counters (port, reference) differ: {diff}")
    if case.workload == "tiny-pool":
        assert rep.n_preemptions > 0      # the pool is genuinely too small
    if case.workload == "eos":
        assert "eos" in got["finish"].values()


@pytest.mark.parametrize("name", list(CASES))
def test_spec_serve_matches_nonspec_serve(reference, baselines, name):
    case = CASES[name]
    eng, rep = _port_serve(reference, name)
    base = baselines[case.workload, case.backend, case.mode, case.int8kv]
    got = tp.summary(rep, ())
    want = tp.summary(base, ())
    prompts = _prompts(WORKLOADS[case.workload])
    assert got["tokens"] == want["tokens"], (
        "speculative and plain streams differ:\n"
        + tp.flip_report(eng, prompts, got["tokens"], want["tokens"]))
    assert got["finish"] == want["finish"]
    assert rep.total_new_tokens == base.total_new_tokens
    assert rep.accepted_tokens <= rep.drafted_tokens
    if case.draft == "model":
        # a self-draft proposes the target's own argmax stream
        assert rep.steps < base.steps
        assert rep.committed_tokens_per_step > 1.0


@pytest.mark.parametrize("name", MODEL_CASES)
def test_model_drafter_counters_repeat(reference, name):
    runs = [tp.summary(_port_serve(reference, name)[1], REPORT_FIELDS)
            for _ in range(2)]
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------

def test_draft_cache_tracks_target_positions(reference):
    eng = _port_engine(reference, Case("staggered", "model"))
    wl = WORKLOADS["quantized"]
    loop = eng.make_loop(_requests(tserving, wl), n_slots=3)
    loop.submit_arrivals()
    for group in loop.sched.plan_admissions():
        loop.admit(group)
    for _ in range(2):
        loop.decode_once_spec()
        for slot in loop.active:
            # the draft cache covers exactly the committed context
            assert loop.drafter.cm.lengths[slot] == loop.cm.lengths[slot]


@pytest.mark.parametrize("draft", ["prompt_lookup", "model"])
def test_paged_spec_serve_leaves_no_live_blocks(reference, draft):
    eng = _port_engine(reference, Case("staggered", draft, "paged"))
    wl = WORKLOADS["tiny-pool"]
    loop = eng.make_loop(_requests(tserving, wl), n_slots=wl.n_slots,
                         cache_T=wl.cache_T, num_blocks=wl.num_blocks)
    rep = loop.run()
    assert rep.n_preemptions > 0
    assert loop.cm.pool.n_live == 0
    if draft == "model":
        assert loop.drafter.cm.n_active == 0


def test_verify_records_and_accounting(reference):
    eng = _port_engine(reference, CASES["quantized-bp_exact-int8kv-model"])
    loop = eng.make_loop(_requests(tserving, WORKLOADS["quantized"]),
                         n_slots=2)
    rep = loop.run()
    verify = [r for r in loop.stream if r["kind"] == "verify"]
    assert verify and len(verify) == rep.steps
    for r in verify:
        # the reference's keys and the port's additive launch counts
        assert set(r) == STEP_SCHEMA["verify"] | {"k1_launches",
                                                  "k2_launches"}
    assert rep.drafted_tokens == sum(r["drafted_tokens"] for r in verify)
    assert rep.accepted_tokens == sum(r["accepted_tokens"] for r in verify)
    total = sum(len(r.tokens) for r in rep.results)
    assert rep.total_new_tokens == total
    # each request's first token comes from its prefill
    assert rep.steps * rep.committed_tokens_per_step == pytest.approx(
        total - len(rep.results))
    assert 0.0 < rep.acceptance_rate <= 1.0
    run = next(r for r in loop.stream if r["kind"] == "run")
    assert run["draft"] == "model"


def test_classic_path_accounting_unchanged(reference):
    eng = _port_engine(reference, Case("staggered", "none"))
    rep = _serve(tserving, eng, WORKLOADS["staggered"])
    assert rep.draft == "none" and rep.drafted_tokens == 0
    assert rep.acceptance_rate == 0.0 and rep.chunk_tokens == 0


def _rwkv_cfg():
    return get_arch("rwkv6-7b").reduced().replace(
        num_layers=1, d_model=64, d_ff=128, vocab_size=128)


@pytest.mark.parametrize("what,match", [
    ("family", "draft family"),
    ("vocab", "draft vocab"),
    ("temperature", "greedy"),
    ("num_draft_tokens", "num_draft_tokens must be >= 1"),
    ("no_draft_model", "needs a draft model"),
    ("unknown", "unknown draft"),
])
def test_make_drafter_refusals(reference, what, match):
    cfg = _base_cfg(get_arch)
    params = reference["params"]
    scfg = dict(draft="model", num_draft_tokens=2)
    kw = dict(draft_cfg=cfg, draft_params=params)
    if what == "family":
        kw = dict(draft_cfg=_rwkv_cfg(),
                  draft_params=api.init(_rwkv_cfg(), device="cpu"))
    elif what == "vocab":
        other = cfg.replace(vocab_size=256)
        kw = dict(draft_cfg=other,
                  draft_params=api.init(other, device="cpu"))
    elif what == "temperature":
        scfg.update(draft="prompt_lookup", temperature=0.5)
    elif what == "num_draft_tokens":
        scfg.update(draft="prompt_lookup", num_draft_tokens=0)
    elif what == "no_draft_model":
        kw = {}
    else:
        scfg.update(draft="wat")
    eng = tserving.ServingEngine(cfg, params, tserving.ServeConfig(**scfg),
                                 device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        eng.serve([tserving.Request(prompt=tp.tokens(5, 4),
                                    max_new_tokens=2)], n_slots=1)
