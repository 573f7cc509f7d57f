"""Chunked prefill in the PyTorch port against the JAX package.

A prompt longer than ``ServeConfig.prefill_chunk`` is admitted on its first
chunk; the rest rides the multi-token verify step beside the other slots'
decodes, and the final chunk's argmax is the first generated token.  Held
here (workloads after ``test_frontdoor.py::TestChunkedPrefill``):

  * greedy streams equal the port's one-shot-prefill streams and the
    reference's chunked streams for chunk 1, 4 and 5 on the slab and paged
    stores, and ``steps``, ``chunk_tokens``, ``prefix_hit_blocks`` and
    ``cow_blocks`` equal the reference's (a shared system prompt on the
    paged store exercises the prefix trie under chunked admission);
  * chunk steps interleave with decode, and no step feeds more prompt
    tokens than the chunk per chunking slot;
  * a preemption in the middle of a chunked prefill restarts the chunks and
    still replays the same tokens (tiny paged pool);
  * chunked prefill composes with the prompt-lookup drafter;
  * temperature > 0 and ``prefill_chunk=0`` are refused.

The reference runs in one subprocess per file run
(``torch_parity.run_reference``).
"""

import dataclasses
from typing import Optional

import numpy as np
import pytest

import torch_parity as tp
from repro_torch import serving as tserving
from repro_torch.configs.base import get_arch

BLOCK_SIZE = 4
REPORT_FIELDS = ("steps", "chunk_tokens", "total_new_tokens",
                 "n_preemptions", "prefix_hit_blocks", "cow_blocks",
                 "peak_blocks_in_use", "drafted_tokens", "accepted_tokens")


def _hetero_prompts():
    # 5 prompts of 5, 14, 23, 9 and 18 tokens
    return [tp.tokens(i, 5 + 9 * i % 23) for i in range(5)]


def _shared_prefix_prompts():
    # a 12-token system prompt (3 full blocks) plus 3-6 tokens each
    system = tp.tokens(9, 12)
    return [np.concatenate([system, tp.tokens(10 + i, 3 + i)])
            for i in range(4)]


@dataclasses.dataclass(frozen=True)
class Workload:
    prompts: callable
    max_new: int
    n_slots: int
    arrivals: Optional[tuple] = None
    cache_T: Optional[int] = 64
    num_blocks: Optional[int] = None


WORKLOADS = {
    "hetero": Workload(_hetero_prompts, 6, n_slots=2),
    "shared-prefix": Workload(_shared_prefix_prompts, 4, n_slots=4,
                              arrivals=(0.0, 2.0, 4.0, 6.0)),
    # three 16-token prompts in 9 usable blocks of 4: the pool runs dry
    # while the newest request is still chunking
    "tiny-pool": Workload(lambda: list(tp.tokens(6, (3, 16))), 8, n_slots=3,
                          cache_T=24, num_blocks=10),
    # test_frontdoor.py's composition with speculation: 17-token prompts
    "spec": Workload(lambda: list(tp.tokens(7, (3, 17))), 10, n_slots=2),
}


@dataclasses.dataclass(frozen=True)
class Case:
    workload: str
    backend: str
    chunk: Optional[int]
    draft: str = "none"


CASES = {f"hetero-{b}-chunk{c}": Case("hetero", b, c)
         for b in ("slab", "paged") for c in (1, 4, 5)}
CASES["shared-prefix-paged-chunk5"] = Case("shared-prefix", "paged", 5)
CASES["tiny-pool-paged-chunk4"] = Case("tiny-pool", "paged", 4)
CASES["spec-slab-chunk5-prompt_lookup"] = Case("spec", "slab", 5,
                                               "prompt_lookup")


def _base_cfg(get):
    return get("qwen2-1.5b").reduced().replace(**tp.SMALL)


def _engine(pkg, params, case: Case, get, **kw):
    wl = WORKLOADS[case.workload]
    return pkg.ServingEngine(_base_cfg(get), params, pkg.ServeConfig(
        max_new_tokens=wl.max_new, temperature=0.0,
        cache_backend=case.backend, block_size=BLOCK_SIZE,
        prefill_chunk=case.chunk, draft=case.draft, num_draft_tokens=3),
        **kw)


def _requests(pkg, wl: Workload):
    arrivals = wl.arrivals or (0.0,) * len(wl.prompts())
    return [pkg.Request(prompt=p.copy(), max_new_tokens=wl.max_new,
                        arrival_time=arrivals[i], request_id=i)
            for i, p in enumerate(wl.prompts())]


def _loop(pkg, engine, wl: Workload):
    kw = {"num_blocks": wl.num_blocks} if wl.num_blocks else {}
    return engine.make_loop(_requests(pkg, wl), n_slots=wl.n_slots,
                            cache_T=wl.cache_T, **kw)


def write_reference(out_dir: str) -> None:
    """Run every case through the JAX engine (called in the subprocess)."""
    import jax
    from repro import serving as jserving
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import api as japi

    params = japi.init(jax.random.PRNGKey(0), _base_cfg(jax_get_arch))
    out = {"cases": {}}
    for name, case in CASES.items():
        eng = _engine(jserving, params, case, jax_get_arch)
        rep = _loop(jserving, eng, WORKLOADS[case.workload]).run()
        out["cases"][name] = tp.summary(rep, REPORT_FIELDS)
    tp.save_reference(out_dir, out, params)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference("test_torch_chunked_prefill",
                            tmp_path_factory.mktemp("jax_chunk_reference"))


def _port_engine(reference, case: Case):
    return _engine(tserving, reference["params"], case, get_arch,
                   device="cpu")


@pytest.fixture(scope="module")
def oneshot(reference):
    """The port's one-shot-prefill (no chunking, no drafter) streams per
    (workload, store)."""
    out = {}
    for case in CASES.values():
        key = (case.workload, case.backend)
        if key not in out:
            eng = _port_engine(reference, Case(case.workload, case.backend,
                                               None))
            out[key] = _loop(tserving, eng, WORKLOADS[case.workload]).run()
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_serve_matches_reference(reference, name):
    case = CASES[name]
    eng = _port_engine(reference, case)
    got = tp.summary(_loop(tserving, eng, WORKLOADS[case.workload]).run(),
                     REPORT_FIELDS)
    want = reference["cases"][name]
    prompts = WORKLOADS[case.workload].prompts()
    assert got["tokens"] == want["tokens"], (
        "token streams differ:\n"
        + tp.flip_report(eng, prompts, got["tokens"], want["tokens"]))
    assert got["finish"] == want["finish"]
    for field in REPORT_FIELDS:
        assert got["report"][field] == want["report"][field], field
    if case.workload == "shared-prefix":
        assert want["report"]["prefix_hit_blocks"] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_serve_matches_oneshot(reference, oneshot, name):
    case = CASES[name]
    eng = _port_engine(reference, case)
    rep = _loop(tserving, eng, WORKLOADS[case.workload]).run()
    base = oneshot[case.workload, case.backend]
    got, want = tp.summary(rep, ()), tp.summary(base, ())
    assert got["tokens"] == want["tokens"], (
        "chunked and one-shot streams differ:\n"
        + tp.flip_report(eng, WORKLOADS[case.workload].prompts(),
                         got["tokens"], want["tokens"]))
    assert got["finish"] == want["finish"]
    long_prompts = sum(max(len(p) - case.chunk, 0)
                       for p in WORKLOADS[case.workload].prompts())
    assert rep.chunk_tokens >= long_prompts > 0


def test_chunks_interleave_with_decode(reference):
    """A long prompt admitted mid-run does not stall the decoder in
    flight: some verify step carries both decode commits and chunk
    feeds, and no step feeds more than a chunk per chunking slot."""
    eng = _port_engine(reference, Case("hetero", "paged", 4))
    reqs = [tserving.Request(prompt=tp.tokens(1, 4), max_new_tokens=12,
                             arrival_time=0.0),
            tserving.Request(prompt=tp.tokens(2, 24), max_new_tokens=4,
                             arrival_time=2.0)]
    loop = eng.make_loop(reqs, n_slots=2, cache_T=64)
    loop.run()
    verify = [r for r in loop.stream if r["kind"] == "verify"]
    assert any(r["chunk_tokens"] > 0 and r["committed_tokens"] > 0
               for r in verify)
    assert all(r["chunk_tokens"] <= 4 for r in verify)
    assert loop.cm.pool.n_live == 0


def test_mid_chunk_preemption_restarts_and_replays(reference, oneshot):
    case = CASES["tiny-pool-paged-chunk4"]
    eng = _port_engine(reference, case)
    loop = _loop(tserving, eng, WORKLOADS[case.workload])
    mid_chunk = []
    preempt = loop.preempt

    def spy(slot):
        mid_chunk.append(slot in loop.chunking)
        preempt(slot)

    loop.preempt = spy
    rep = loop.run()
    assert any(mid_chunk), "no preemption hit a request mid-chunk"
    assert not loop.chunking and loop.cm.pool.n_live == 0
    base = oneshot[case.workload, case.backend]
    assert (tp.summary(rep, ())["tokens"]
            == tp.summary(base, ())["tokens"])


@pytest.mark.parametrize("field,value,match", [
    ("temperature", 0.5, "greedy-only"),
    ("prefill_chunk", 0, "prefill_chunk"),
])
def test_chunked_prefill_refusals(reference, field, value, match):
    scfg = dict(prefill_chunk=4)
    scfg[field] = value
    eng = tserving.ServingEngine(_base_cfg(get_arch), reference["params"],
                                 tserving.ServeConfig(**scfg), device="cpu")
    with pytest.raises(ValueError, match=match):
        eng.make_loop([], cache_T=32)
