"""The paged KV store of the PyTorch port against the JAX package.

  (b) ``BlockPool`` / ``PagedCacheManager``: the port's and the reference's
      managers are driven through the same seeded sequence of operations
      (admissions with full and partial prefix hits, appends with
      copy-on-write, speculative-style rollbacks through ``release_tail``,
      frees, and admissions that run the pool dry).  After every operation
      the refcounts, block tables, lengths, free / cached sets, the hit,
      copy-on-write and eviction counters, and the page contents agree.
  (c) Paged greedy ``serve()``: tokens, finish reasons and the report's
      counters (the pool gauges and preemptions included) equal the JAX
      engine's on the paged workloads of ``test_paged_kv.py`` (staggered
      heterogeneous arrivals, shared prefix, partial-prefix copy-on-write,
      a pool that runs dry and preempts) in bf16, bp_exact with a bf16 KV
      cache and bp_exact with an int8 KV cache.  The reference runs jitted
      in one subprocess with ``XLA_FLAGS=--xla_allow_excess_precision=false``
      for the reason ``test_torch_serving.py`` gives.
  (d) Slab against paged inside the port: the same token streams.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
from typing import Callable, List, Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.serving.block_pool import PagedCacheManager as JaxPagedManager
from repro.serving.block_pool import NoFreeBlocks as JaxNoFreeBlocks
from repro_torch import serving as tserving
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import api

HERE = pathlib.Path(__file__).resolve().parent
SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128, head_dim=16)
MODES = {"bf16": ("bf16", False), "bp_exact-bf16kv": ("bp_exact", False),
         "bp_exact-int8kv": ("bp_exact", True)}
BLOCK_SIZE = 4


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        2, SMALL["vocab_size"], shape).astype(np.int32)


def _shared_prefix():
    # a 12-token system prompt (3 full blocks) + 3 unique tokens each
    system = _tokens(9, 12)
    return [np.concatenate([system, u]) for u in _tokens(10, (4, 3))]


def _partial_prefix():
    # the second prompt is the first cut at 14 = 3 blocks + 2: it adopts
    # the first's partial tail block and copies it on its first append
    base = _tokens(5, 16)
    return [base, base[:14]]


@dataclasses.dataclass(frozen=True)
class Workload:
    prompts: Callable[[], List[np.ndarray]]
    max_new: tuple
    arrivals: tuple
    n_slots: int
    lead_window: int = 4
    cache_T: Optional[int] = None
    num_blocks: Optional[int] = None


WORKLOADS = {
    "staggered-hetero": Workload(lambda: list(_tokens(1, (5, 6))),
                                 (8, 3, 8, 5, 1), (0.0, 1.0, 2.0, 3.0, 4.0),
                                 n_slots=2, lead_window=2),
    "shared-prefix": Workload(_shared_prefix, (4,) * 4, (0.0, 2.0, 4.0, 6.0),
                              n_slots=4),
    "partial-prefix-cow": Workload(_partial_prefix, (6, 6), (0.0, 3.0),
                                   n_slots=2),
    "pool-dry-preempt": Workload(lambda: list(_tokens(3, (3, 8))),
                                 (8, 8, 8), (0.0, 0.0, 0.0), n_slots=3,
                                 cache_T=24, num_blocks=9),
}
REPORT_FIELDS = ("steps", "n_syncs", "total_new_tokens", "n_rejected",
                 "peak_active_slots", "max_divergence", "slot_utilization",
                 "n_preemptions", "prefix_hit_blocks", "cow_blocks",
                 "peak_blocks_in_use")


def _serve(pkg, engine, wl: Workload, *, paged=True):
    prompts = wl.prompts()
    reqs = [pkg.Request(prompt=prompts[i].copy(),
                        max_new_tokens=wl.max_new[i],
                        arrival_time=wl.arrivals[i], request_id=i)
            for i in range(len(wl.max_new))]
    kw = {"num_blocks": wl.num_blocks} if paged else {}
    return engine.serve(reqs, n_slots=wl.n_slots, cache_T=wl.cache_T,
                        sched_cfg=pkg.SchedulerConfig(
                            lead_window=wl.lead_window), **kw)


def _summary(report):
    return {"tokens": {str(r.request_id): np.asarray(r.tokens).tolist()
                       for r in report.results},
            "finish": {str(r.request_id): r.finish_reason
                       for r in report.results},
            "report": {f: getattr(report, f) for f in REPORT_FIELDS}}


def _base_cfg(get):
    return get("qwen2-1.5b").reduced().replace(**SMALL)


def write_reference(out_dir: str) -> None:
    """Run every (mode, workload) through the JAX engine's paged store;
    write the summaries as JSON and the weights as .npz.  Runs in the
    subprocess that the ``reference`` fixture starts."""
    import jax
    from repro import serving as jserving
    from repro.models import api as japi

    base = _base_cfg(jax_get_arch)
    params = japi.init(jax.random.PRNGKey(0), base)
    out = {}
    for mode, (mm, int8kv) in MODES.items():
        eng = jserving.ServingEngine(
            base.replace(matmul_mode=mm, kv_cache_int8=int8kv), params,
            jserving.ServeConfig(max_new_tokens=8, temperature=0.0,
                                 cache_backend="paged",
                                 block_size=BLOCK_SIZE))
        for name, wl in WORKLOADS.items():
            out[f"{mode}/{name}"] = _summary(_serve(jserving, eng, wl))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out["dtypes"] = {"/".join(str(k.key) for k in path): str(leaf.dtype)
                     for path, leaf in flat}
    np.savez(pathlib.Path(out_dir) / "params.npz", **{
        "/".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
        for path, leaf in flat})
    (pathlib.Path(out_dir) / "reference.json").write_text(json.dumps(out))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_paged_reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), str(HERE),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_paged_serving as t; "
         f"t.write_reference({str(out)!r})"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads((out / "reference.json").read_text())
    with np.load(out / "params.npz") as z:
        ref["params"] = {k: z[k] for k in z.files}
    return ref


@pytest.fixture(scope="module")
def engines(reference):
    tree = {}
    for path, value in reference["params"].items():
        *parents, name = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = value

    def cast(node, path=""):
        if isinstance(node, dict):
            return {k: cast(v, f"{path}/{k}".lstrip("/"))
                    for k, v in node.items()}
        return node.to(getattr(torch, reference["dtypes"][path]))

    params = cast(params_from_numpy(tree, device="cpu"))
    base = _base_cfg(get_arch)
    out = {}
    for mode, (mm, int8kv) in MODES.items():
        cfg = base.replace(matmul_mode=mm, kv_cache_int8=int8kv)
        for backend in ("paged", "slab"):
            out[mode, backend] = tserving.ServingEngine(
                cfg, params,
                tserving.ServeConfig(max_new_tokens=8, temperature=0.0,
                                     cache_backend=backend,
                                     block_size=BLOCK_SIZE),
                device="cpu")
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_paged_serve_matches_reference(reference, engines, mode, workload):
    want = reference[f"{mode}/{workload}"]
    got = _summary(_serve(tserving, engines[mode, "paged"],
                          WORKLOADS[workload]))
    assert got["tokens"] == want["tokens"]
    assert got["finish"] == want["finish"]
    for field in REPORT_FIELDS:
        assert got["report"][field] == pytest.approx(
            want["report"][field]), field
    # each workload exercises the part of the store it is named for
    rep = want["report"]
    if workload == "shared-prefix":
        assert rep["prefix_hit_blocks"] >= 9
    if workload == "partial-prefix-cow":
        assert rep["cow_blocks"] >= 1
    if workload == "pool-dry-preempt":
        assert rep["n_preemptions"] > 0


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_paged_serve_matches_slab_serve(engines, mode, workload):
    wl = WORKLOADS[workload]
    paged = _summary(_serve(tserving, engines[mode, "paged"], wl))
    slab = _summary(_serve(tserving, engines[mode, "slab"], wl, paged=False))
    assert paged["tokens"] == slab["tokens"]
    assert paged["finish"] == slab["finish"]


def test_pool_pressure_halves_the_lead_window(engines):
    base = engines["bf16", "paged"]
    eng = tserving.ServingEngine(
        base.cfg, base.params,
        tserving.ServeConfig(max_new_tokens=8, cache_backend="paged",
                             block_size=BLOCK_SIZE, pool_pressure_limit=1),
        device="cpu")
    prompts = WORKLOADS["pool-dry-preempt"].prompts()
    loop = eng.make_loop(
        [tserving.Request(prompt=prompts[i], max_new_tokens=8, request_id=i)
         for i in range(3)], n_slots=3, cache_T=24, num_blocks=9,
        sched_cfg=tserving.SchedulerConfig(lead_window=4))
    rep = loop.run()
    kinds = [r["kind"] for r in loop.stream]
    assert rep.n_preemptions == kinds.count("preempt") > 0
    assert kinds.count("degrade") >= 1
    assert loop.sched.cfg.lead_window < 4
    assert loop.cm.pool.n_live == 0                   # every block released
    assert all(r.finish_reason == "length" for r in rep.results)


# ---------------------------------------------------------------------------
# (b) the block pool under one seeded operation sequence
# ---------------------------------------------------------------------------

POOL_CFG = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=64,
                head_dim=8, num_heads=2, num_kv_heads=1)
N_SLOTS, CACHE_T, N_BLOCKS = 4, 16, 10


class _Pair:
    """The port's and the reference's paged managers, fed the same ops."""

    def __init__(self, int8kv):
        kw = dict(POOL_CFG, kv_cache_int8=int8kv)
        jcfg = jax_get_arch("qwen2-1.5b").reduced().replace(**kw)
        tcfg = get_arch("qwen2-1.5b").reduced().replace(**kw)
        self.j = JaxPagedManager(jcfg, N_SLOTS, CACHE_T, block_size=4,
                                 num_blocks=N_BLOCKS)
        self.t = tserving.make_cache_manager(
            tcfg, N_SLOTS, CACHE_T, backend="paged", block_size=4,
            num_blocks=N_BLOCKS,
            executor=tserving.SingleDeviceExecutor(tcfg, device="cpu"))
        self.tcfg = tcfg

    def src_cache(self, seed):
        """A random prefill-shaped cache (batch 2), the same on both
        sides."""
        rng = np.random.default_rng(seed)
        spec = api.cache_specs(self.tcfg, 2, self.t.prefill_T)
        j, t = {}, {}
        for name, (shape, dtype) in spec.items():
            x = rng.standard_normal(shape).astype(np.float32)
            if dtype == torch.int8:
                x = np.round(np.clip(x * 40, -127, 127))
            t[name] = torch.from_numpy(x).to(dtype)
            j[name] = jnp.asarray(x).astype(
                {torch.int8: jnp.int8, torch.float32: jnp.float32,
                 torch.bfloat16: jnp.bfloat16}[dtype])
        return j, t

    def check(self, what):
        jp, tp = self.j.pool, self.t.pool
        np.testing.assert_array_equal(self.t.pool.refcount, jp.refcount,
                                      err_msg=what)
        np.testing.assert_array_equal(self.t.tables, self.j.tables,
                                      err_msg=what)
        np.testing.assert_array_equal(self.t._n_blocks_of,
                                      self.j._n_blocks_of, err_msg=what)
        np.testing.assert_array_equal(self.t.lengths, self.j.lengths,
                                      err_msg=what)
        assert tp._free == jp._free, what
        assert list(tp._cached) == list(jp._cached), what
        for attr in ("n_free", "n_live", "n_prefix_hits", "n_cow",
                     "n_evictions", "peak_live"):
            assert getattr(tp, attr) == getattr(jp, attr), (what, attr)
        assert self.t.n_free == self.j.n_free, what
        for name, page in self.t.pages.items():
            want = np.asarray(self.j.pages[name]).astype(np.float32)
            # page 0 is the trash page: written in any order, never read
            np.testing.assert_array_equal(page.float().numpy()[:, 1:],
                                          want[:, 1:], err_msg=(what, name))


@pytest.mark.parametrize("int8kv", [False, True], ids=["bf16kv", "int8kv"])
@pytest.mark.parametrize("seed", [0, 1])
def test_block_pool_matches_reference_op_by_op(int8kv, seed):
    pair = _Pair(int8kv)
    rng = np.random.default_rng(seed)
    system = rng.integers(2, 64, 8)           # two full shared blocks
    bases = [np.concatenate([system, rng.integers(2, 64, 6)])
             for _ in range(2)]
    active = {}
    n_raised = 0
    # a full prompt, then a cut of it that adopts its registered third
    # block as a partial hit (copied on the first append), then random ops
    script = ["admit", "admit", "append"]
    for step in range(60):
        op = script[step] if step < len(script) else rng.choice(
            ["admit", "admit", "append", "append", "append", "free"])
        free = [s for s in range(N_SLOTS) if s not in active]
        if op == "admit" and free:
            base = bases[0 if step < 2 else rng.integers(len(bases))]
            n = ((len(base), 10)[step] if step < 2
                 else int(rng.integers(3, len(base) + 1)))
            toks = base[:n].astype(np.int32)
            js, ts = pair.src_cache(1000 * seed + step)
            src_i = int(rng.integers(2))
            sj, st = pair.j.alloc(), pair.t.alloc()
            assert sj == st
            raised = []
            for cm, src, exc in ((pair.j, js, JaxNoFreeBlocks),
                                 (pair.t, ts, tserving.NoFreeBlocks)):
                try:
                    cm.insert(sj, src, n, src_index=src_i, tokens=toks)
                    raised.append(False)
                except exc:
                    raised.append(True)
            assert raised[0] == raised[1]
            if raised[0]:
                n_raised += 1
                pair.j.free(sj)
                pair.t.free(st)
            else:
                active[sj] = n
        elif op == "append" and active:
            slots = sorted(active)
            counts = [int(rng.integers(1, 4)) for _ in slots]
            bad = [pair.j.prepare_append(slots, counts),
                   pair.t.prepare_append(slots, counts)]
            assert bad[0] == bad[1]
            if bad[0] is None:
                commits = [min(int(rng.integers(1, c + 1)),
                               CACHE_T - 1 - active[s])
                           for s, c in zip(slots, counts)]
                pair.j.advance(slots, commits)
                pair.t.advance(slots, commits)
                for s, c in zip(slots, commits):
                    active[s] += c
                    pair.j.release_tail(s)
                    pair.t.release_tail(s)
                    if active[s] >= CACHE_T - 1:   # full: retire it
                        pair.j.free(s)
                        pair.t.free(s)
                        del active[s]
        elif op == "free" and active:
            s = sorted(active)[int(rng.integers(len(active)))]
            pair.j.free(s)
            pair.t.free(s)
            del active[s]
        pair.check(f"step {step} ({op})")
    for s in list(active):
        pair.j.free(s)
        pair.t.free(s)
    pair.check("drained")
    assert pair.t.pool.n_live == 0
    # the sequence reached the parts of the pool it is meant to
    assert pair.t.pool.n_prefix_hits > 0 and pair.t.pool.n_cow > 0
    assert n_raised + pair.t.pool.n_evictions > 0
