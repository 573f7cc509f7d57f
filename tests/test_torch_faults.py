"""Fault injection and the recovery ladder in the PyTorch port, against the
JAX package (the contracts of ``test_faults.py``).

  * ``NULL_INJECTOR`` is a strict no-op: tokens equal a fault-free serve's,
    no fault record.
  * Seeded chaos on the slab and paged stores, with and without prompt
    lookup (seeds 0 and 1): every request that finishes normally has the
    fault-free serve's tokens, a partial stream is a prefix of them, the
    paged pool drains, and every injection is in the stream as a ``fault``
    record.  The same seeded injector on the JAX engine (run in a
    subprocess, ``torch_parity.run_reference``) fires the same faults:
    the same ``injected`` list of (site, check index), the same counts of
    ``fault`` / ``retry`` / ``recover`` / ``degrade`` / ``cancel``
    records, the same finish reasons and survivor tokens.  The model
    drafter is left out: the reference's counters there are not
    deterministic (ROADMAP Queue 3).
  * The ladder: bounded retry, rebuild-and-replay, an exhausted recovery
    budget failing every request and returning, the watchdog (one worker
    per serve, and a step it abandoned writing only into the old store), a
    real executor failure recovered as a ``StepFault``, the NaN guard
    failing only its slot, the drafter rung, the kernel rung (injected
    faults move one serve to the plain versions, the engine keeps its
    backend), a real kernel failure raising out of the serve, pool
    pressure.
  * The injector itself: schedule and ledger, the fault cap, cancellation
    dedup, the null injector's lack of side effects, and seeded replay,
    against the reference's ``FaultInjector`` too.
"""

import collections
import threading
import time

import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.serving.faults import FaultInjector as JaxInjector
from repro_torch import serving as ts
from repro_torch.configs.base import get_arch
from repro_torch.kernels.build import KernelError

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

#: (prompt length, prompt seed, max new tokens, arrival): test_faults.py's
#: stream; requests 0 and 1 share a prompt (prefix hits on the paged store)
SPEC = ((6, 1, 8, 0.0), (6, 1, 5, 0.0), (4, 2, 7, 1.0), (5, 3, 6, 2.0),
        (7, 4, 8, 4.0))
KINDS = ("fault", "retry", "recover", "degrade", "cancel")
CHAOS = [(b, d, seed) for seed in (0, 1) for b in ("slab", "paged")
         for d in ("none", "prompt_lookup")]


def _cfg(get):
    return get("qwen2-1.5b").reduced().replace(**tp.SMALL)


def _requests(pkg):
    return [pkg.Request(prompt=tp.tokens(seed, (S,)), max_new_tokens=m,
                        arrival_time=t, request_id=i)
            for i, (S, seed, m, t) in enumerate(SPEC)]


def _chaos_rates(backend, draft):
    rates = {"step": 0.05, "prefill": 0.05, "oom": 0.03, "nan": 0.01,
             "cancel": 0.01}
    if backend == "paged":
        rates["pool"] = 0.05
    if draft != "none":
        rates["drafter"] = 0.10
    return rates


def _loop(pkg, cfg, params, backend="slab", draft="none", faults=None,
          num_blocks=None, lead_window=2, engine_kw=None, **over):
    kw = dict(max_new_tokens=8, temperature=0.0, cache_backend=backend,
              block_size=4, draft=draft, num_draft_tokens=3, faults=faults)
    kw.update(over)
    engine = pkg.ServingEngine(cfg, params, pkg.ServeConfig(**kw),
                               **(engine_kw or {}))
    return engine.make_loop(_requests(pkg), n_slots=2, num_blocks=num_blocks,
                            sched_cfg=pkg.SchedulerConfig(
                                lead_window=lead_window))


def _chaos_loop(pkg, cfg, params, backend, draft, seed, **kw):
    inj = pkg.FaultInjector(seed=seed, rates=_chaos_rates(backend, draft),
                            max_faults=8)
    return _loop(pkg, cfg, params, backend, draft, inj, max_step_retries=1,
                 max_recoveries=20, **kw), inj


def _summary(loop, report, inj=None) -> dict:
    kinds = collections.Counter(r["kind"] for r in loop.stream)
    return {"tokens": [np.asarray(r.tokens).tolist() for r in report.results],
            "finish": [r.finish_reason for r in report.results],
            "injected": ([] if inj is None
                         else [[s, int(n)] for s, n, _ in inj.injected]),
            "kinds": {k: kinds.get(k, 0) for k in KINDS}}


def write_reference(out_dir: str) -> None:
    """Fault-free and chaos serves on the JAX engine (in the subprocess)."""
    import jax
    from repro import serving as jserving
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import api as japi

    cfg = _cfg(jax_get_arch)
    params = japi.init(jax.random.PRNGKey(0), cfg)
    out = {"base": {}, "chaos": {}}
    for backend in ("slab", "paged"):
        for draft in ("none", "prompt_lookup"):
            loop = _loop(jserving, cfg, params, backend, draft)
            out["base"][f"{backend}-{draft}"] = _summary(loop, loop.run())
    for backend, draft, seed in CHAOS:
        loop, inj = _chaos_loop(jserving, cfg, params, backend, draft, seed)
        out["chaos"][f"{backend}-{draft}-{seed}"] = _summary(
            loop, loop.run(), inj)
    tp.save_reference(out_dir, out, params)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference("test_torch_faults",
                            tmp_path_factory.mktemp("jax_faults_reference"))


CFG = _cfg(get_arch)


def _port_loop(reference, *a, **kw):
    return _loop(ts, CFG, reference["params"], *a,
                 engine_kw={"device": "cpu"}, **kw)


def _port_serve(reference, *a, **kw):
    loop = _port_loop(reference, *a, **kw)
    return loop.run(), loop


_BASELINES = {}


def _baseline(reference, backend="slab", draft="none"):
    """The port's fault-free tokens, one serve per (store, drafter)."""
    key = (backend, draft)
    if key not in _BASELINES:
        rep, _ = _port_serve(reference, backend, draft)
        _BASELINES[key] = [r.tokens.tolist() for r in rep.results]
    return _BASELINES[key]


def _tokens(report):
    return [r.tokens.tolist() for r in report.results]


def _assert_pool_drained(loop):
    """After the queue drains the paged pool holds no live block, its free
    and cached blocks cover all but the trash block, no refcount is left."""
    if not loop.paged:
        return
    pool = loop.cm.pool
    assert pool.n_live == 0
    assert pool.n_free == pool.num_blocks - 1
    assert int(pool.refcount.sum()) == 0


def _assert_survivors(report, base):
    for i, res in enumerate(report.results):
        toks = res.tokens.tolist()
        if res.finish_reason in ("eos", "length"):
            assert toks == base[i], (i, res.finish_reason)
        else:
            assert res.finish_reason in ("cancelled", "failed", "timeout")
            # a partial stream never parts from the fault-free one
            assert toks == base[i][:len(toks)]


_CHAOS = {}


def _port_chaos(reference, backend, draft, seed):
    key = (backend, draft, seed)
    if key not in _CHAOS:
        loop, inj = _chaos_loop(ts, CFG, reference["params"], backend, draft,
                                seed, engine_kw={"device": "cpu"})
        _CHAOS[key] = (loop.run(), loop, inj)
    return _CHAOS[key]


# ---------------------------------------------------------------------------
# the null injector, and the fault-free streams against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,draft",
                         [("slab", "none"), ("paged", "prompt_lookup")])
def test_null_injector_strict_noop(reference, backend, draft):
    report, loop = _port_serve(reference, backend, draft,
                               faults=ts.NULL_INJECTOR)
    assert _tokens(report) == _baseline(reference, backend, draft)
    assert not [r for r in loop.stream if r["kind"] == "fault"]
    assert report.n_injected_faults == 0 and report.n_recoveries == 0


@pytest.mark.parametrize("backend", ["slab", "paged"])
@pytest.mark.parametrize("draft", ["none", "prompt_lookup"])
def test_fault_free_serve_matches_reference(reference, backend, draft):
    want = reference["base"][f"{backend}-{draft}"]
    rep, loop = _port_serve(reference, backend, draft)
    assert _summary(loop, rep) == want


# ---------------------------------------------------------------------------
# seeded chaos: survivors token-identical, the pool leak-free, every
# injection in the stream, and the reference's schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,draft,seed", CHAOS)
def test_chaos_survivors_token_identical(reference, backend, draft, seed):
    report, loop, inj = _port_chaos(reference, backend, draft, seed)
    assert all(r.is_terminal for r in loop.requests)
    _assert_survivors(report, _baseline(reference, backend, draft))
    _assert_pool_drained(loop)
    injected = [r for r in loop.stream
                if r["kind"] == "fault" and r.get("injected")]
    assert len(injected) == len(inj.injected) == report.n_injected_faults
    assert [r["site"] for r in injected] == [s for s, _, _ in inj.injected]


@pytest.mark.parametrize("backend,draft,seed", CHAOS)
def test_chaos_matches_reference(reference, backend, draft, seed):
    want = reference["chaos"][f"{backend}-{draft}-{seed}"]
    report, loop, inj = _port_chaos(reference, backend, draft, seed)
    got = _summary(loop, report, inj)
    assert got["injected"] == want["injected"]
    assert got["kinds"] == want["kinds"]
    assert got["finish"] == want["finish"]
    assert got["tokens"] == want["tokens"]
    assert want["injected"], "the schedule fired no fault"


def test_chaos_same_seed_replays_identically(reference):
    def once():
        inj = ts.FaultInjector(seed=7, rates={"step": 0.1, "nan": 0.02,
                                              "pool": 0.05}, max_faults=6)
        report, _ = _port_serve(reference, "paged", faults=inj,
                                max_step_retries=1, max_recoveries=20)
        return [(site, n) for site, n, _ in inj.injected], _tokens(report)
    assert once() == once()


# ---------------------------------------------------------------------------
# retry / recovery / watchdog
# ---------------------------------------------------------------------------

def test_retry_absorbs_transient_step_faults(reference):
    inj = ts.FaultInjector(schedule=[("step", 0), ("step", 1)])
    report, _ = _port_serve(reference, faults=inj, max_step_retries=2)
    assert _tokens(report) == _baseline(reference)
    assert report.n_retries == 2
    assert report.n_recoveries == 0


def test_recovery_rebuilds_and_replays(reference):
    inj = ts.FaultInjector(schedule=[("step", 1)])
    report, loop = _port_serve(reference, faults=inj, max_step_retries=0)
    assert _tokens(report) == _baseline(reference)
    assert report.n_recoveries == 1
    assert "recover" in [r["kind"] for r in loop.stream]
    # recovery preempted the actives: the replay shows as preempt records
    assert report.n_preemptions >= 1


@pytest.mark.parametrize("backend", ["slab", "paged"])
def test_recovery_budget_exhausted_fails_inflight_and_returns(reference,
                                                              backend):
    inj = ts.FaultInjector(rates={"step": 1.0, "prefill": 1.0})
    report, loop = _port_serve(reference, backend, faults=inj,
                               max_step_retries=0, max_recoveries=2)
    # serve() RETURNED (no hang, no raise) with everything failed
    assert all(r.state is ts.RequestState.FAILED for r in loop.requests)
    assert report.n_failed == len(SPEC)
    assert any(r["kind"] == "degrade" and r["action"] == "abort"
               for r in loop.stream)
    _assert_pool_drained(loop)


def test_watchdog_aborts_stuck_step(reference):
    # the budget covers any tiny step on a loaded CPU; the spike breaks it
    inj = ts.FaultInjector(rates={"slow": 1.0}, max_faults=1, slow_s=4.0)
    report, loop = _port_serve(reference, faults=inj, step_timeout_s=2.0,
                               max_step_retries=0, max_recoveries=20)
    assert report.n_recoveries == 1
    assert _tokens(report) == _baseline(reference)
    timeouts = [r for r in loop.stream if r["kind"] == "fault"
                and "StepTimeout" in r.get("error", "")]
    assert len(timeouts) == 1


@pytest.mark.parametrize("backend", ["slab", "paged"])
def test_abandoned_watchdog_step_never_changes_rebuilt_store(reference,
                                                             backend):
    """A step the watchdog gave up on runs on, and writes its step into the
    store it was handed: the old one.  The store the recovery built, and
    the tokens, stay as a serve without the abandoned step leaves them."""
    slow_s = 6.0
    inj = ts.FaultInjector(rates={"slow": 1.0}, max_faults=1, slow_s=slow_s)
    loop = _port_loop(reference, backend, faults=inj, step_timeout_s=2.0,
                      max_step_retries=0, max_recoveries=20)
    stores = []
    recover = loop.recover

    def keep_old_store(error):
        stores.append((loop.cm, {k: v.clone()
                                 for k, v in loop.cm.cache.items()}))
        recover(error)

    loop.recover = keep_old_store
    t0 = time.monotonic()
    report = loop.run()
    after = {k: v.clone() for k, v in loop.cm.cache.items()}
    workers = [t for t in threading.enumerate()
               if t.name.startswith("serve-watchdog")]
    # the abandoned step is still asleep when the serve has ended
    assert time.monotonic() - t0 < slow_s and workers
    for t in workers:
        t.join(timeout=60)
    assert report.n_recoveries == 1 and len(stores) == 1
    assert _tokens(report) == _baseline(reference, backend)
    old_cm, old_before = stores[0]
    assert old_cm is not loop.cm
    # the abandoned step wrote into the old store ...
    assert any(not torch.equal(old_before[k], v)
               for k, v in old_cm.cache.items())
    # ... and never into the rebuilt one
    for k, v in loop.cm.cache.items():
        assert torch.equal(v, after[k]), k
        assert v.data_ptr() != old_cm.cache[k].data_ptr()


def test_watchdog_keeps_one_worker_per_serve(reference):
    """Without a timeout every dispatch runs on the one worker thread the
    serve made, and the worker ends with the serve."""
    loop = _port_loop(reference, "paged", step_timeout_s=60.0)
    names = []
    real_fn = loop._decode_fn

    def on_worker(*a, **k):
        names.append(threading.current_thread().name)
        return real_fn(*a, **k)

    loop._decode_fn = on_worker
    report = loop.run()
    assert _tokens(report) == _baseline(reference, "paged")
    assert len(names) > 1 and len(set(names)) == 1
    assert names[0].startswith("serve-watchdog")
    assert loop._watchdog is None
    for t in threading.enumerate():
        if t.name == names[0]:
            t.join(timeout=60)
            assert not t.is_alive()


def test_real_executor_failure_recovers_as_step_fault(reference):
    # a genuine (non-injected) executor exception is wrapped and survives
    # through the same rebuild-and-replay path
    loop = _port_loop(reference)
    real_fn = loop._decode_fn
    state = {"fired": False}

    def boom(*a, **k):
        if not state["fired"]:
            state["fired"] = True
            raise ValueError("simulated device failure")
        return real_fn(*a, **k)

    loop._decode_fn = boom
    report = loop.run()
    assert state["fired"]
    assert report.n_recoveries == 1
    assert _tokens(report) == _baseline(reference)
    # the real failure shows as a non-injected fault record
    assert any(r["kind"] == "fault" and not r.get("injected")
               and "ValueError" in r.get("error", "")
               for r in loop.stream)


# ---------------------------------------------------------------------------
# NaN guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["none", "prompt_lookup"])
def test_nan_guard_fails_only_the_poisoned_slot(reference, draft):
    inj = ts.FaultInjector(rates={"nan": 1.0}, max_faults=1)
    report, loop = _port_serve(reference, draft=draft, faults=inj)
    base = _baseline(reference, "slab", draft)
    failed = [r for r in report.results if r.finish_reason == "failed"]
    assert len(failed) == 1
    for i, res in enumerate(report.results):
        toks = res.tokens.tolist()
        assert -1 not in toks
        if res.finish_reason == "failed":
            assert toks == base[i][:len(toks)]
        else:
            assert toks == base[i]
    assert any(r["kind"] == "fault" and r.get("site") == "nan_guard"
               for r in loop.stream)
    assert loop.cm.n_active == 0


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------

def test_repeated_drafter_faults_disable_speculation(reference):
    inj = ts.FaultInjector(rates={"drafter": 1.0})
    report, loop = _port_serve(reference, draft="prompt_lookup", faults=inj)
    # draft-less verify steps commit the single greedy token: identity
    # against the plain baseline (speculation is an optimization only)
    assert _tokens(report) == _baseline(reference)
    assert loop.drafter is None
    assert any(r["kind"] == "degrade"
               and r["action"] == "disable_speculation"
               for r in loop.stream)
    assert report.n_degrades >= 1
    assert report.draft == "prompt_lookup"   # what the run started with


def _kernel_loop(reference, *a, **kw):
    """A port loop whose config asks for the kernels: on the CPU every
    paged decode then fails for real (K2 cannot take CPU tensors)."""
    return _loop(ts, CFG.replace(matmul_backend="kernel"),
                 reference["params"], *a, engine_kw={"device": "cpu"}, **kw)


def test_repeated_kernel_faults_fall_back_to_plain(reference):
    """Two injected prefill faults, no retry: two recoveries, then the rung
    moves this serve's kernels to their plain versions before any of them
    ran, and the serve completes on them.  The switch is the loop's own:
    the engine's executor keeps its backend, so the engine's next serve
    asks for the kernels again, and fails for real."""
    inj = ts.FaultInjector(schedule=[("prefill", 0), ("prefill", 1)])
    loop = _kernel_loop(reference, "paged", faults=inj, max_step_retries=0,
                        kernel_fault_limit=2)
    engine_executor = loop.engine.executor
    assert engine_executor.resolved_matmul_backend == "kernel"
    report = loop.run()
    assert loop.executor is not engine_executor
    assert loop.executor.cfg.matmul_backend == "plain"
    assert loop.executor.resolved_matmul_backend == "plain"
    assert engine_executor.cfg.matmul_backend == "kernel"
    degrades = [r for r in loop.stream if r["kind"] == "degrade"]
    assert [r["action"] for r in degrades] == ["plain_fallback"]
    assert report.n_degrades == 1 and report.n_recoveries == 2
    assert _tokens(report) == _baseline(reference, "paged")
    _assert_pool_drained(loop)
    later = loop.engine.make_loop(_requests(ts), n_slots=2)
    with pytest.raises(KernelError, match="needs CUDA tensors"):
        later.run()
    assert not any(r["kind"] in ("recover", "degrade") for r in later.stream)


@pytest.mark.parametrize("kernel", ["bp_matmul", "paged_attention"])
def test_real_kernel_failure_raises(reference, kernel):
    """A kernel's own failure is never recovered or hidden behind the plain
    versions, whatever the ladder's limits: it raises out of the serve.
    K1 fails on the first projection of a bp_exact prefill, K2 on the
    first paged decode."""
    cfg = CFG.replace(matmul_backend="kernel")
    if kernel == "bp_matmul":
        cfg = cfg.replace(matmul_mode="bp_exact")
    loop = _loop(ts, cfg, reference["params"],
                 "slab" if kernel == "bp_matmul" else "paged",
                 engine_kw={"device": "cpu"}, max_recoveries=20,
                 kernel_fault_limit=1)
    with pytest.raises(KernelError, match="needs CUDA tensors"):
        loop.run()
    assert not any(r["kind"] in ("fault", "recover", "degrade")
                   for r in loop.stream)
    assert loop.n_recoveries == 0
    assert loop.executor.cfg.matmul_backend == "kernel"


def test_kernel_rung_never_fires_on_the_plain_route(reference):
    # on the CPU ``auto`` resolves to the plain versions already
    inj = ts.FaultInjector(schedule=[("step", 0), ("step", 2)])
    report, loop = _port_serve(reference, faults=inj, max_step_retries=0,
                               kernel_fault_limit=2)
    assert report.n_recoveries == 2 and report.n_degrades == 0
    assert loop.engine.executor.cfg.matmul_backend == "auto"
    assert _tokens(report) == _baseline(reference)


def test_pool_pressure_shrinks_lead_window(reference):
    inj = ts.FaultInjector(rates={"pool": 0.6}, seed=3, max_faults=12)
    report, loop = _port_serve(reference, "paged", faults=inj,
                               max_step_retries=1, max_recoveries=20,
                               lead_window=4, pool_pressure_limit=2)
    assert report.n_preemptions >= 2
    assert loop.sched.cfg.lead_window < 4
    assert any(r["kind"] == "degrade"
               and r["action"] == "shrink_lead_window"
               for r in loop.stream)
    assert _tokens(report) == _baseline(reference, "paged")
    _assert_pool_drained(loop)


# ---------------------------------------------------------------------------
# the injector itself
# ---------------------------------------------------------------------------

def test_injector_schedule_and_ledger():
    inj = ts.FaultInjector(schedule=[("step", 1)], rates={})
    assert not inj.fire("step")
    assert inj.fire("step")
    assert not inj.fire("step")
    assert [(s, n) for s, n, _ in inj.injected] == [("step", 1)]


def test_injector_max_faults_cap():
    inj = ts.FaultInjector(rates={"step": 1.0}, max_faults=2)
    fires = [inj.fire("step") for _ in range(5)]
    assert fires == [True, True, False, False, False]


def test_injector_cancel_requests_dedups():
    inj = ts.FaultInjector(rates={"cancel": 1.0})
    assert inj.cancel_requests([1, 2]) == [1, 2]
    assert inj.cancel_requests([1, 2, 3]) == [3]


def test_injector_raises_the_reference_types():
    for site, exc in (("step", ts.TransientStepFault),
                      ("prefill", ts.TransientStepFault),
                      ("oom", ts.DeviceOOM), ("drafter", ts.DrafterFault),
                      ("pool", ts.InjectedFault)):
        with pytest.raises(exc, match=f"injected {site} fault"):
            ts.FaultInjector(rates={site: 1.0}).check(site)


def test_null_injector_has_no_side_effects():
    ledger0 = list(ts.NULL_INJECTOR.injected)
    assert not ts.NULL_INJECTOR.fire("step")
    ts.NULL_INJECTOR.check("oom")
    ts.NULL_INJECTOR.delay()
    assert ts.NULL_INJECTOR.nan_slots([0, 1]) == []
    assert ts.NULL_INJECTOR.cancel_requests([1]) == []
    assert list(ts.NULL_INJECTOR.injected) == ledger0 == []


SITES = ["step", "pool", "nan", "oom", "cancel", "slow"]


@pytest.mark.parametrize("seed", range(6))
def test_injector_fires_as_the_reference_does(seed):
    rng = np.random.default_rng(seed)
    rates = {s: float(rng.uniform(0, 0.5)) for s in SITES[:int(
        rng.integers(1, len(SITES) + 1))]}
    schedule = [(str(rng.choice(SITES)), int(rng.integers(0, 20)))
                for _ in range(3)]
    calls = [str(s) for s in rng.choice(SITES, 200)]
    runs = []
    for cls in (ts.FaultInjector, JaxInjector):
        inj = cls(seed=seed, rates=rates, schedule=schedule, max_faults=30)
        runs.append(([inj.fire(s) for s in calls],
                     [(s, n) for s, n, _ in inj.injected]))
    assert runs[0] == runs[1]


if HAVE_HYPOTHESIS:
    @settings(max_examples=50, deadline=None)
    @given(seed=st.integers(0, 2**16),
           rates=st.dictionaries(
               st.sampled_from(["step", "pool", "nan", "oom"]),
               st.floats(0.0, 1.0), max_size=4),
           n_checks=st.integers(0, 64))
    def test_injector_deterministic_replay(seed, rates, n_checks):
        """A given (seed, rates, call sequence) replays the exact same
        fault schedule."""
        def trace():
            inj = ts.FaultInjector(seed=seed, rates=rates)
            return [inj.fire(site) for site in
                    ["step", "pool", "nan", "oom"] * n_checks]
        assert trace() == trace()
