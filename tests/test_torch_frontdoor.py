"""The HTTP/SSE front door, its router and the streaming serve loop in the
PyTorch port, against the JAX package (the contracts of
``test_frontdoor.py``).

  * Streaming loop: ``submit``/``close``/``run_forever`` give a batch
    serve's tokens, ``on_token`` sends each position once (across a
    preemption's replay too), a closed loop refuses work, a crashed
    replica worker surfaces its error.
  * Router: the reference's policy contracts on fake replicas, and the
    port's ``Router.pick`` equal to the reference ``Router``'s on one
    sequence of fake-replica stats, for all four policies.
  * HTTP over real TCP on ``127.0.0.1:0``: healthz and stats, tokens
    (plain and streamed) equal to a direct serve of the port and to the
    JAX engine's serve of the same prompts (run in a subprocess,
    ``torch_parity.run_reference``), 4xx for bad requests, a disconnect
    that cancels its request and frees every block, the shared-engine
    refusal, the request records, a probed replica's cost hint on
    ``/v1/stats``, and sixteen concurrent clients on two replicas under a
    10 µs thread switch interval.
"""

import sys
import threading
import time

import numpy as np
import pytest

import torch_parity as tp
from repro.serving.frontdoor.router import Router as JaxRouter
from repro_torch import serving as ts
from repro_torch.configs.base import get_arch
from repro_torch.models.layers import quantize_dense_params
from repro_torch.serving.telemetry import STEP_SCHEMA

CACHE_T = 96
#: the prompts of the token-identity test: four of 15 tokens
DOOR_PROMPTS = [tp.tokens(i, (15,)) for i in range(4)]


def _cfg(get, **kw):
    return get("qwen2-1.5b").reduced().replace(**tp.SMALL, **kw)


def _engine(pkg, cfg, params, *, backend="slab", prefill_chunk=None,
            max_new=6, engine_kw=None, **kw):
    return pkg.ServingEngine(cfg, params, pkg.ServeConfig(
        max_new_tokens=max_new, temperature=0.0, cache_backend=backend,
        block_size=4, prefill_chunk=prefill_chunk, **kw),
        **(engine_kw or {}))


def _direct(pkg, cfg, params, engine_kw=None):
    """A direct serve of the door's prompts, 5 new tokens each."""
    eng = _engine(pkg, cfg, params, max_new=5, engine_kw=engine_kw)
    rep = eng.serve([pkg.Request(prompt=p.copy(), max_new_tokens=5)
                     for p in DOOR_PROMPTS], n_slots=2, cache_T=CACHE_T)
    return [np.asarray(r.tokens).tolist() for r in rep.results]


def write_reference(out_dir: str) -> None:
    """The JAX engine's direct serve of the door's prompts (subprocess)."""
    import jax
    from repro import serving as jserving
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import api as japi

    cfg = _cfg(jax_get_arch)
    params = japi.init(jax.random.PRNGKey(0), cfg)
    tp.save_reference(out_dir, {"direct": _direct(jserving, cfg, params)},
                      params)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference("test_torch_frontdoor",
                            tmp_path_factory.mktemp("jax_door_reference"))


CFG = _cfg(get_arch)


def _port_engine(reference, **kw):
    return _engine(ts, CFG, reference["params"], engine_kw={"device": "cpu"},
                   **kw)


def _tokens(report):
    return [r.tokens.tolist() for r in report.results]


# ---------------------------------------------------------------------------
# streaming serve loop
# ---------------------------------------------------------------------------


class TestStreamingLoop:
    def test_submit_close_matches_batch_run(self, reference):
        prompts = [tp.tokens(10 + i, (7,)) for i in range(4)]
        want = _tokens(_port_engine(reference).serve(
            [ts.Request(prompt=p, max_new_tokens=6) for p in prompts],
            n_slots=2, cache_T=64))
        loop = _port_engine(reference).make_loop([], n_slots=2, cache_T=64)
        for p in prompts:
            loop.submit(ts.Request(prompt=p, max_new_tokens=6))
        loop.close()
        report = loop.run_forever(poll_s=0.0)
        assert _tokens(report) == want

    @pytest.mark.parametrize("backend,num_blocks", [("slab", None),
                                                    ("paged", 9)])
    def test_on_token_streams_each_position_once(self, reference, backend,
                                                 num_blocks):
        # the 9-block paged pool preempts: replayed tokens are not resent
        loop = _port_engine(reference, backend=backend, max_new=8).make_loop(
            [], n_slots=3, cache_T=24, num_blocks=num_blocks)
        seen = {}
        loop.on_token = lambda req, tok, i: (
            seen.setdefault(req.request_id, []).append((i, tok)))
        reqs = [ts.Request(prompt=tp.tokens(20 + i, (8,)), max_new_tokens=8)
                for i in range(3)]
        for r in reqs:
            loop.submit(r)
        loop.close()
        report = loop.run_forever(poll_s=0.0)
        if num_blocks is not None:
            assert report.n_preemptions > 0
        for r in reqs:
            assert [t for _, t in seen[r.request_id]] == r.tokens
            assert [i for i, _ in seen[r.request_id]] == list(
                range(len(r.tokens)))

    def test_on_token_skips_the_replay_after_a_recovery(self, reference):
        inj = ts.FaultInjector(schedule=[("step", 3)])
        loop = _port_engine(reference, faults=inj, max_step_retries=0
                            ).make_loop([], n_slots=2, cache_T=64)
        seen = {}
        loop.on_token = lambda req, tok, i: (
            seen.setdefault(req.request_id, []).append(i))
        reqs = [ts.Request(prompt=tp.tokens(30 + i, (7,)), max_new_tokens=6)
                for i in range(2)]
        for r in reqs:
            loop.submit(r)
        loop.close()
        report = loop.run_forever(poll_s=0.0)
        assert report.n_recoveries == 1
        for r in reqs:
            assert seen[r.request_id] == list(range(6))

    def test_submit_after_close_raises(self, reference):
        loop = _port_engine(reference).make_loop([], n_slots=2, cache_T=64)
        loop.close()
        with pytest.raises(RuntimeError, match="closed"):
            loop.submit(ts.Request(prompt=tp.tokens(1, (4,))))

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_replica_worker_crash_surfaces_error(self, reference):
        """A dead worker must not strand its clients: orphaned in-flight
        handles get on_finish (with a non-terminal request, which is the
        tell), and submit/close re-raise instead of hanging."""
        rep = ts.Replica(_port_engine(reference), name="boom", n_slots=2,
                         cache_T=64)

        def _explode():
            raise ZeroDivisionError("boom")

        rep.loop._step = _explode
        finished = []
        rep.start()
        rep.submit(ts.Request(prompt=tp.tokens(1, (6,)), max_new_tokens=4),
                   on_finish=finished.append)
        rep._thread.join(timeout=30)
        assert isinstance(rep.error, ZeroDivisionError)
        assert len(finished) == 1 and not finished[0].is_terminal
        with pytest.raises(RuntimeError, match="worker died"):
            rep.submit(ts.Request(prompt=tp.tokens(1, (6,)),
                                  max_new_tokens=4))
        with pytest.raises(RuntimeError, match="worker died"):
            rep.close()


# ---------------------------------------------------------------------------
# router (pure policy, fake replicas)
# ---------------------------------------------------------------------------


class _FakeReplica:
    def __init__(self, name, depth=0, cost=0.0, block_size=4):
        self.name = name
        self.depth = depth
        self.cost = cost
        self.block_size = block_size

    def stats(self):
        return {"name": self.name, "queue_depth": self.depth,
                "cost_hint_cycles_per_token": self.cost}


class TestRouter:
    def test_affinity_same_prefix_same_replica(self):
        reps = [_FakeReplica("a"), _FakeReplica("b"), _FakeReplica("c")]
        router = ts.Router(reps, policy="affinity", affinity_blocks=2)
        sys_prompt = tp.tokens(7, (8,))
        picks = {router.pick(np.concatenate([sys_prompt,
                                             tp.tokens(i, (5,))]))
                 for i in range(10)}
        assert len(picks) == 1

    def test_affinity_spills_on_imbalance_without_rehoming(self):
        reps = [_FakeReplica("a"), _FakeReplica("b")]
        router = ts.Router(reps, policy="affinity", max_imbalance=2)
        p = tp.tokens(3, (12,))
        home = router.pick(p)
        home.depth = 10                      # home gets swamped
        other = router.pick(p)
        assert other is not home and router.n_spills == 1
        home.depth = 0                       # pressure gone: back home
        assert router.pick(p) is home

    def test_least_loaded_breaks_ties_on_cost_hint(self):
        reps = [_FakeReplica("a", depth=1, cost=9.0),
                _FakeReplica("b", depth=1, cost=2.0),
                _FakeReplica("c", depth=3, cost=0.0)]
        router = ts.Router(reps, policy="least_loaded")
        assert router.pick(tp.tokens(4, (4,))) is reps[1]

    def test_round_robin_cycles(self):
        reps = [_FakeReplica("a"), _FakeReplica("b")]
        router = ts.Router(reps, policy="round_robin")
        assert [router.pick(tp.tokens(4, (4,))).name
                for _ in range(4)] == ["a", "b", "a", "b"]

    def test_unknown_policy_rejected(self):
        with pytest.raises(ValueError, match="policy"):
            ts.Router([_FakeReplica("a")], policy="hash")

    @pytest.mark.parametrize("policy", ts.frontdoor.POLICIES)
    @pytest.mark.parametrize("seed", [0, 1])
    def test_picks_equal_the_reference_router(self, policy, seed):
        """One seeded sequence of prompts (a few shared prefixes) and of
        load changes between picks, on two sets of fake replicas: the
        port's picks must be the reference's, pick for pick."""
        rng = np.random.default_rng(seed)
        heads = [rng.integers(2, 128, 8) for _ in range(3)]
        steps = []
        for _ in range(60):
            head = heads[int(rng.integers(len(heads)))]
            prompt = np.concatenate([head, rng.integers(2, 128, int(
                rng.integers(0, 9)))]).astype(np.int32)
            steps.append((prompt, rng.integers(0, 8, 3).tolist(),
                          rng.choice([0.0, 1.5, 2.5], 3).tolist()))
        picks = []
        for cls in (ts.Router, JaxRouter):
            reps = [_FakeReplica(n) for n in ("r0", "r1", "r2")]
            router = cls(reps, policy=policy, affinity_blocks=2,
                         max_imbalance=3, max_keys=2, seed=seed)
            out = []
            for prompt, depths, costs in steps:
                for r, d, c in zip(reps, depths, costs):
                    r.depth, r.cost = d, c
                out.append(router.pick(prompt).name)
            picks.append((out, router.n_spills, router.stats()))
        assert picks[0] == picks[1]


# ---------------------------------------------------------------------------
# HTTP front door (real TCP)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def door(reference):
    replicas = [ts.Replica(_port_engine(reference, backend="paged",
                                        prefill_chunk=6, max_new=24),
                           name=f"r{i}", n_slots=2, cache_T=CACHE_T)
                for i in range(2)]
    fd = ts.FrontDoor(replicas, policy="affinity", affinity_blocks=1).start()
    yield fd, ts.FrontDoorClient("127.0.0.1", fd.port)
    fd.stop()


def _wait_idle(replica, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = replica.stats()
        if s["queue_depth"] == 0 and s.get("blocks_in_use", 0) == 0:
            break
        time.sleep(0.02)
    return replica.stats()


class TestFrontDoorHTTP:
    def test_healthz_and_stats(self, door):
        _, client = door
        assert client.healthz() == {"ok": True}
        stats = client.stats()
        assert stats["policy"] == "affinity"
        assert {r["name"] for r in stats["replicas"]} == {"r0", "r1"}
        for r in stats["replicas"]:
            assert r["n_slots"] == 2 and "blocks_in_use" in r

    def test_token_identity_vs_direct_and_reference_serve(self, reference,
                                                          door):
        _, client = door
        want = _direct(ts, CFG, reference["params"],
                       engine_kw={"device": "cpu"})
        assert want == reference["direct"]
        got = [client.generate(p, max_new_tokens=5)["tokens"]
               for p in DOOR_PROMPTS]
        assert got == want
        streamed = [client.generate(p, max_new_tokens=5,
                                    stream=True)["tokens"]
                    for p in DOOR_PROMPTS]
        assert streamed == want

    def test_shared_prefix_lands_on_one_replica(self, door):
        _, client = door
        head = tp.tokens(50, (4,))           # one 4-token affinity block
        names = {client.generate(np.concatenate([head, tp.tokens(
            60 + i, (6,))]), max_new_tokens=2)["replica"] for i in range(4)}
        assert len(names) == 1

    def test_bad_requests_get_4xx(self, door):
        _, client = door
        with pytest.raises(RuntimeError, match="404"):
            client._request_json("GET", "/nope")
        with pytest.raises(RuntimeError, match="400"):
            client._request_json("POST", "/v1/generate", {"prompt": "hi"})
        with pytest.raises(RuntimeError, match="400"):
            client._request_json("POST", "/v1/generate", {"prompt": []})

    def test_disconnect_cancels_and_releases_everything(self, reference):
        replica = ts.Replica(_port_engine(reference, backend="paged",
                                          prefill_chunk=6, max_new=24),
                             name="solo", n_slots=2, cache_T=CACHE_T)
        fd = ts.FrontDoor([replica]).start()
        client = ts.FrontDoorClient("127.0.0.1", fd.port)
        try:
            p = tp.tokens(40, (15,))
            full = client.generate(p, max_new_tokens=24)
            part = client.generate(p, max_new_tokens=24, disconnect_after=2)
            assert part["disconnected"]
            # the partial stream is a PREFIX of the fault-free stream
            assert part["tokens"] == full["tokens"][:len(part["tokens"])]
            assert len(part["tokens"]) < len(full["tokens"])
            s = _wait_idle(replica)
            assert s["queue_depth"] == 0
            assert s["blocks_in_use"] == 0, "disconnect leaked KV blocks"
        finally:
            reports = fd.stop()
        assert reports["solo"].n_cancelled == 1
        cancelled = [r for r in reports["solo"].results
                     if r.finish_reason == "cancelled"]
        assert len(cancelled) == 1

    def test_concurrent_clients_under_a_short_switch_interval(self,
                                                              reference):
        """Sixteen client threads on two replicas while the interpreter
        switches threads every 10 µs: a lost update in the loops' inboxes,
        the replicas' handle maps or the router would lose or mix a
        stream."""
        prompts = [tp.tokens(90 + i, (6,)) for i in range(16)]
        want = _tokens(_port_engine(reference, max_new=4).serve(
            [ts.Request(prompt=p.copy(), max_new_tokens=4) for p in prompts],
            n_slots=2, cache_T=32))
        replicas = [ts.Replica(_port_engine(reference, max_new=4),
                               name=f"s{i}", n_slots=2, cache_T=32)
                    for i in range(2)]
        fd = ts.FrontDoor(replicas, policy="round_robin").start()
        client = ts.FrontDoorClient("127.0.0.1", fd.port)
        got = [None] * len(prompts)

        def one(i):
            got[i] = client.generate(prompts[i], max_new_tokens=4,
                                     stream=bool(i % 2))["tokens"]

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(interval)
            reports = fd.stop()
        assert got == want
        assert sorted(len(r.results) for r in reports.values()) == [8, 8]

    def test_two_replicas_share_one_engine_rejected(self, reference):
        eng = _port_engine(reference)
        with pytest.raises(ValueError, match="engine"):
            ts.FrontDoor([ts.Replica(eng, name="a", cache_T=32),
                          ts.Replica(eng, name="b", cache_T=32)])

    def test_request_records_behind_the_door(self, reference):
        replica = ts.Replica(_port_engine(reference), name="rec", n_slots=2,
                             cache_T=64)
        fd = ts.FrontDoor([replica]).start()
        client = ts.FrontDoorClient("127.0.0.1", fd.port)
        try:
            for i in range(3):
                client.generate(tp.tokens(70 + i, (9,)), max_new_tokens=6,
                                stream=bool(i % 2),
                                slo_class="interactive" if i else "batch")
        finally:
            reports = fd.stop()
        recs = [r for r in replica.loop.stream if r["kind"] == "request"]
        assert len(recs) == 3
        for r in recs:
            assert STEP_SCHEMA["request"] <= set(r)
            assert r["finish_reason"] == "length" and r["n_tokens"] == 6
            assert r["queue_wait_s"] >= 0.0 and r["ttft_wall_s"] > 0.0
            assert len(r["itl_wall_s"]) == 5
        assert set(reports["rec"].slo_classes) == {"interactive", "batch"}

    def test_cost_hint_from_the_probe_on_stats(self, reference):
        cfg = CFG.replace(matmul_mode="bp_exact", kv_cache_int8=True)
        engine = ts.ServingEngine(
            cfg, quantize_dense_params(reference["params"]),
            ts.ServeConfig(max_new_tokens=6, temperature=0.0,
                           probe=ts.SparsityProbe(probe_every=2, n_mc=2000)),
            device="cpu")
        replica = ts.Replica(engine, name="probed", n_slots=2, cache_T=64)
        fd = ts.FrontDoor([replica]).start()
        client = ts.FrontDoorClient("127.0.0.1", fd.port)
        try:
            before = client.stats()["replicas"][0]
            assert before["cost_hint_cycles_per_token"] == 0.0
            client.generate(tp.tokens(80, (6,)), max_new_tokens=6)
            after = client.stats()["replicas"][0]
        finally:
            fd.stop()
        assert after["cost_hint_cycles_per_token"] > 0.0
        assert after["cost_hint_cycles_per_token"] == (
            replica.loop.cost_hint_cycles_per_token)
