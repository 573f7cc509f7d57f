"""The bounded-staleness (quasi-sync) trainer and the cluster utilization
model in the PyTorch port (``repro_torch.distributed.quasi_sync``) against
the JAX package's.

  * ``sample_round_times`` and every ``SimResult`` field of
    ``cluster_utilization`` equal to the reference's, exactly, on
    ``test_substrate.py``'s configs (E/Q 0/0 and 3/2) and with
    ``zero_skip_fraction`` 0.5: both draw with numpy's ``default_rng``.
  * The staleness trainer's 120-step quadratic trajectory (the reference
    test's) within 1e-6 of the reference's, with the same lags.
  * The version ring: E+1 versions, each with its own storage; a stale
    version unchanged after an in-place ``update_fn``; an ``update_fn``
    that aliases a version raises.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import quasi_sync as jqs
from repro_torch.distributed import quasi_sync as tqs

CONFIGS = {
    "E0Q0": dict(workers_per_group=4, n_groups=8, E=0, Q=0,
                 straggler_sigma=0.4, mean_round_ms=20),
    "E3Q2": dict(workers_per_group=4, n_groups=8, E=3, Q=2,
                 straggler_sigma=0.4, mean_round_ms=20),
    "skip0.5": dict(workers_per_group=2, n_groups=4, E=3, Q=2,
                    zero_skip_fraction=0.5, mean_round_ms=10),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cluster_utilization_equals_reference(name):
    kw = CONFIGS[name]
    for seed in (0, 3):
        want_t = jqs.sample_round_times(jqs.ClusterConfig(**kw), 60, seed)
        got_t = tqs.sample_round_times(tqs.ClusterConfig(**kw), 60, seed)
        np.testing.assert_array_equal(got_t, want_t)
        want = jqs.cluster_utilization(jqs.ClusterConfig(**kw), 60, seed)
        got = tqs.cluster_utilization(tqs.ClusterConfig(**kw), 60, seed)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tqs.ClusterConfig()) == \
        dataclasses.asdict(jqs.ClusterConfig())


TARGET = [1.0, -2.0, 3.0]


def test_staleness_trajectory_equals_reference():
    """The reference test's quadratic, 120 steps, E 3, 4 groups: the
    port's params after every step within 1e-6 of the reference's, the
    lags drawn alike."""
    jt = jnp.asarray(TARGET)
    tt = torch.tensor(TARGET)
    jtr = jqs.BoundedStalenessTrainer(
        lambda p, b: {"w": 2 * (p["w"] - jt)},
        lambda p, g: {"w": p["w"] - 0.05 * g["w"]},
        {"w": jnp.zeros(3)}, E=3, n_groups=4, seed=0)
    ttr = tqs.BoundedStalenessTrainer(
        lambda p, b: {"w": 2 * (p["w"] - tt)},
        lambda p, g: {"w": p["w"] - 0.05 * g["w"]},
        {"w": torch.zeros(3)}, E=3, n_groups=4, seed=0)
    worst = 0.0
    lag_sets = set()
    for _ in range(120):
        jtr.step([None] * 4)
        ttr.step([None] * 4)
        lag_sets.add(tuple(ttr.last_lags))
        worst = max(worst, float(np.abs(
            ttr.params["w"].numpy() - np.asarray(jtr.params["w"])).max()))
    assert worst <= 1e-6, worst
    assert len(lag_sets) > 4          # the lags did vary
    assert float((ttr.params["w"] - tt).abs().max()) < 1e-2
    assert len(ttr.history) == len(jtr.history) == 4


def test_forced_lags_pick_versions():
    """Lags given explicitly: each group's gradient is taken on the
    version its lag names, and the weights are 1/(1+lag)."""
    seen = []

    def grad_fn(p, batch):
        seen.append(float(p["w"][0]))
        return {"w": torch.ones(1)}

    tr = tqs.BoundedStalenessTrainer(grad_fn, lambda p, g: {
        "w": p["w"] + 1.0}, {"w": torch.zeros(1)}, E=2, n_groups=2)
    for _ in range(3):
        tr.step([None, None], lags=np.zeros(2, int))
    assert [float(v["w"][0]) for v in tr.history] == [1.0, 2.0, 3.0]
    seen.clear()
    tr.step([None, None], lags=np.asarray([2, 1]))
    assert seen == [1.0, 2.0]
    assert list(tr.last_lags) == [2, 1]


def test_version_ring_depth_and_storage():
    """E+1 versions, each owning its storage, and a stale version kept
    as it was although ``update_fn`` updates its argument in place (as
    ``apply_updates`` does)."""
    def update_in_place(p, g):
        p["w"].sub_(0.1 * g["w"])
        return p

    tr = tqs.BoundedStalenessTrainer(
        lambda p, b: {"w": torch.ones(8)}, update_in_place,
        {"w": torch.zeros(8)}, E=2, n_groups=2, seed=1)
    for _ in range(10):
        tr.step([None, None])
    assert len(tr.history) == 3
    ptrs = {v["w"].data_ptr() for v in tr.history}
    assert len(ptrs) == 3
    olds = [v["w"].clone() for v in tr.history]
    tr.step([None, None])
    for old, v in zip(olds[1:], list(tr.history)[:-1]):
        assert torch.equal(old, v["w"])
    assert not torch.equal(tr.history[-1]["w"], olds[-1])


def test_aliasing_update_fn_raises():
    keep = {}

    def aliasing(p, g):
        return keep.setdefault("v", p)     # hands back an older version

    tr = tqs.BoundedStalenessTrainer(
        lambda p, b: {"w": torch.ones(2)}, aliasing, {"w": torch.zeros(2)},
        E=1, n_groups=1)
    tr.step([None])
    with pytest.raises(ValueError, match="share storage"):
        tr.step([None])
    with pytest.raises(ValueError, match="batches"):
        tr.step([None, None])
