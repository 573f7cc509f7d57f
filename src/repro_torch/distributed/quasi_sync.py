"""The paper's quasi-synchronous E/Q scheme lifted to cluster scale (port
of ``repro/distributed/quasi_sync.py``).

Mapping: PE -> worker host; column group -> data-parallel replica group
(which must advance in lockstep for its all-reduce); operand queue Q ->
per-host input prefetch depth; inter-group divergence E -> bounded
gradient staleness with a parameter-version ring of E+1 versions (the
paper's weight buffer); zero-value filtering -> skipping empty or padded
microbatches at cost 0.

Because the scheduling semantics are the same, the cluster utilization
model reuses the cycle-accurate MAC-array simulator
(:mod:`repro_torch.core.array_sim`) with per-(worker, group, round)
compute times in millisecond ticks.  The round times are drawn with
numpy's ``default_rng(seed)``, as the reference draws them, so both
packages simulate the same fleet.

:class:`BoundedStalenessTrainer` is the real-gradient counterpart: group
gradients computed against params up to E versions stale are applied
through the version ring.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.array_sim import ArrayConfig, SimResult, simulate
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    workers_per_group: int = 8     # hosts that lockstep inside one DP group
    n_groups: int = 32             # DP replica groups
    E: int = 3                     # staleness bound (param versions kept: E+1)
    Q: int = 2                     # per-host input prefetch depth
    straggler_sigma: float = 0.3   # lognormal sigma of per-round host time
    mean_round_ms: float = 100.0
    zero_skip_fraction: float = 0.0  # padded/empty microbatches (cost 0)


def sample_round_times(cfg: ClusterConfig, n_rounds: int, seed: int = 0
                       ) -> np.ndarray:
    """(workers, groups, rounds) integer ms ticks with heavy-tail
    stragglers."""
    rng = np.random.default_rng(seed)
    t = rng.lognormal(mean=0.0, sigma=cfg.straggler_sigma,
                      size=(cfg.workers_per_group, cfg.n_groups, n_rounds))
    t = np.maximum((t * cfg.mean_round_ms).astype(np.int32), 1)
    if cfg.zero_skip_fraction > 0:
        skip = rng.random(t.shape) < cfg.zero_skip_fraction
        t = np.where(skip, 0, t)
    return t


def cluster_utilization(cfg: ClusterConfig, n_rounds: int = 200,
                        seed: int = 0) -> SimResult:
    """Worker utilization of the fleet under the quasi-sync schedule."""
    times = sample_round_times(cfg, n_rounds, seed)
    sim_cfg = ArrayConfig(rows=cfg.workers_per_group, cols=cfg.n_groups,
                          E=cfg.E, Q=cfg.Q)
    return simulate(times, sim_cfg)


def _storages(tree) -> set:
    return {t.untyped_storage().data_ptr() for t in leaves(tree)
            if isinstance(t, torch.Tensor) and t.numel()}


class BoundedStalenessTrainer:
    """Applies group gradients computed on params up to E versions stale.

    The param-version ring (``history``, at most E+1 versions, the newest
    last) is the cluster analogue of the paper's weight buffer; a gradient
    computed on a version ``lag`` steps old is applied with weight
    1/(1+lag) (stale-gradient damping).  Each step draws the groups' lags
    with numpy's ``default_rng(seed)`` as the reference does.

    ``grad_fn(params, batch) -> grads`` reads a version and must not
    change it.  ``update_fn(params, grads) -> new params`` gets the newest
    version and may update it in place (as ``train/optimizer.py::
    apply_updates`` does): the trainer hands it a copy, so the version in
    the ring keeps its values, and every version owns its storage.  An
    ``update_fn`` that returns a tree sharing storage with a version in
    the ring raises.  The weighted gradient sum is accumulated one group
    at a time in the reference's order (``w_0·g_0 + w_1·g_1 + ...``, then
    ``/ sum(w)``), in float32 as ``train_loop.make_train_step`` sums its
    micro-batches, so only one group's gradients are held beside the sum;
    ``update_fn`` gets the float32 average.
    """

    def __init__(self, grad_fn: Callable, update_fn: Callable, params,
                 E: int = 3, seed: int = 0, n_groups: int = 4):
        self.grad_fn = grad_fn
        self.update_fn = update_fn
        self.E = E
        self.n_groups = n_groups
        self.history = collections.deque([params], maxlen=E + 1)
        self.rng = np.random.default_rng(seed)
        self.step_count = 0
        #: the lags the last step applied, one per group
        self.last_lags: Optional[np.ndarray] = None

    @property
    def params(self):
        return self.history[-1]

    def step(self, group_batches, lags: Optional[np.ndarray] = None):
        """One global step: every group contributes a (possibly stale)
        gradient.  ``lags`` overrides the draw (no number is drawn then).
        Returns the new params, which the ring now holds newest."""
        if len(group_batches) != self.n_groups:
            raise ValueError(f"{len(group_batches)} batches for "
                             f"{self.n_groups} groups")
        if lags is None:
            lags = self.rng.integers(
                0, min(self.E, len(self.history) - 1) + 1,
                size=self.n_groups)
        used = []
        avg, wsum = None, 0.0
        for g, batch in enumerate(group_batches):
            lag = int(min(lags[g], len(self.history) - 1))
            used.append(lag)
            w = 1.0 / (1.0 + lag)
            grads = self.grad_fn(self.history[-1 - lag], batch)
            if avg is None:
                avg = tree_map(lambda x: w * _f32(x), grads)
            else:
                avg = tree_map(lambda a, x: a + w * _f32(x), avg, grads)
            del grads
            wsum += w
        avg = tree_map(lambda a: a / wsum, avg)
        newest = tree_map(_own_copy, self.params)
        new_params = self.update_fn(newest, avg)
        shared = _storages(new_params) & set().union(
            *(_storages(v) for v in self.history))
        if shared:
            raise ValueError("update_fn returned params that share storage "
                             "with a version in the ring; each version "
                             "must own its storage")
        self.history.append(new_params)
        self.step_count += 1
        self.last_lags = np.asarray(used)
        return new_params


def _f32(x):
    return x.to(torch.float32) if x.is_floating_point() else x


def _own_copy(x):
    """A detached copy with its own storage (no autograd history ties the
    new version to the old one)."""
    return x.detach().clone() if isinstance(x, torch.Tensor) else x
