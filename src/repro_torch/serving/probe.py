"""Hardware-cost probe: measured bit sparsity of live serving traffic folded
through the paper's cost models (port of ``repro/serving/probe.py``;
Tables II-III, the array simulator).

``SparsityProbe`` rides ``ServeConfig -> ServeLoop -> executor`` like
``Telemetry``.  When enabled, the executor runs *probed* variants of the
prefill, decode and verify steps: the model passes a
``core.probe.StatsCollector`` down its layer loop, and the step returns one
small ``(L[+1], N_STATS)`` float32 tensor of activation stats, the only
probe data that leaves the device.  Weight bit sparsity is computed once
per engine from the int8 weights (they never change during a serve).

On the host, ``fold`` prices each sampled step: modeled average cycles per
MAC for bp_exact / bp_approx / adas / bitwave (Monte-Carlo models
interpolated over a lazily built sparsity grid, so a step's cost is a table
lookup), a small seeded quasi-sync array simulation for utilization, and
Table III energy interpolation, emitted as an ``hw_estimate`` record.

The disabled probe (``NULL_PROBE``) runs none of this: the serve calls the
unprobed step functions it called before the probe existed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import array_sim
from repro_torch.core import cost_model as cm
from repro_torch.core.probe import probe_supported
from repro_torch.core.sparsity import N_STATS, per_layer_counts, sm_bit_counts

__all__ = ["NULL_PROBE", "PROBE_METHODS", "SparsityProbe", "int8_leaves",
           "per_layer_weight_stats", "probe_supported"]

PROBE_METHODS = ("bp_exact", "bp_approx", "adas", "bitwave")

# Interpolation grid for the Monte-Carlo cycle models.  Live traffic sits
# well off Table III's 0.5-0.9 ladder (random-init weights measure ~0.6,
# near-zero activations ~0.9+), so the grid spans wider.
_GRID = (0.2, 0.35, 0.5, 0.65, 0.8, 0.95)


def _rates(stats: np.ndarray):
    """(bit_sparsity, value_sparsity) from summed stat rows (numpy)."""
    stats = np.asarray(stats, np.float64)
    n = max(float(stats[..., 1].sum() if stats.ndim > 1 else stats[1]), 1.0)
    if stats.ndim > 1:
        return (float(stats[:, 0].sum() / (7.0 * n)),
                float(stats[:, 2].sum() / n))
    return float(stats[0] / (7.0 * n)), float(stats[2] / n)


def _row_rates(stats: np.ndarray):
    """Per-row (bit_sparsity, value_sparsity) lists from an (R, N_STATS)."""
    stats = np.asarray(stats, np.float64)
    n = np.maximum(stats[:, 1], 1.0)
    return ((stats[:, 0] / (7.0 * n)).tolist(), (stats[:, 2] / n).tolist())


def int8_leaves(params, path=()):
    """(path, tensor) of every int8 leaf of a nested-dict param tree."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from int8_leaves(v, path + (str(k),))
    elif isinstance(params, torch.Tensor) and params.dtype == torch.int8:
        yield path, params


def per_layer_weight_stats(params, n_layers: int):
    """``(n_layers, N_STATS)`` float64 weight stats and an optional
    unstacked tail row.

    Walks the quantized param tree once: int8 leaves under the layer-stacked
    ``layers`` subtree contribute per-layer rows; unstacked int8 leaves (an
    untied lm head) sum into the tail.  Returns ``(stacked, tail)`` with
    ``tail is None`` when no unstacked int8 leaf exists.  The sums are
    exact integers."""
    stacked = np.zeros((n_layers, N_STATS), np.int64)
    tail = np.zeros((N_STATS,), np.int64)
    has_tail = False
    for path, leaf in int8_leaves(params):
        if "layers" in path and leaf.ndim >= 3 and leaf.shape[0] == n_layers:
            stacked += per_layer_counts(leaf).cpu().numpy()
        else:
            tail += sm_bit_counts(leaf).cpu().numpy()
            has_tail = True
    return (stacked.astype(np.float64),
            tail.astype(np.float64) if has_tail else None)


class _CycleModel:
    """Lazily built interpolation tables over the Monte-Carlo cycle models.

    bp_exact / bp_approx depend on both factors' bit sparsity -> a 2D grid
    (activation x weight, bilinear).  adas (bit_serial) and bitwave are
    single-factor (the activation) -> a 1D grid."""

    def __init__(self, n_mc: int = 20_000, seed: int = 0):
        self.n_mc = n_mc
        self.seed = seed
        self._tables: Dict[str, np.ndarray] = {}

    def _table(self, method: str) -> np.ndarray:
        tab = self._tables.get(method)
        if tab is None:
            if method in ("bp_exact", "bp_approx"):
                tab = np.array(
                    [[cm.modeled_avg_cycles_dual(method, a, w, n=self.n_mc,
                                                 seed=self.seed)
                      for a in _GRID] for w in _GRID])
            else:
                m = "bit_serial" if method == "adas" else method
                tab = np.array([cm.modeled_avg_cycles(m, a, n=self.n_mc,
                                                      seed=self.seed)
                                for a in _GRID])
            self._tables[method] = tab
        return tab

    def cycles(self, method: str, a_bs: float, w_bs: float) -> float:
        grid = np.asarray(_GRID)
        a = float(np.clip(a_bs, grid[0], grid[-1]))
        w = float(np.clip(w_bs, grid[0], grid[-1]))
        tab = self._table(method)
        if tab.ndim == 1:
            return float(np.interp(a, grid, tab))
        col = np.array([np.interp(a, grid, row) for row in tab])
        return float(np.interp(w, grid, col))


class SparsityProbe:
    """Serving-side sparsity probe handle (``ServeConfig(probe=...)``).

    ``probe_every=0`` is the no-op handle (``NULL_PROBE``): no probed step
    runs.  ``probe_every=k`` samples every k-th decode/verify step (and
    every admission prefill)."""

    def __init__(self, probe_every: int = 1, *, n_mc: int = 20_000,
                 array_steps: int = 24, seed: int = 0):
        self.probe_every = int(probe_every)
        self.array_steps = int(array_steps)
        self.seed = int(seed)
        self._model = _CycleModel(n_mc=n_mc, seed=seed)
        self._sim_cache: Dict[tuple, tuple] = {}

    @property
    def enabled(self) -> bool:
        return self.probe_every > 0

    def should_sample(self, step: int) -> bool:
        return self.enabled and step % self.probe_every == 0

    def _array_point(self, a_bs, a_vs, w_bs, w_vs):
        """(pe_utilization, avg_cycles_per_step) of a small seeded
        quasi-sync array simulation at the measured operating point;
        memoized on the rates rounded to the grid the simulation can
        resolve."""
        key = tuple(round(v, 2) for v in (a_bs, a_vs, w_bs, w_vs))
        out = self._sim_cache.get(key)
        if out is None:
            cfg = array_sim.ArrayConfig(rows=8, cols=16, E=3, Q=2,
                                        zero_filter=True)
            r = array_sim.run_experiment(self.seed, cfg, self.array_steps,
                                         bit_sparsity=key[2],
                                         w_value_sparsity=key[3],
                                         a_value_sparsity=key[1],
                                         a_bit_sparsity=key[0])
            out = (float(r.pe_utilization), float(r.avg_cycles_per_step))
            self._sim_cache[key] = out
        return out

    def fold(self, stats: np.ndarray, weight_profile: dict,
             phase: str) -> dict:
        """Price one sampled step: device stat rows + the static weight
        profile -> the ``hw_estimate`` record fields (plain Python values,
        ready for ``Telemetry.emit``)."""
        stats = np.asarray(stats, np.float64)
        n_layers = len(weight_profile["per_layer_bit_sparsity"])
        act_bs, act_vs = _rates(stats)
        per_bs, per_vs = _row_rates(stats)
        w_bs = float(weight_profile["bit_sparsity"])
        w_vs = float(weight_profile.get("value_sparsity", 0.0))
        cycles = {m: self._model.cycles(m, act_bs, w_bs)
                  for m in PROBE_METHODS}
        util, cyc_step = self._array_point(act_bs, act_vs, w_bs, w_vs)
        # Table III operating point: the table is indexed by one shared
        # sparsity level, so energy interpolates at the two factors' mean.
        op_bs = 0.5 * (act_bs + w_bs)
        energy = {m: float(cm.mac_energy_pj(m, op_bs))
                  for m in PROBE_METHODS}
        return {
            "phase": phase,
            "n_layers": int(n_layers),
            "act_bit_sparsity": act_bs,
            "act_value_sparsity": act_vs,
            "weight_bit_sparsity": w_bs,
            "per_layer_act_bit_sparsity": per_bs,
            "per_layer_act_value_sparsity": per_vs,
            "cycles": cycles,
            "array_utilization": util,
            "array_cycles_per_step": cyc_step,
            "mac_energy_pj": energy,
        }


NULL_PROBE = SparsityProbe(probe_every=0)
