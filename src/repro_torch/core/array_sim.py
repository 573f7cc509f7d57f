"""Cycle-accurate simulator of the quasi-synchronizing MAC array (port of
``repro/core/array_sim.py``; paper Section IV-B).

  * 16 x 32 PE array; each *column* is a synchronization group.
  * **Intra-group elasticity**: every PE owns an operand queue of depth Q.
    A column "propagates one step forward" only when all its PEs accept the
    step's operands (Q = 0: all PEs of the column must be idle).
  * **Inter-group elasticity**: the fastest column may run at most E steps
    ahead of the slowest (the weight buffer holds E+1 weight versions).
  * **Zero-value filtering**: zero operands are filtered before the queue
    and cost 0 cycles.
  * Data correlation matches the dataflow: the weight of row r at step s is
    shared by all columns; the activation entering column c at step s
    propagates down the rows, so PE (r, c) at column-step s multiplies
    weight[r, s] x activation[c, s - r].
  * No cache-miss stalls are modeled, as in the paper.

``simulate`` is numpy (a discrete-cycle loop over vectorized (R, C) state),
as in the reference.  ``build_op_costs`` is a seeded generator
(:func:`sample_operands`) followed by a deterministic costing core
(:func:`op_costs`) that takes the operands as tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import bitparticle as bp
from repro_torch.core.sparsity import sample_with_bit_sparsity


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    rows: int = 16
    cols: int = 32
    E: int = 3                 # inter-group step divergence bound
    Q: int = 2                 # per-PE operand queue depth
    zero_filter: bool = False  # pre-queue zero-value filtering
    approx: bool = False       # approximate MAC variant (cycle model)

    @property
    def weight_buffer_depth(self) -> int:
        return self.E + 1      # Section IV-B2


@dataclasses.dataclass
class SimResult:
    cycles: int
    n_steps: int
    pe_utilization: float      # busy PE-cycles / (R*C*cycles)
    avg_cycles_per_step: float # cycles / n_steps   (Fig. 9 metric)
    throughput_steps_per_cycle: float
    max_observed_divergence: int


def sample_operands(gen: torch.Generator, cfg: ArrayConfig, n_steps: int,
                    bit_sparsity: float, w_value_sparsity: float = 0.0,
                    a_value_sparsity: float = 0.0,
                    a_bit_sparsity: Optional[float] = None):
    """(w (R, S), a (C, S + R - 1)) int32 from the paper's generator: the
    weights shared across columns, the activations entering each column.
    ``a_bit_sparsity`` gives the activation factor its own bit sparsity
    (default the weights' ``bit_sparsity``)."""
    w = sample_with_bit_sparsity(gen, (cfg.rows, n_steps), bit_sparsity,
                                 w_value_sparsity)
    a = sample_with_bit_sparsity(
        gen, (cfg.cols, n_steps + cfg.rows - 1),
        bit_sparsity if a_bit_sparsity is None else a_bit_sparsity,
        a_value_sparsity)
    return w, a


def op_costs(w, a, cfg: ArrayConfig) -> np.ndarray:
    """Per-(row, col, step) MAC cycle costs (R, C, S) int32 of the operands
    ``w`` (R, S) and ``a`` (C, S + R - 1): the activation consumed by PE
    (r, c) at column-step s entered at step s - r (the pipeline skew)."""
    w, a = np.asarray(w), np.asarray(a)
    n_steps = w.shape[1]
    # a_used[r, c, s] = a[c, s - r + (R-1)]
    s_idx = np.arange(n_steps)[None, None, :]
    r_idx = np.arange(cfg.rows)[:, None, None]
    a_used = a[np.arange(cfg.cols)[None, :, None],
               s_idx - r_idx + (cfg.rows - 1)]
    w_used = np.broadcast_to(w[:, None, :], (cfg.rows, cfg.cols, n_steps))
    costs = bp.mac_cycles(torch.from_numpy(np.ascontiguousarray(w_used)),
                          torch.from_numpy(np.ascontiguousarray(a_used)),
                          approx=cfg.approx).numpy()
    if cfg.zero_filter:
        costs = np.where((w_used == 0) | (a_used == 0), 0, costs)
    return costs.astype(np.int32)


def build_op_costs(gen: torch.Generator, cfg: ArrayConfig, n_steps: int,
                   bit_sparsity: float, w_value_sparsity: float = 0.0,
                   a_value_sparsity: float = 0.0,
                   a_bit_sparsity: Optional[float] = None) -> np.ndarray:
    """Per-(row, col, step) MAC cycle costs from the paper's data
    generator, drawn from ``gen``."""
    w, a = sample_operands(gen, cfg, n_steps, bit_sparsity, w_value_sparsity,
                           a_value_sparsity, a_bit_sparsity)
    return op_costs(w, a, cfg)


def simulate(costs: np.ndarray, cfg: ArrayConfig) -> SimResult:
    """Run the quasi-synchronous schedule over a (R, C, S) cost tensor."""
    R, C, S = costs.shape
    if (R, C) != (cfg.rows, cfg.cols):
        raise ValueError(f"costs of a {R}x{C} array for a "
                         f"{cfg.rows}x{cfg.cols} config")
    Q = cfg.Q
    qcap = max(Q, 1)
    queue = np.zeros((R, C, qcap), np.int32)   # FIFO of pending op costs
    qlen = np.zeros((R, C), np.int32)
    exec_rem = np.zeros((R, C), np.int32)
    steps = np.full(C, -1, np.int64)           # last accepted step per column
    busy_cycles = 0
    cycles = 0
    max_div = 0
    # safety bound: every op serialized + drain
    max_cycles = int(costs.sum() + 4 * S + R * C + 64)

    while True:
        # termination: everything accepted and drained
        if (steps == S - 1).all() and not exec_rem.any() and not qlen.any():
            break
        cycles += 1
        if cycles > max_cycles:
            raise RuntimeError("simulator failed to make progress")

        # --- 1. column advancement (acceptance) -------------------------
        # The divergence bound (fastest <= slowest + E) is evaluated against
        # the POST-advance step vector: columns all sitting at the same step
        # may advance together even at E = 0.  Fixpoint over the (monotone)
        # constraint set.
        if Q == 0:
            accept_ok = ((exec_rem == 0) & (qlen == 0)).all(axis=0)
        else:
            accept_ok = (qlen < Q).all(axis=0)
        adv = accept_ok & (steps < S - 1)
        while adv.any():
            new_min = np.where(adv, steps + 1, steps).min()
            adv2 = adv & (steps + 1 - new_min <= cfg.E)
            if (adv2 == adv).all():
                break
            adv = adv2
        if adv.any():
            new_steps = steps[adv] + 1
            new_costs = costs[:, adv, :][np.arange(R)[:, None],
                                         np.arange(adv.sum())[None, :],
                                         new_steps[None, :]]
            nz = new_costs > 0                 # zero-cost ops never enqueue
            cols_adv = np.where(adv)[0]
            if Q == 0:
                # straight to execution (PE proven idle)
                er = exec_rem[:, cols_adv]
                er[nz] = new_costs[nz]
                exec_rem[:, cols_adv] = er
            else:
                qv = queue[:, cols_adv, :]
                ql = qlen[:, cols_adv]
                r_i, c_i = np.nonzero(nz)
                qv[r_i, c_i, ql[r_i, c_i]] = new_costs[r_i, c_i]
                ql[r_i, c_i] += 1
                queue[:, cols_adv, :] = qv
                qlen[:, cols_adv] = ql
            steps[adv] += 1
            max_div = max(max_div, int(steps.max() - steps.min()))

        # --- 2. issue: idle PEs pop the queue head ----------------------
        pop = (exec_rem == 0) & (qlen > 0)
        if pop.any():
            exec_rem[pop] = queue[pop, 0]
            queue[pop] = np.roll(queue[pop], -1, axis=-1)
            queue[pop, qcap - 1] = 0
            qlen[pop] -= 1

        # --- 3. execute one cycle ---------------------------------------
        busy = exec_rem > 0
        busy_cycles += int(busy.sum())
        exec_rem[busy] -= 1

    return SimResult(
        cycles=cycles,
        n_steps=S,
        pe_utilization=busy_cycles / (R * C * max(cycles, 1)),
        avg_cycles_per_step=cycles / S,
        throughput_steps_per_cycle=S / max(cycles, 1),
        max_observed_divergence=max_div,
    )


def run_experiment(seed: int, cfg: ArrayConfig, n_steps: int,
                   bit_sparsity: float, w_value_sparsity: float = 0.0,
                   a_value_sparsity: float = 0.0,
                   a_bit_sparsity: Optional[float] = None) -> SimResult:
    gen = torch.Generator().manual_seed(int(seed))
    costs = build_op_costs(gen, cfg, n_steps, bit_sparsity, w_value_sparsity,
                           a_value_sparsity, a_bit_sparsity)
    return simulate(costs, cfg)
