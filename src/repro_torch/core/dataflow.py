"""The paper's two switchable dataflows + loop tiling + mini-ZigZag mapper
(port of ``repro/core/dataflow.py``; Section IV-A, the Figs 12-13
system-level model).  Pure integer math.

PE array: 16 rows x 32 columns.  K (output channel) is spatially unrolled
over the 16 rows in both dataflows; columns unroll either

  dataflow (a):  OXu x OYu = 32, (OXu, OYu) in {(32,1), (16,2), (8,4)}
                 - early conv layers with large OX/OY;
  dataflow (b):  Bu = 32 - late conv / fully-connected layers.

Spatially-unrolled dims (K, B, OX, OY) produce independent outputs, so no
inter-PE accumulation; the reduction dims (C, FY, FX) iterate temporally
with in-PE accumulation (schedule ...-K1-FY-FX-C, reduction innermost).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

from repro_torch.core.cost_model import (ACCEL_CONFIGS, DRAM_PJ_PER_BYTE,
                                         sram_pj_per_byte)

ROWS, COLS = 16, 32
OXU_OYU_CHOICES: Tuple[Tuple[int, int], ...] = ((32, 1), (16, 2), (8, 4))


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """The 7 dimensions of a conv layer (TABLE I).  FC: OX=OY=FY=FX=1."""
    name: str
    B: int
    K: int
    C: int
    OY: int
    OX: int
    FY: int = 1
    FX: int = 1

    @property
    def total_macs(self) -> int:
        return self.B * self.K * self.C * self.OY * self.OX * self.FY * self.FX

    @property
    def weight_count(self) -> int:
        return self.K * self.C * self.FY * self.FX

    @property
    def input_count(self) -> int:
        # stride-1 approximation of the input feature map volume
        return self.B * self.C * (self.OY + self.FY - 1) * (self.OX + self.FX - 1)

    @property
    def output_count(self) -> int:
        return self.B * self.K * self.OY * self.OX


@dataclasses.dataclass(frozen=True)
class Mapping:
    dataflow: str              # "a" or "b"
    oxu: int = 1
    oyu: int = 1
    steps: int = 0             # temporal steps (each step = 512 PE MAC slots)
    spatial_utilization: float = 0.0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def enumerate_mappings(shape: LayerShape) -> List[Mapping]:
    """All legal (dataflow, spatial-unroll) choices with their step counts."""
    out = []
    temporal_common = shape.C * shape.FY * shape.FX * _ceil(shape.K, ROWS)
    # dataflow (a): columns unroll OX x OY
    for oxu, oyu in OXU_OYU_CHOICES:
        steps = (temporal_common * shape.B
                 * _ceil(shape.OX, oxu) * _ceil(shape.OY, oyu))
        out.append(Mapping("a", oxu, oyu, steps,
                           shape.total_macs / (steps * ROWS * COLS)))
    # dataflow (b): columns unroll batch
    steps_b = temporal_common * _ceil(shape.B, COLS) * shape.OX * shape.OY
    out.append(Mapping("b", 1, 1, steps_b,
                       shape.total_macs / (steps_b * ROWS * COLS)))
    return out


def choose_mapping(shape: LayerShape) -> Mapping:
    """ZigZag-style pick: minimize temporal steps (max spatial utilization)."""
    return min(enumerate_mappings(shape), key=lambda m: m.steps)


@dataclasses.dataclass
class Traffic:
    """Access counts in elements (int8 => bytes)."""
    w_cache_reads: int
    a_cache_reads: int
    r_cache_writes: int
    dram_weight_bytes: int
    dram_act_bytes: int
    dram_out_bytes: int

    def cache_energy_pj(self, accel: str = "bitparticle") -> float:
        cfg = ACCEL_CONFIGS[accel]
        e = self.w_cache_reads * sram_pj_per_byte(cfg.w_cache_bytes)
        e += self.a_cache_reads * sram_pj_per_byte(cfg.a_cache_bytes)
        r_cache = cfg.r_cache_bytes or cfg.a_cache_bytes
        e += self.r_cache_writes * sram_pj_per_byte(r_cache)
        return e

    def dram_energy_pj(self) -> float:
        return (self.dram_weight_bytes + self.dram_act_bytes
                + self.dram_out_bytes) * DRAM_PJ_PER_BYTE


def analyze_traffic(shape: LayerShape, mapping: Mapping,
                    accel: str = "bitparticle") -> Traffic:
    """First-order reuse analysis of the chosen schedule.

    Per step: 16 weights read (one per row, shared across 32 columns) and 32
    activations read (one per column, reused down the 16 rows by
    propagation).  Outputs accumulate in-PE across the reduction loops and
    are written once.  DRAM: weights/acts fetched once if their per-tile
    working set fits the cache, else refetched per outer spatial tile
    (loop order B-OY1-OX1-K1-FY-FX-C, Section IV-A2).
    """
    cfg = ACCEL_CONFIGS[accel]
    w_cache_reads = mapping.steps * ROWS
    a_cache_reads = mapping.steps * COLS
    r_cache_writes = shape.output_count

    w_bytes = shape.weight_count  # int8
    a_bytes = shape.input_count
    o_bytes = shape.output_count

    if mapping.dataflow == "a":
        n_ox1 = _ceil(shape.OX, mapping.oxu)
        n_oy1 = _ceil(shape.OY, mapping.oyu)
        outer_spatial = shape.B * n_ox1 * n_oy1
    else:
        outer_spatial = _ceil(shape.B, COLS)
    # weights refetched per outer spatial iteration unless they fit W-cache
    w_refetch = 1 if w_bytes <= cfg.w_cache_bytes else outer_spatial
    # activations refetched per K1 tile unless they fit A-cache
    a_refetch = 1 if a_bytes <= cfg.a_cache_bytes else _ceil(shape.K, ROWS)
    return Traffic(
        w_cache_reads=w_cache_reads,
        a_cache_reads=a_cache_reads,
        r_cache_writes=r_cache_writes,
        dram_weight_bytes=w_bytes * w_refetch,
        dram_act_bytes=a_bytes * a_refetch,
        dram_out_bytes=o_bytes,
    )


def network_mapping_report(layers: Iterable[LayerShape]):
    """Per-layer mapping decisions + aggregate utilization."""
    rows = []
    tot_macs = tot_steps = 0
    for layer in layers:
        m = choose_mapping(layer)
        rows.append((layer, m))
        tot_macs += layer.total_macs
        tot_steps += m.steps
    agg_util = tot_macs / (tot_steps * ROWS * COLS) if tot_steps else 0.0
    return rows, agg_util
