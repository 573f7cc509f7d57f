"""Area / power / energy / cycle cost models (port of
``repro/core/cost_model.py``; paper Tables II-III, Figs 12-13).

Two kinds of numbers live here, kept apart:

  * **Cited constants**: the paper's RTL-synthesis results (45 nm,
    500 MHz, Synopsys DC): per-unit area and power, and Table III's measured
    average cycles.
  * **First-principles models**: average cycles per MAC of BitParticle
    (from the bit-exact emulation), an ideal bit-serial unit and BitWave's
    column skipping, Monte-Carlo'd over the paper's data generator.

Each Monte-Carlo model is a seeded generator (:func:`mc_operands`, a
``torch.Generator``) followed by a deterministic costing core
(:func:`avg_cycles`) that takes the operands as tensors.  The draws cannot
reproduce the reference's ``jax.random`` streams; the cores give the
reference's numbers exactly on the reference's operands.

Memory energies follow Horowitz, "Computing's energy problem" (ISSCC
2014), 45 nm: ~10 pJ per 32-bit access for an 8 KiB SRAM, scaling
~sqrt(capacity); DRAM ~1.3 nJ per 32-bit access.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import bitparticle as bp
from repro_torch.core.sparsity import sample_with_bit_sparsity

CLOCK_HZ = 500e6
SPARSITY_LEVELS = (0.5, 0.6, 0.7, 0.8, 0.9)

# --- Table III (cited) ------------------------------------------------------

PAPER_AVG_CYCLES: Dict[str, tuple] = {
    "adas":      (3.22, 2.46, 1.80, 1.29, 1.04),
    "bitwave":   (0.91, 0.85, 0.76, 0.62, 0.42),
    "bp_exact":  (2.14, 1.71, 1.34, 1.10, 1.01),
    "bp_approx": (2.12, 1.69, 1.33, 1.10, 1.01),
}

AREA_UM2: Dict[str, float] = {
    "adas": 462.04, "bitwave": 1504.76, "bp_exact": 544.50,
    "bp_approx": 443.42,
}

POWER_UW: Dict[str, tuple] = {
    "adas":      (439.81, 434.80, 420.49, 368.47, 285.83),
    "bitwave":   (1054.50, 1008.10, 923.44, 867.41, 728.43),
    "bp_exact":  (509.38, 481.01, 451.49, 392.54, 318.13),
    "bp_approx": (432.20, 409.94, 386.40, 339.17, 273.24),
}


# --- Table II (cited) -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    name: str
    pe_count: int
    w_cache_bytes: int
    a_cache_bytes: int
    r_cache_bytes: int
    metadata_bytes: int = 0


ACCEL_CONFIGS = {
    "bitparticle": AcceleratorConfig("bitparticle", 512, 64 << 10,
                                     128 << 10, 128 << 10),
    "bitwave": AcceleratorConfig("bitwave", 512, 256 << 10, 256 << 10, 0),
    "adas": AcceleratorConfig("adas", 256, 128 << 10, 128 << 10, 0,
                              64 << 10),
}

# --- Memory energy / area (Horowitz ISSCC'14-derived, 45 nm) ---------------

DRAM_PJ_PER_BYTE = 1300.0 / 4.0          # ~1.3 nJ / 32-bit access
SRAM_MM2_PER_KB = 0.0007 * 2.0           # ~1.4e-3 mm^2 per KB at 45 nm


def sram_pj_per_byte(capacity_bytes: int) -> float:
    """~10 pJ / 32-bit at 8 KiB, scaling with sqrt(capacity)."""
    return (10.0 / 4.0) * math.sqrt(max(capacity_bytes, 1024) / 8192.0)


# --- First-principles average-cycle models ----------------------------------

def _mean_f32(x: torch.Tensor) -> float:
    """float32 mean of small integer-valued samples as the reference's
    ``jnp.mean`` takes it: the exact sum times the float32 reciprocal of
    the count (not a correctly rounded division)."""
    total = np.float32(float(x.to(torch.float64).sum()))
    return float(total * np.float32(1.0 / x.numel()))


def mc_operands(bit_sparsity: float, n: int, seed: int,
                w_bit_sparsity: Optional[float] = None):
    """(a, w): ``n`` activation and weight operands from the paper's
    generator, drawn on the CPU from a generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    a = sample_with_bit_sparsity(gen, (n,), bit_sparsity)
    w = sample_with_bit_sparsity(
        gen, (n,), bit_sparsity if w_bit_sparsity is None else w_bit_sparsity)
    return a, w


def cycle_samples(method: str, a, w) -> torch.Tensor:
    """Per-sample cost (float32) whose mean is :func:`avg_cycles`: cycles
    per MAC (``bp_exact`` / ``bp_approx`` / ``bit_serial``), or surviving
    bit columns of each 8-operand group over 8 (``bitwave``)."""
    a = torch.as_tensor(a)
    if method in ("bp_exact", "bp_approx"):
        c = bp.mac_cycles(a, w, approx=(method == "bp_approx"))
        return c.to(torch.float32)
    _, mag = bp.to_sign_magnitude(a)
    if method == "bit_serial":
        return torch.clamp_min(bp._popcount7(mag), 1).to(torch.float32)
    if method == "bitwave":
        n = mag.shape[0]
        groups = mag[: n // 8 * 8].reshape(-1, 8)
        cols = torch.zeros(groups.shape[0], dtype=torch.int32,
                           device=mag.device)
        for b in range(7):
            cols = cols + ((groups >> b) & 1).any(dim=1).to(torch.int32)
        return cols.to(torch.float32) / 8.0
    raise ValueError(method)


def avg_cycles(method: str, a, w) -> float:
    """Average cycles per MAC of ``method`` on the operands ``a``, ``w``
    (the deterministic core of the Monte-Carlo models)."""
    return _mean_f32(cycle_samples(method, a, w))


def modeled_avg_cycles(method: str, bit_sparsity: float, n: int = 200_000,
                       seed: int = 0) -> float:
    """Monte-Carlo average cycles per MAC under the paper's data generator.

    methods: ``bp_exact`` / ``bp_approx``: the emulated BitParticle unit;
    ``bit_serial``: idealized single-factor bit-serial (AdaS-class),
    cycles = max(1, #nonzero magnitude bits of one operand); ``bitwave``:
    8-lane column skipping, a bit column is processed iff any of 8 grouped
    operands has a 1 there; cycles/op = surviving columns / 8."""
    a, w = mc_operands(bit_sparsity, n, seed)
    return avg_cycles(method, a, w)


def modeled_avg_cycles_dual(method: str, a_bit_sparsity: float,
                            w_bit_sparsity: float, n: int = 200_000,
                            seed: int = 0) -> float:
    """:func:`modeled_avg_cycles` with separate activation / weight
    sparsities (the serving probe measures the two factors apart).  For the
    single-factor methods only ``a_bit_sparsity`` matters."""
    a, w = mc_operands(a_bit_sparsity, n, seed, w_bit_sparsity=w_bit_sparsity)
    return avg_cycles(method, a, w)


# --- Efficiency metrics (Table III derivations) ------------------------------

def tops(avg_cycles_: float, n_units: int = 1) -> float:
    """Tera-ops/s: one MAC = 2 ops, at CLOCK_HZ, initiation interval =
    cycles."""
    return 2.0 * CLOCK_HZ * n_units / avg_cycles_ / 1e12


def area_efficiency(avg_cycles_: float, area_um2: float) -> float:
    """TOPS / mm^2 for a single unit."""
    return tops(avg_cycles_) / (area_um2 * 1e-6)


def energy_efficiency(avg_cycles_: float, power_uw: float) -> float:
    """TOPS / W for a single unit."""
    return tops(avg_cycles_) / (power_uw * 1e-6)


def table3(cycles_source: str = "paper") -> Dict[str, Dict[str, list]]:
    """Table III's normalized efficiency rows.  ``cycles_source``: "paper"
    uses the cited cycle measurements, "model" the Monte-Carlo models (adas
    -> the bit_serial model)."""
    methods = ("adas", "bitwave", "bp_exact", "bp_approx")
    out = {m: {"avg_cycles": [], "area_eff": [], "energy_eff": []}
           for m in methods}
    for i, bs in enumerate(SPARSITY_LEVELS):
        for m in methods:
            if cycles_source == "paper":
                c = PAPER_AVG_CYCLES[m][i]
            else:
                c = modeled_avg_cycles("bit_serial" if m == "adas" else m, bs)
            out[m]["avg_cycles"].append(c)
            out[m]["area_eff"].append(area_efficiency(c, AREA_UM2[m]))
            out[m]["energy_eff"].append(energy_efficiency(c, POWER_UW[m][i]))
    # normalize to AdaS, per sparsity level (the paper's presentation)
    for key in ("area_eff", "energy_eff"):
        base = list(out["adas"][key])
        for m in methods:
            out[m][key] = [v / b for v, b in zip(out[m][key], base)]
    return out


# --- Per-tensor deployment pricing ------------------------------------------

def pair_cycles(w, a, approx: bool = False, zero_filter: bool = True) -> float:
    """Mean BitParticle cycles/MAC of the operand pairs (w[i], a[i]), zero
    pairs free when ``zero_filter`` (the core of
    :func:`avg_cycles_for_tensors`)."""
    w, a = torch.as_tensor(w), torch.as_tensor(a)
    c = bp.mac_cycles(w, a, approx=approx).to(torch.float32)
    if zero_filter:
        c = torch.where((w == 0) | (a == 0), 0.0, c)
    return _mean_f32(c)


def avg_cycles_for_tensors(w_q, a_q, approx: bool = False,
                           zero_filter: bool = True, seed: int = 0) -> float:
    """Expected BitParticle cycles/MAC if these quantized tensors ran on the
    modeled array: the first n weights against n activations in an order
    drawn from ``seed`` (n <= 200,000)."""
    w = torch.as_tensor(w_q).to(torch.int32).reshape(-1).cpu()
    a = torch.as_tensor(a_q).to(torch.int32).reshape(-1).cpu()
    n = min(w.shape[0], a.shape[0], 200_000)
    gen = torch.Generator().manual_seed(int(seed))
    a = a[torch.randperm(a.shape[0], generator=gen)][:n]
    return pair_cycles(w[:n], a, approx=approx, zero_filter=zero_filter)


def mac_energy_pj(unit: str, bit_sparsity: float) -> float:
    """Per-MAC energy: (power / clock) x avg cycles, interpolating Table
    III."""
    bs = float(np.clip(bit_sparsity, SPARSITY_LEVELS[0], SPARSITY_LEVELS[-1]))
    xs = np.asarray(SPARSITY_LEVELS)
    p = float(np.interp(bs, xs, np.asarray(POWER_UW[unit])))
    c = float(np.interp(bs, xs, np.asarray(PAPER_AVG_CYCLES[unit])))
    return (p * 1e-6 / CLOCK_HZ) * c * 1e12
