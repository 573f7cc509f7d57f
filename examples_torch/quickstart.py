"""Quickstart on the PyTorch port: the BitParticle pipeline end to end, with
the BitParticle matmul kernel on the GPU.

    PYTHONPATH=src python examples_torch/quickstart.py
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

The sections and figures are those of ``examples/quickstart.py``.  The
matmul operands come from ``numpy.random.default_rng(0)`` (``jax.random``'s
cannot be reproduced here), and the seeded models draw from
``torch.Generator``s, so their figures differ from the JAX example's within
their sampling noise.  Section 3 calls the kernel's wrapper,
``kernels/bitparticle_matmul/ops.bp_matmul`` with ``backend="auto"``: on
the card that launches the CUDA kernel, and on CPU tensors it runs the
plain version.  Without CUDA the default ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import bitparticle as bp
from repro_torch.core import cost_model as cm
from repro_torch.core.array_sim import ArrayConfig, run_experiment
from repro_torch.core.bp_matmul import bp_matmul_int
from repro_torch.kernels.bitparticle_matmul import ops as bp_ops


def section(title):
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)))


def particle_figures(a: int, w: int) -> dict:
    """One MAC through the particlized datapath (paper Fig. 4)."""
    prod, pps, cycles = bp.assemble_partial_products(a, w)
    return {"particles": bp.particlize(abs(a)).tolist(),
            "ir_matrix": bp.ir_matrix(abs(a), abs(w)).tolist(),
            "partial_products": pps, "product": int(prod),
            "cycles": int(cycles), "model_cycles": int(bp.mac_cycles(a, w)),
            "approx_product": int(bp.multiply_approx(a, w))}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without it)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    out = {}

    # ---- 1. one MAC through the particlized datapath ---------------------
    section("1. Particlized multiplication (paper Fig. 4)")
    a, w = -93, 57
    f = out["mac"] = particle_figures(a, w)
    print(f"a={a}, w={w}: particles(a)={f['particles']}")
    print(f"IR matrix:\n{np.asarray(f['ir_matrix'])}")
    print(f"partial products per cycle (set0, set1): "
          f"{f['partial_products']}")
    print(f"product={f['product']} (check: {a*w}), cycles={f['cycles']} "
          f"(model: {f['model_cycles']})")
    print(f"approx product={f['approx_product']} "
          f"(drops IR groups 0 and 1-4)")

    # ---- 2. quantized matmul in all three numerics modes ------------------
    section("2. W8A8 matmul: exact == int8; approx within 81*K")
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.integers(-127, 128, (8, 64)).astype(np.int8))
    W = torch.from_numpy(rng.integers(-127, 128, (64, 16)).astype(np.int8))
    exact = bp_matmul_int(A, W, "bp_exact")
    approx = bp_matmul_int(A, W, "bp_approx")
    K = A.shape[1]
    err = int((exact - A.to(torch.int32) @ W.to(torch.int32)).abs().max())
    print(f"max |exact - int_matmul| = {err}")
    print(f"max |approx - exact| = {int((approx - exact).abs().max())} "
          f"(bound: 81*K = {81*K})")

    # ---- 3. the BitParticle matmul kernel ----------------------------------
    section(f"3. BitParticle matmul kernel (ops.bp_matmul on {device})")
    got = bp_ops.bp_matmul(A.to(device), bp_ops.kmajor(W.to(device)),
                           approx=True, backend="auto")
    out["kernel_equal"] = bool(torch.equal(got.cpu(), approx))
    route = "CUDA kernel" if device.type == "cuda" else "plain version"
    print(f"{route} == plain reference: {out['kernel_equal']}")

    # ---- 4. quasi-synchronous MAC array ------------------------------------
    section("4. Quasi-sync array: E/Q elasticity (paper Fig. 8)")
    for E, Q in [(0, 0), (3, 2)]:
        r = run_experiment(0, ArrayConfig(E=E, Q=Q), 128, bit_sparsity=0.7)
        print(f"E{E}Q{Q}: PE utilization={r.pe_utilization:.3f}, "
              f"cycles/step={r.avg_cycles_per_step:.3f}")

    # ---- 5. efficiency vs the baselines ------------------------------------
    section("5. Table III reproduction (normalized to AdaS)")
    t = cm.table3("paper")
    print("area eff  @60% bit sparsity:",
          {k: round(v["area_eff"][1], 2) for k, v in t.items()})
    print("energy eff@60% bit sparsity:",
          {k: round(v["energy_eff"][1], 2) for k, v in t.items()})
    print("our modeled BP cycles vs paper:",
          round(cm.modeled_avg_cycles("bp_exact", 0.6, n=50_000), 3),
          "vs", cm.PAPER_AVG_CYCLES["bp_exact"][1])
    if not out["kernel_equal"]:
        raise SystemExit("quickstart: the kernel disagrees with its plain "
                         "reference")
    return out


if __name__ == "__main__":
    main()
