"""Price a real model's layers on the modeled BitParticle accelerator, on the
PyTorch port: per-layer bit/value sparsity -> cycles, energy, and the
exact-vs-approx / vs-AdaS / vs-BitWave comparison (the paper's evaluation
flow applied to an LM from this repo's zoo).

    PYTHONPATH=src python examples_torch/estimate_deployment.py [--arch qwen2-1.5b]
    PYTHONPATH=src python examples_torch/estimate_deployment.py --measured run.jsonl
    PYTHONPATH=src python examples_torch/estimate_deployment.py --device cpu

The flags and report are those of ``examples/estimate_deployment.py``.
``--measured`` reads the ``hw_estimate`` records a probed serve wrote
(``examples_torch/serve_lm.py --probe K --metrics run.jsonl``), averages the
measured-traffic modeled cycles and prints them against the cited Table III
ladder interpolated at the same operating point; it needs no device.

The synthetic estimate draws the weights from ``api.init`` with a
``torch.Generator`` seeded 0, the tokens (and the audio family's source
frames) from ``numpy.random.default_rng(1)``, and pairs the activations
with the weights in an order drawn from a generator seeded 0; ``jax.random``
cannot be reproduced here, so the figures differ from the JAX example's.
The forward runs on ``--device`` (default cuda; raises without it).  The
hybrid family has no hidden-state forward (nor has the reference's).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_arch
from repro_torch.core import cost_model as cm
from repro_torch.core import quant, sparsity
from repro_torch.models import api, causal_lm, encdec, rwkv_model
from repro_torch.serving import PROBE_METHODS, read_jsonl
from repro_torch.tree import leaf_paths

def measured_report(path: str) -> int:
    recs = [r for r in read_jsonl(path) if r.get("kind") == "hw_estimate"]
    if not recs:
        print(f"estimate_deployment: no hw_estimate records in {path} "
              f"(serve with a SparsityProbe attached, e.g. "
              f"serve_lm.py --probe 2 --metrics {path})", file=sys.stderr)
        return 1
    n = len(recs)
    phases = sorted({r["phase"] for r in recs})
    act_bs = float(np.mean([r["act_bit_sparsity"] for r in recs]))
    act_vs = float(np.mean([r["act_value_sparsity"] for r in recs]))
    w_bs = float(np.mean([r["weight_bit_sparsity"] for r in recs]))
    util = float(np.mean([r["array_utilization"] for r in recs]))
    per_layer = np.mean([r["per_layer_act_bit_sparsity"] for r in recs],
                        axis=0)

    print(f"measured-traffic deployment estimate: {n} sampled steps "
          f"({'/'.join(phases)}) from {path}")
    print(f"  activation bit sparsity {act_bs:.3f} "
          f"(value {act_vs:.3f}), weight bit sparsity {w_bs:.3f}, "
          f"modeled array utilization {util:.3f}")
    print("  per-layer activation bit sparsity: "
          + " ".join(f"{v:.3f}" for v in per_layer))

    # the cited ladder is indexed by one shared sparsity level: interpolate
    # at the measured operating point (mean of the two factors' sparsity,
    # the same rule SparsityProbe.fold uses for energy)
    op_bs = 0.5 * (act_bs + w_bs)
    levels = np.asarray(cm.SPARSITY_LEVELS)
    print(f"\n  {'unit':10s} {'measured':>9s} {'tableIII':>9s} "
          f"{'delta':>7s}   {'pJ/MAC':>7s}  (table interpolated at "
          f"bs={op_bs:.3f})")
    for m in PROBE_METHODS:
        meas = float(np.mean([r["cycles"][m] for r in recs]))
        table = float(np.interp(op_bs, levels,
                                np.asarray(cm.PAPER_AVG_CYCLES[m])))
        pj = float(np.mean([r["mac_energy_pj"][m] for r in recs]))
        print(f"  {m:10s} {meas:9.2f} {table:9.2f} "
              f"{(meas - table) / table * 100:+6.1f}%   {pj:7.2f}")
    print("\n  deltas reflect live-traffic sparsity (and the wider "
          "interpolation grid), not a change in the cost model itself")
    return 0


def activations(params, cfg, device, seed: int = 1) -> torch.Tensor:
    """The model's hidden states on 2 x 128 seeded tokens (the audio
    family: its encoder's output on 2 x 32 seeded frames), quantized per
    tensor to int8."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128))
                              ).to(device)
    with torch.no_grad():
        if cfg.family == "audio":
            src = torch.from_numpy(rng.standard_normal(
                (2, 32, cfg.d_model)).astype(np.float32)).to(
                    device, torch.bfloat16)
            acts = encdec.encode(params, cfg, src)
        elif cfg.family == "ssm":
            acts, _ = rwkv_model.forward(params, cfg, {"tokens": tokens})
        elif cfg.family in ("dense", "moe", "vlm"):
            acts, _, _ = causal_lm.forward(params, cfg, {"tokens": tokens})
        else:
            raise NotImplementedError(
                f"family {cfg.family!r} has no hidden-state forward")
    a_q, _ = quant.quantize_per_tensor(acts.to(torch.float32))
    return a_q


def pairing(a_q: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The activations in the order they meet the weights (a permutation
    drawn from ``seed``), as ``cost_model.avg_cycles_for_tensors`` pairs
    them."""
    a = a_q.reshape(-1).to(torch.int32).cpu()
    gen = torch.Generator().manual_seed(int(seed))
    return a[torch.randperm(a.shape[0], generator=gen)]


def rates(q: torch.Tensor):
    """(sign-magnitude bit sparsity, value sparsity) of an int8 tensor,
    from exact integer counts (one rounding, to float64)."""
    zero_bits, n, zeros = sparsity.sm_bit_counts(q).tolist()
    return zero_bits / (7 * n), zeros / n


def price_layers(params, a_q: torch.Tensor,
                 pairs: Optional[torch.Tensor] = None) -> List[dict]:
    """One row per dense weight matrix, in the reference's tree order: its
    sign-magnitude bit sparsity, the activations' value sparsity, the
    modeled cycles per MAC exact and approximate (the first n weights
    against ``pairs[:n]``, zero pairs free) and the energy per MAC."""
    pairs = pairing(a_q) if pairs is None else pairs
    _, vs = rates(a_q)
    rows = []
    for name, leaf in leaf_paths(params):
        if leaf.ndim < 2 or not name.endswith("w"):
            continue
        w_q, _ = quant.quantize_per_tensor(leaf.to(torch.float32))
        bs, _ = rates(w_q)
        w = w_q.reshape(-1).to(torch.int32).cpu()
        n = min(w.shape[0], pairs.shape[0], 200_000)
        rows.append({
            "name": name, "bit_sparsity": bs, "value_sparsity": vs,
            "cycles": cm.pair_cycles(w[:n], pairs[:n]),
            "cycles_approx": cm.pair_cycles(w[:n], pairs[:n], approx=True),
            "mac_energy_pj": cm.mac_energy_pj("bp_exact", bs)})
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--measured", default=None, metavar="JSONL",
                    help="aggregate the hw_estimate records of a probed "
                         "serve instead of the synthetic estimate")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without it)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.measured:
        return measured_report(args.measured)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    params = api.init(cfg, generator=torch.Generator(device=device)
                      .manual_seed(0), device=device)
    a_q = activations(params, cfg, device)

    print(f"{'layer':42s} {'bitsp':>6s} {'valsp':>6s} {'cyc':>6s} "
          f"{'cyc~':>6s} {'pJ/MAC':>7s}")
    rows = price_layers(params, a_q)
    for r in rows[:12]:
        print(f"{r['name'][-42:]:42s} {r['bit_sparsity']:6.3f} "
              f"{r['value_sparsity']:6.3f} {r['cycles']:6.2f} "
              f"{r['cycles_approx']:6.2f} {r['mac_energy_pj']:7.2f}")
    bs_m = float(np.mean([r["bit_sparsity"] for r in rows]))
    print(f"\nmean weight bit sparsity {bs_m:.3f} over {len(rows)} kernels")
    for unit in ("bp_exact", "bp_approx", "bitwave", "adas"):
        c = cm.modeled_avg_cycles(
            "bit_serial" if unit == "adas" else unit, bs_m, n=50_000)
        print(f"  {unit:10s} cycles/MAC={c:5.2f}  "
              f"energy/MAC={cm.mac_energy_pj(unit, bs_m):5.2f} pJ  "
              f"area={cm.AREA_UM2[unit]:8.1f} um^2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
