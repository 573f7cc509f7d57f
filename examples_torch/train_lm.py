"""End-to-end training example on the PyTorch port, with checkpoint/resume,
spike rejection and compressed-gradient data parallelism on the synthetic
pipeline, on the GPU by default.

    PYTHONPATH=src python examples_torch/train_lm.py --steps 100
    PYTHONPATH=src python examples_torch/train_lm.py --steps 200   # resumes at 100
    PYTHONPATH=src python examples_torch/train_lm.py --steps 8 --device cpu

    # ~100M-param configuration (the default is laptop-sized):
    PYTHONPATH=src python examples_torch/train_lm.py --preset 100m --steps 5

The flags, presets and report are those of ``examples/train_lm.py``; the
checkpoints go under the temporary directory unless ``--ckpt-dir`` says
otherwise.  The weights come from ``api.init`` with a ``torch.Generator``
seeded 0 and the batches from the seeded numpy data pipeline;
``jax.random``'s streams cannot be reproduced here, so the losses differ
from the JAX example's.  The fleet estimate (``cluster_utilization``) is
seeded numpy and equals the reference's.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed.quasi_sync import (ClusterConfig,
                                                cluster_utilization)
from repro_torch.models import api
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_loop import TrainConfig, Trainer

PRESETS = {
    "tiny": dict(num_layers=2, d_model=128, d_ff=256, vocab_size=1024,
                 head_dim=32, seq=128, batch=8),
    "10m": dict(num_layers=4, d_model=320, d_ff=864, vocab_size=4096,
                head_dim=64, seq=256, batch=8),
    "100m": dict(num_layers=12, d_model=768, d_ff=2048, vocab_size=8192,
                 head_dim=64, seq=512, batch=8),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without it)")
    return ap


def arch_config(preset: str):
    p = PRESETS[preset]
    return get_arch("qwen2-1.5b").reduced().replace(
        num_layers=p["num_layers"], d_model=p["d_model"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], head_dim=p["head_dim"])


def build_trainer(args, device) -> Trainer:
    """The ``Trainer`` ``args`` ask for on ``device``; it resumes from the
    newest checkpoint in ``args.ckpt_dir``."""
    p = PRESETS[args.preset]
    arch = arch_config(args.preset)
    tc = TrainConfig(
        total_steps=args.steps, ckpt_every=25, ckpt_dir=args.ckpt_dir,
        compress_grads=args.compress_grads, log_every=10,
        optimizer=opt_lib.OptimizerConfig(peak_lr=3e-3, warmup_steps=20,
                                          total_steps=args.steps))
    dc = DataConfig(vocab_size=arch.vocab_size, seq_len=p["seq"],
                    global_batch=p["batch"])
    params = api.init(arch, generator=torch.Generator(device=device)
                      .manual_seed(0), device=device)
    return Trainer(arch, tc, dc, device=device, params=params)


def fleet_estimate(n_rounds: int = 100):
    """Worker utilization of strict sync (E0Q0) and quasi-sync (E3Q2) on
    8 hosts x 32 data-parallel groups with lognormal stragglers."""
    return (cluster_utilization(ClusterConfig(E=0, Q=0), n_rounds=n_rounds),
            cluster_utilization(ClusterConfig(E=3, Q=2), n_rounds=n_rounds))


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    print(f"model: {arch_config(args.preset).param_count()/1e6:.1f}M params "
          f"(preset={args.preset})")
    if args.fresh:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    trainer = build_trainer(args, device)
    if trainer.start_step:
        print(f"resumed from checkpoint at step {trainer.start_step}")

    def log(step, metrics):
        print(f"step {step:4d}  loss={metrics['loss']:.4f}  "
              f"lr={metrics['lr']:.2e}  gnorm={metrics['grad_norm']:.2f}  "
              f"{metrics['step_time_s']*1e3:.0f} ms")

    end, hist = trainer.run(on_metrics=log)
    losses = [l for _, l in hist]
    if losses:
        print(f"\ndone at step {end}; loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}; rejected steps: {trainer.total_skips}")
    else:
        print(f"\ndone at step {end}; no step left to run")

    # --- what would quasi-sync buy this job at fleet scale? ----------------
    strict, elastic = fleet_estimate()
    print(f"\nfleet-scale quasi-sync estimate (8 hosts x 32 DP groups, "
          f"lognormal stragglers):")
    print(f"  strict sync  E0Q0: worker utilization "
          f"{strict.pe_utilization:.3f}")
    print(f"  quasi-sync   E3Q2: worker utilization "
          f"{elastic.pe_utilization:.3f} "
          f"({(elastic.pe_utilization/strict.pe_utilization-1)*100:+.1f}%)")
    return end, hist


if __name__ == "__main__":
    main()
