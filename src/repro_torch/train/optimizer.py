"""AdamW with float32 master params, global-norm clipping and a cosine
schedule (port of ``repro/train/optimizer.py``).

The state mirrors the reference's pytree, ``{"step", "m", "v",
"master"}`` with ``m``, ``v`` and ``master`` float32 trees shaped like the
params, so a checkpoint of it has the reference's leaf paths.  The update
runs in place under ``no_grad`` (the reference returns new trees into
donated buffers): ``m``, ``v`` and ``master`` are updated leaf by leaf and
each param is cast from its master, keeping its dtype (bf16).  A caller
that may reject the step (``train_loop``) decides before calling
:func:`apply_updates`, so a rejected step touches nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.tree import leaf_paths, leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine down to ``min_lr_ratio``
    of it at ``total_steps``; a float32 scalar (on the CPU), computed in
    float32 as the reference computes it."""
    step = _f32(step)
    warm = cfg.peak_lr * torch.clamp_max(
        step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_f32(math.pi) * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_state(params) -> Dict[str, Any]:
    """Zero moments and a float32 master copy of every param (fresh
    buffers, on the params' devices)."""
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                    device=p.device)
    return {
        "step": torch.zeros((), dtype=torch.int32,
                            device=leaves(params)[0].device),
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "master": tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = None
    for g in leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _decay_mask(path: str) -> bool:
    """Decay 2D+ matrices; skip norms/biases/1D tables-of-scalars (by the
    reference's path strings)."""
    return not any(s in path for s in ("norm", "scale", "bias", "ln", "_b"))


def update_metrics(cfg: OptimizerConfig, opt_state, grads):
    """(lr, grad_norm, clip scale) of the update ``grads`` would make from
    ``opt_state``; grad_norm is the pre-clip norm."""
    lr = lr_schedule(cfg, opt_state["step"].cpu() + 1)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    return lr, gnorm, scale


def bias_corrections(cfg: OptimizerConfig, opt_state):
    """Adam's (1 - b1^t, 1 - b2^t) for the step ``opt_state`` is about to
    take, as Python floats computed in float32."""
    step = opt_state["step"].cpu().to(torch.float32) + 1
    return (float(1 - _f32(cfg.b1) ** step),
            float(1 - _f32(cfg.b2) ** step))


@torch.no_grad()
def adamw_leaf(cfg: OptimizerConfig, path: str, p, g, m, v, master,
               scale, lr: float, bc1: float, bc2: float) -> None:
    """AdamW on one leaf (or one shard of it), in place: ``m``, ``v``,
    ``master``, and ``p`` cast from master.  ``scale`` is the clip scale
    of the whole gradient, ``lr`` and the bias corrections the step's."""
    g = g.to(torch.float32) * scale.to(g.device)
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    u = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
    if _decay_mask(path):
        u.add_(cfg.weight_decay * master)
    master.sub_(lr * u)
    p.copy_(master)


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, opt_state, grads):
    """One AdamW step, in place: ``opt_state``'s moments, master and step
    and ``params`` (cast from master).  Returns (params, opt_state,
    {"lr", "grad_norm"})."""
    lr, gnorm, scale = update_metrics(cfg, opt_state, grads)
    bc1, bc2 = bias_corrections(cfg, opt_state)
    lr_f = float(lr)
    flat = zip(leaf_paths(params), leaves(grads), leaves(opt_state["m"]),
               leaves(opt_state["v"]), leaves(opt_state["master"]))
    for (path, p), g, m, v, master in flat:
        adamw_leaf(cfg, path, p, g, m, v, master, scale, lr_f, bc1, bc2)
    opt_state["step"] += 1
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
