"""GPipe-style pipeline parallelism as a composable primitive (port of
``repro/distributed/pipeline.py``).

``pipeline_apply`` runs a homogeneous stage function over ``n_stages``
stages laid along a mesh axis with the classic GPipe schedule: at tick t,
stage s processes microbatch t - s and hands its output to stage s+1 on
that stage's shard device (the reference's ``ppermute`` rotation; counted
as a collective-permute by ``launch/op_analysis.py``); the last stage
banks each finished microbatch, and the result is returned on the mesh's
home device.  Stages keep their weights on their own shard and exchange
only (microbatch, ...) activations.  Backward is autograd through the
whole schedule, so ``stage_params`` (leading dim ``n_stages``) gets its
gradients in place of the reference's transposed permutation.

The reference computes every (stage, tick) pair and masks the inactive
ones to zero; the port skips them: the result and the gradients are the
same.  On the port's one-controller mesh every shard lies on one device
(``launch/mesh.py``), so the ticks and the stages within a tick run one
after another: there is no overlap, and the bubble of (S-1)/(M+S-1) costs
nothing.  Overlap needs stages on distinct cards, which need collectives
between cards, which are not ported.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.launch import op_analysis
from repro_torch.tree import tree_map


def _stage_index(mesh, axis_name: str, s: int) -> tuple:
    return tuple(s if a == axis_name else 0 for a in mesh.axis_names)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, axis_name: str = "model",
                   n_microbatches: int) -> torch.Tensor:
    """Run ``x`` through ``n_stages`` sequential stages, pipelined.

    stage_fn: (params_slice, activations) -> activations (same shape).
    stage_params: nested dict of tensors with leading dim = n_stages (or
    one tensor).  x: (global_batch, ...); global_batch % n_microbatches ==
    0.  Returns stage_{S-1}(... stage_0(x)) on the mesh's home device."""
    n_stages = mesh.shape[axis_name]
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} does not split into {n_microbatches} "
                         f"microbatches")
    mb = B // n_microbatches
    idx = [_stage_index(mesh, axis_name, s) for s in range(n_stages)]
    devs = [mesh.devices[i] for i in idx]
    params = [tree_map(lambda t, s=s: t[s].to(devs[s]), stage_params)
              for s in range(n_stages)]
    micro = x.reshape(n_microbatches, mb, *x.shape[1:])
    inbox = [None] * n_stages          # what each stage received last tick
    outputs = [None] * n_microbatches
    for t in range(n_microbatches + n_stages - 1):
        sent = [None] * n_stages
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_microbatches:
                continue               # an inactive (stage, tick): skipped
            inp = micro[m].to(devs[0]) if s == 0 else inbox[s]
            with op_analysis.on_shard(idx[s]):
                out = stage_fn(params[s], inp)
            if s == n_stages - 1:
                outputs[m] = out.to(mesh.home)
                if n_stages > 1:
                    _count_permute(out, "pipeline: bank")
            else:
                sent[s + 1] = out.to(devs[s + 1])
                _count_permute(out, "pipeline: hand-off")
        inbox = sent
    return torch.stack(outputs).reshape(B, *outputs[0].shape[1:])


def _count_permute(t: torch.Tensor, label: str) -> None:
    op_analysis.collective("collective-permute",
                           t.numel() * t.element_size(), label)
