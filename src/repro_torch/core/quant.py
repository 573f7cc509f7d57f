"""Symmetric int8 quantization matched to BitParticle's sign-magnitude range
(port of ``repro/core/quant.py``).

Sign-magnitude int8 represents [-127, 127] (no -128), so every quantizer
clips symmetrically to +/-127.  Arithmetic stays in the input's dtype: for
bf16 activations both the scale and the division ``x / scale`` are bf16
operations, exactly as in the reference.  Dividing in float32 instead moves
about 8% of the rounded int8 values by one on real activations.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

QMAX = 127  # sign-magnitude int8 magnitude range


def compute_scale(x: torch.Tensor, axis: Optional[Sequence[int]] = None,
                  eps: float = 1e-8) -> torch.Tensor:
    """max-abs symmetric scale so that x/scale lands in [-127, 127].

    ``axis=None`` -> per-tensor scalar scale.  Otherwise the reduction axes;
    kept dims are preserved so the scale broadcasts against ``x``."""
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=tuple(axis), keepdim=True)
    return torch.clamp_min(amax, eps) / QMAX


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round-half-to-even symmetric quantization to int8 in [-127, 127]."""
    q = torch.round(x / scale)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def quantize_per_channel(x: torch.Tensor, channel_axis: int = -1):
    """Per-channel scales along ``channel_axis`` (weights: output channel)."""
    axes = tuple(i for i in range(x.ndim) if i != channel_axis % x.ndim)
    scale = compute_scale(x, axis=axes)
    return quantize(x, scale), scale
