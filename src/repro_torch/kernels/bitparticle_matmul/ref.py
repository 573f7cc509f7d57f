"""Plain PyTorch version of the BitParticle matmul kernel.

The tests hold it against the JAX package, and ``chip_smoke.py`` holds the
CUDA kernel against it on the card.  The serving path runs it only for
tensors on the CPU, or when the ``plain`` backend is asked for by name.

The integer products are exact on both devices: int32 on the CPU, float64
on CUDA (which has no integer matmul); every partial sum is an integer below
127^2 * K < 2^53, so float64 represents it exactly.
"""

from __future__ import annotations

import torch

from repro_torch.core.bp_matmul import bp_matmul_int


def bp_matmul_ref(a_q: torch.Tensor, w_q: torch.Tensor,
                  mode: str = "bp_exact") -> torch.Tensor:
    """int32 reference: (..., K) int8 x (K, N) int8 -> (..., N) int32."""
    return bp_matmul_int(a_q, w_q, mode)


def bp_matmul_dequant_ref(a_q: torch.Tensor, w_q: torch.Tensor,
                          scale_a: torch.Tensor, scale_w: torch.Tensor,
                          mode: str = "bp_exact") -> torch.Tensor:
    """float32 reference with the fused dequant epilogue
    ``float(acc) * (scale_a * scale_w)``: the two scales are multiplied
    first, as in the reference's plain path, and the CUDA kernel does the
    same, so the two agree bit for bit.

    scale_a: (..., 1) or (...,) per-row; scale_w: (N,) per-channel."""
    acc = bp_matmul_ref(a_q, w_q, mode)
    sa = scale_a.to(torch.float32).reshape(*acc.shape[:-1], 1)
    sw = scale_w.to(torch.float32).reshape(w_q.shape[1])
    return acc.to(torch.float32) * (sa * sw)
