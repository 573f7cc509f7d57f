"""Quantized matmul with BitParticle numerics (port of
``repro/core/bp_matmul.py``).

Modes:

  ``bf16``      plain mixed-precision matmul (the unquantized baseline).
  ``bp_exact``  W8A8 sign-magnitude int8 matmul; BitParticle's exact MAC is
                bit-identical to an integer multiply.
  ``bp_approx`` the paper's approximate MAC (drops IR groups {0} and {1,4}),
                factorized with signed low particles A0 = s(|A| & 3),
                A1 = s(|A|>>2 & 3), W0 = s(|W| & 3), Wlow4 = s(|W| & 15):

                    approx(A @ W) = A@W - A0@Wlow4 - 4*(A1@W0)

The backend is explicit: the config's ``matmul_backend`` travels with every
call (no process-wide switch).  ``auto`` launches the CUDA kernel of
``repro_torch.kernels.bitparticle_matmul`` for CUDA tensors and runs the
plain version for CPU tensors; ``plain`` runs the plain version anywhere;
``kernel`` forces the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant

MODES = ("bf16", "bp_exact", "bp_approx")


def signed_low_particles(q: torch.Tensor):
    """(q0, q1, qlow4): signed particles of the two low 2-bit groups.

    q0 = sign(q)*(|q| & 3), q1 = sign(q)*((|q| >> 2) & 3),
    qlow4 = sign(q)*(|q| & 15) = q0 + 4*q1.  All int32."""
    q = q.to(torch.int32)
    s = torch.sign(q)
    m = q.abs()
    q0 = s * (m & 3)
    q1 = s * ((m >> 2) & 3)
    return q0, q1, q0 + 4 * q1


def int_matmul(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact integer contraction (..., K) x (K, N) -> int32.

    Both operands are upcast first: ``int8 @ int8`` on the CPU returns int8
    and wraps.  CUDA has no integer matmul, so there the product is taken in
    float64, exact for every sum below 2^53 (|sum| <= 127^2 * K here)."""
    if a_q.is_cuda:
        return (a_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)
    return a_q.to(torch.int32) @ w_q.to(torch.int32)


def bp_matmul_int(a_q: torch.Tensor, w_q: torch.Tensor,
                  mode: str = "bp_exact") -> torch.Tensor:
    """Integer-domain BitParticle matmul: int8 operands -> int32."""
    acc = int_matmul(a_q, w_q)
    if mode == "bp_exact":
        return acc
    if mode == "bp_approx":
        a0, a1, _ = signed_low_particles(a_q)
        w0, _, wlow4 = signed_low_particles(w_q)
        corr = int_matmul(a0, wlow4) + 4 * int_matmul(a1, w0)
        return acc - corr
    raise ValueError(f"unknown integer mode: {mode}")


def quantized_matmul(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                     mode: str, backend: str = "auto") -> torch.Tensor:
    """Dequantizing BitParticle matmul (forward only).

    x: (..., K) float; w: (K, N) int8 (pre-quantized, per-channel w_scale
    (N,)).  Activations are quantized PER ROW in x's own dtype (one scale
    per token position), so each row's numerics are independent of the rest
    of the batch.  The epilogue is ``float(acc) * (x_scale * w_scale)`` in
    float32, cast to x.dtype.  Returns (..., N) in x.dtype."""
    from repro_torch.kernels.bitparticle_matmul.ops import bp_matmul
    x_scale = quant.compute_scale(x, axis=(-1,))   # (..., 1) per-row
    x_q = quant.quantize(x, x_scale)
    out = bp_matmul(x_q, w, x_scale, w_scale, approx=(mode == "bp_approx"),
                    backend=backend)
    return out.to(x.dtype)


def dense_apply(x: torch.Tensor, w_f: torch.Tensor,
                mode: str) -> torch.Tensor:
    """Dense layer forward on float weights: the ``bf16`` mode's plain
    matmul.  The bp_* modes take int8 weights quantized once
    (``models/layers.py::quantize_dense_params``); quantizing float weights
    on every call, as training's fake-quant path does, is not ported."""
    if mode != "bf16":
        raise NotImplementedError(
            f"matmul mode {mode!r} on float weights is not ported; quantize "
            f"the weights first (quantize_dense_params)")
    return x @ w_f
