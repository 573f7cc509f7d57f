"""Quantized matmul with BitParticle numerics (port of
``repro/core/bp_matmul.py``).

Modes:

  ``bf16``      plain mixed-precision matmul (the unquantized baseline).
  ``qat``       quantization-aware training: fake-quant of both operands,
                then a plain matmul (``dense_apply``).
  ``bp_exact``  W8A8 sign-magnitude int8 matmul; BitParticle's exact MAC is
                bit-identical to an integer multiply.
  ``bp_approx`` the paper's approximate MAC (drops IR groups {0} and {1,4}),
                factorized with signed low particles A0 = s(|A| & 3),
                A1 = s(|A|>>2 & 3), W0 = s(|W| & 3), Wlow4 = s(|W| & 15):

                    approx(A @ W) = A@W - A0@Wlow4 - 4*(A1@W0)

The backend is explicit: the config's ``matmul_backend`` travels with every
call (no process-wide switch), and so does a mesh: a weight that the mesh
executor placed is a ``MeshWeight`` that carries its shards, and
``quantized_matmul`` runs it through ``bp_matmul_sharded``.  ``auto`` launches the CUDA kernel of
``repro_torch.kernels.bitparticle_matmul`` for CUDA tensors and runs the
plain version for CPU tensors; ``plain`` runs the plain version anywhere;
``kernel`` forces the kernel.
"""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.core import quant

MODES = ("bf16", "qat", "bp_exact", "bp_approx")


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


class QuantizedMatmul(torch.autograd.Function):
    """Dequantizing BitParticle matmul with the reference's straight-through
    gradient: the backward treats the product as ``x @ (w * w_scale)``, so
    ``gx = g @ (w * w_scale)^T`` in g's dtype, and the int8 weight and its
    scale get zero (the reference's ``_qmm_bwd``).  That product is plain
    PyTorch, as the reference computes it outside any kernel."""

    @staticmethod
    def forward(ctx, x, w, w_scale, mode, backend):
        from repro_torch.kernels.bitparticle_matmul.ops import (
            MeshWeight, bp_matmul, bp_matmul_sharded)
        x_scale = quant.compute_scale(x, axis=(-1,))   # (..., 1) per-row
        x_q = quant.quantize(x, x_scale)
        approx = mode == "bp_approx"
        if isinstance(w, MeshWeight):
            ctx.mesh = True
            out = bp_matmul_sharded(x_q, w, x_scale, approx=approx,
                                    backend=backend)
        else:
            ctx.mesh = False
            ctx.save_for_backward(w, w_scale)
            out = bp_matmul(x_q, w, x_scale, w_scale, approx=approx,
                            backend=backend)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.mesh:
            raise NotImplementedError(
                "the mesh-placed matmul has no backward: mesh weights serve")
        w, w_scale = ctx.saved_tensors
        gx = g @ (w.to(g.dtype) * w_scale.to(g.dtype)).t()
        g_scale = (torch.zeros_like(w_scale) if ctx.needs_input_grad[2]
                   else None)
        return gx, None, g_scale, None, None


def quantized_matmul(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                     mode: str, backend: str = "auto") -> torch.Tensor:
    """Dequantizing BitParticle matmul (:class:`QuantizedMatmul`).

    x: (..., K) float; w: (K, N) int8 (pre-quantized, per-channel w_scale
    (N,)).  Activations are quantized PER ROW in x's own dtype (one scale
    per token position), so each row's numerics are independent of the rest
    of the batch.  The epilogue is ``float(acc) * (x_scale * w_scale)`` in
    float32, cast to x.dtype.  A placed ``MeshWeight`` carries its own
    scale slices, and ``w_scale`` is then not read.  Returns (..., N) in
    x.dtype.

    With a tracer active (``repro_torch.tracing``) the call is a ``dense``
    span (args ``m``, ``k``, ``n``), timed on the device in a prefill: the
    activation quantizer, K1 and the dequantizing epilogue."""
    with (tracing.NULL_SPAN if tracing.local.tracer is None else
          tracing.device_span("dense", x, k=x.shape[-1], n=w.shape[-1],
                              m=x.numel() // max(x.shape[-1], 1))):
        return QuantizedMatmul.apply(x, w, w_scale, mode, backend)


class QuantizedGather(torch.autograd.Function):
    """Per-channel int8 quantize -> replicate -> dequantize, with the
    cotangent passed straight to the weight (the reference's
    ``quantized_gather``: int8 on the FSDP gather's wire).  On one device
    the replication is the identity."""

    @staticmethod
    def forward(ctx, w):
        wf = w.to(torch.float32)
        scale = quant.compute_scale(wf, axis=(0,))
        return quant.dequantize(quant.quantize(wf, scale), scale).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def quantized_gather(w: torch.Tensor) -> torch.Tensor:
    return QuantizedGather.apply(w)


GATHER_SUFFIX = "+q8gather"


def base_mode(mode: str) -> str:
    """``mode`` without the ``+q8gather`` suffix."""
    return mode[:-len(GATHER_SUFFIX)] if mode.endswith(GATHER_SUFFIX) \
        else mode


def dense_apply(x: torch.Tensor, w_f: torch.Tensor, mode: str,
                backend: str = "auto") -> torch.Tensor:
    """Dense layer on float weights, mode-dependent (the reference's
    ``dense_apply``):

      ``bf16``      plain matmul;
      ``qat``       fake-quant of both operands, the weight per output
                    channel (scales over axis 0), the activation with ONE
                    per-tensor scale, then a plain matmul; the gradient
                    reaches the float weight through the STE;
      ``bp_*``      the weight quantized per output channel on every call,
                    made K-major, then :func:`quantized_matmul` (the kernel
                    on CUDA tensors).  Its STE gives the int8 weight a zero
                    gradient, so the float weight gets none: the weight is
                    detached, and it receives an exactly-zero gradient as in
                    the reference.

    The ``+q8gather`` suffix first routes the weight through
    :func:`quantized_gather`."""
    from repro_torch.kernels.bitparticle_matmul.ops import kmajor
    if mode.endswith(GATHER_SUFFIX):
        w_f = quantized_gather(w_f)
        mode = base_mode(mode)
    if w_f.dtype == torch.int8:
        raise ValueError("int8 weights must go through dense() with w_scale")
    if mode == "bf16":
        return x @ w_f
    if mode == "qat":
        # the scales' cotangents are zero (fake_quant's STE), so they are
        # taken off the graph
        wf = w_f.to(torch.float32)
        w_fq = quant.fake_quant(
            wf, quant.compute_scale(wf.detach(), axis=(0,))).to(x.dtype)
        xf = x.to(torch.float32)
        x_fq = quant.fake_quant(xf, quant.compute_scale(xf.detach())).to(
            x.dtype)
        return x_fq @ w_fq
    if mode not in ("bp_exact", "bp_approx"):
        raise ValueError(f"unknown matmul mode {mode!r}; expected one of "
                         f"{MODES}")
    w_q, w_scale = quant.quantize_per_channel(
        w_f.detach().to(torch.float32), channel_axis=-1)
    return quantized_matmul(x, kmajor(w_q), w_scale.reshape(-1), mode,
                            backend)
