"""Wrapper around the BitParticle matmul CUDA kernel (port of
``repro/kernels/bitparticle_matmul/ops.py::bp_matmul``).

``bp_matmul`` checks device, dtype, shape, layout and contiguity, allocates
the output, launches the kernel on PyTorch's current stream and counts the
launch in :data:`LAUNCHES`.  Backends:

  ``auto``    the kernel for CUDA tensors, the plain version (``ref.py``)
              for CPU tensors: the choice follows where the tensor lies,
              never whether the kernel builds;
  ``kernel``  the kernel; a CPU tensor raises;
  ``plain``   the plain version on any device (the card's A/B reference).

There is no fallback: a failed build or launch raises.

Unlike the TPU wrapper there is no host-side padding (the kernel masks
ragged edges itself) and the weight must be K-major: ``w_q`` is the logical
(K, N) weight whose storage is (N, K) row-major, i.e. ``w_q.stride() ==
(1, K)``.  :func:`kmajor` makes that copy once; the serving engine applies
it when it quantizes the weights.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.bitparticle_matmul import ref

BACKENDS = ("auto", "plain", "kernel")

#: kernel launches since the last :func:`reset_launches` (plain-version
#: calls are not counted)
LAUNCHES = {"bp_matmul": 0}


def reset_launches() -> None:
    LAUNCHES["bp_matmul"] = 0


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """The same logical (..., K, N) weight with K-major storage: each
    (K, N) matrix is stored as (N, K) row-major (strides (1, K))."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def is_kmajor(w: torch.Tensor) -> bool:
    k, n = w.shape[-2:]
    return w.stride(-2) == 1 and (w.stride(-1) == k or n == 1)


def _use_kernel(a_q: torch.Tensor, backend: str) -> bool:
    if backend == "plain":
        return False
    if backend == "kernel":
        if not a_q.is_cuda:
            raise ValueError("matmul backend 'kernel' needs CUDA tensors")
        return True
    if backend == "auto":
        return a_q.is_cuda
    raise ValueError(f"unknown matmul backend {backend!r}; expected one of "
                     f"{BACKENDS}")


def bp_matmul(a_q: torch.Tensor, w_q: torch.Tensor,
              scale_a: Optional[torch.Tensor] = None,
              scale_w: Optional[torch.Tensor] = None, *,
              approx: bool = False, backend: str = "auto") -> torch.Tensor:
    """BitParticle quantized matmul.

    a_q: (..., K) int8 activations; w_q: (K, N) int8 weights (K-major for
    the kernel).  scale_a: (..., 1) or (...,) per-row and scale_w: (N,),
    both or neither.  Returns float32 (..., N) with both (fused dequant),
    else the raw int32 accumulators."""
    *lead, k = a_q.shape
    if w_q.ndim != 2 or w_q.shape[0] != k:
        raise ValueError(f"shape mismatch: a {tuple(a_q.shape)} w "
                         f"{tuple(w_q.shape)}")
    n = w_q.shape[1]
    mode = "bp_approx" if approx else "bp_exact"
    fuse = scale_a is not None
    if fuse != (scale_w is not None):
        raise ValueError("give both scales (fused dequant) or neither")
    if not _use_kernel(a_q, backend):
        if fuse:
            return ref.bp_matmul_dequant_ref(a_q, w_q, scale_a, scale_w, mode)
        return ref.bp_matmul_ref(a_q, w_q, mode)

    m = 1
    for d in lead:
        m *= d
    dev = a_q.device
    if a_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"bp_matmul takes int8 operands, got {a_q.dtype} and "
                        f"{w_q.dtype}")
    if w_q.device != dev:
        raise ValueError(f"operands on different devices: {dev} and "
                         f"{w_q.device}")
    if not is_kmajor(w_q):
        raise ValueError(f"the kernel takes a K-major weight (strides (1, "
                         f"{k})), got strides {w_q.stride()}; see kmajor()")
    a2 = a_q.reshape(m, k)
    if not a2.is_contiguous():
        raise ValueError("activations must be contiguous")
    sa = sw = None
    if fuse:
        sa = scale_a.to(torch.float32).reshape(-1)
        sw = scale_w.to(torch.float32).reshape(-1)
        if sa.numel() != m or sw.numel() != n:
            raise ValueError(f"scale shapes {tuple(sa.shape)}/"
                             f"{tuple(sw.shape)} do not match ({m}, {n})")
        if sa.device != dev or sw.device != dev:
            raise ValueError("scales must lie on the operands' device")
        sa, sw = sa.contiguous(), sw.contiguous()
    out = torch.empty(m, n, device=dev,
                      dtype=torch.float32 if fuse else torch.int32)
    if m == 0:
        return out.reshape(*lead, n)
    vec = (k % 16 == 0 and a2.data_ptr() % 16 == 0
           and w_q.data_ptr() % 16 == 0)
    from repro_torch.kernels.bitparticle_matmul.build import library
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bp_matmul_launch(
            ctypes.c_void_p(a2.data_ptr()), ctypes.c_void_p(w_q.data_ptr()),
            ctypes.c_void_p(sa.data_ptr() if fuse else 0),
            ctypes.c_void_p(sw.data_ptr() if fuse else 0),
            ctypes.c_void_p(out.data_ptr()), m, n, k, int(approx), int(fuse),
            int(vec), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"bp_matmul kernel launch failed: CUDA error {rc}")
    LAUNCHES["bp_matmul"] += 1
    return out.reshape(*lead, n)
