"""Wrappers around the chunked WKV6 CUDA kernel (port of
``repro/kernels/wkv6/ops.py::wkv6`` and ``kernel.py::wkv6_kernel``).

``wkv6_rows`` takes the kernel layout (rows R = batch * heads); ``wkv6`` the
model layout (B, S, H, N), with the reference's zero-padded tail.  Backends,
as the other kernels':

  ``auto``    the kernel for CUDA tensors, the plain version (``ref.py``)
              for CPU tensors;
  ``kernel``  the kernel; a CPU tensor raises;
  ``plain``   the plain version on any device (the card's A/B reference).

``wkv6_rows`` checks device, dtype, shape and contiguity, allocates the
outputs, launches the kernel on PyTorch's current stream and counts the
launch in :data:`LAUNCHES`.  Nothing falls back quietly: a failed build or
launch, or a shape the kernel does not take, raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import ref

BACKENDS = ("auto", "plain", "kernel")
#: chunk lengths the kernel takes (the reference tests' range)
CHUNKS = (16, 32, 64)
#: largest head size the kernel takes (its tiles cover at most 64 x 64)
MAX_N = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last :func:`reset_launches` (plain-version
#: calls are not counted)
LAUNCHES = {"wkv6": 0}


def reset_launches() -> None:
    LAUNCHES["wkv6"] = 0


def _use_kernel(x: torch.Tensor, backend: str) -> bool:
    if backend == "plain":
        return False
    if backend == "kernel":
        if not x.is_cuda:
            raise ValueError("wkv6 backend 'kernel' needs CUDA tensors")
        return True
    if backend == "auto":
        return x.is_cuda
    raise ValueError(f"unknown wkv6 backend {backend!r}; expected one of "
                     f"{BACKENDS}")


def n_split(dev: torch.device, R: int, N: int) -> int:
    """Blocks each row's value columns are split over: a power of two up
    to 4, as long as the blocks still fit one wave of one block per SM
    (every split recomputes the chunk's pair matrix, so more blocks than
    SMs only adds work) and each keeps at least 16 columns."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ns = 1
    while (ns < 4 and 2 * ns * R <= sms and N % (2 * ns) == 0
           and N // (2 * ns) >= 16 and (N // (2 * ns)) % 4 == 0):
        ns *= 2
    return ns


def wkv6_rows(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
              chunk: int = 64, backend: str = "auto"):
    """Chunked WKV6 in kernel layout.  r/k/v: (R, T, N) float32 or
    bfloat16 (one dtype); log_w: (R, T, N) float32, <= 0; u: (R, N)
    float32; state: (R, N, N) float32.  ``T % chunk == 0``.  Returns
    (out (R, T, N) float32, state_out (R, N, N) float32); ``state`` is not
    modified."""
    R, T, N = r.shape
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the "
                         f"chunk {chunk}")
    if not _use_kernel(r, backend):
        return ref.wkv6_chunked_plain(r, k, v, log_w, u, state, chunk)

    dev = r.device
    if chunk not in CHUNKS:
        raise ValueError(f"the wkv6 kernel takes chunk in {CHUNKS}, got "
                         f"{chunk}")
    if N > MAX_N or N % 4:
        raise ValueError(f"the wkv6 kernel takes a head size N <= {MAX_N} "
                         f"that is a multiple of 4, got {N}")
    if (k.shape != r.shape or v.shape != r.shape or log_w.shape != r.shape
            or u.shape != (R, N) or state.shape != (R, N, N)):
        raise ValueError(
            f"shape mismatch: r {tuple(r.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} log_w {tuple(log_w.shape)} u "
            f"{tuple(u.shape)} state {tuple(state.shape)}")
    code = _DTYPE_CODES.get(r.dtype)
    if code is None or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"the kernel takes r/k/v of one dtype, float32 or "
                        f"bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("log_w", log_w), ("u", u), ("state", state)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w),
                    ("u", u), ("state", state)):
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, r on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned (the kernel loads 4 elements at a "
                             f"time)")
    out = torch.empty((R, T, N), dtype=torch.float32, device=dev)
    s_out = torch.empty((R, N, N), dtype=torch.float32, device=dev)
    if R == 0:
        return out, s_out
    from repro_torch.kernels.wkv6.build import library
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wkv6_launch(
            *(ctypes.c_void_p(t.data_ptr())
              for t in (r, k, v, log_w, u, state, out, s_out)),
            R, T, N, chunk, n_split(dev, R, N), code,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc}")
    LAUNCHES["wkv6"] += 1
    return out, s_out


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
         chunk: int = 64, backend: str = "auto"):
    """Model-layout entry point, drop-in for ``rwkv6.wkv_chunked``.

    r/k/v/log_w (B, S, H, N); u (H, N); state (B, H, N, N) float32.  Any S:
    the tail is zero-padded to a multiple of ``chunk`` (zero k rows add
    nothing to the state; log_w 0 is decay 1, so the state passes through
    unchanged; outputs past S are dropped).  Returns (out (B, S, H, N)
    float32, state (B, H, N, N) float32)."""
    B, S, H, N = r.shape
    pad = (-S) % chunk

    def rows(t):
        return F.pad(t, (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3).reshape(
            B * H, S + pad, N).contiguous()

    out, s = wkv6_rows(rows(r), rows(k), rows(v), rows(log_w),
                       u.repeat(B, 1).contiguous(),
                       state.reshape(B * H, N, N).contiguous(),
                       chunk=chunk, backend=backend)
    out = out.reshape(B, H, S + pad, N).permute(0, 2, 1, 3)[:, :S]
    return out, s.reshape(B, H, N, N)
