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
outputs and the state workspace, launches on PyTorch's current stream and
counts the call in :data:`LAUNCHES`.  The kernel has no backward (nor has
the reference's Pallas kernel): given inputs that need a gradient, every
backend but ``plain`` raises a ``KernelInputError``, so a training forward
takes the plain version only by naming it.  One call is two CUDA kernels,
``wkv6_state_kernel`` (the state chain, which writes the state in front of
every chunk to the workspace) and ``wkv6_chunk_kernel`` (every chunk's
output, launched as the first one's programmatic dependent), planned by
:func:`wkv6_plan`; the count is one per call.  Nothing falls back quietly:
a failed build or launch, or a shape the kernel does not take, raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import KernelError, KernelInputError
from repro_torch.kernels.wkv6 import ref
from repro_torch.launch import op_analysis

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
            raise KernelInputError("wkv6 backend 'kernel' needs CUDA tensors")
        return True
    if backend == "auto":
        return x.is_cuda
    raise ValueError(f"unknown wkv6 backend {backend!r}; expected one of "
                     f"{BACKENDS}")


#: blocks of the state chain per row, at most (each takes NP / col_blocks
#: of the padded value columns, a multiple of 8)
MAX_COL_BLOCKS = 4
#: a chunk's output rows are split over two blocks while R x chunks is at
#: most this many per SM
SPLIT_CHUNKS_PER_SM = 1.0
#: shared memory a block may use on sm_90 (227 KB)
SMEM_MAX = 232448


class WkvPlan(NamedTuple):
    """How one ``wkv6_rows`` call is cut (see ``csrc/wkv6.cu``).

    The state kernel's grid (x, y) = ``state_grid`` = (``col_blocks``,
    rows): block x of a row carries value columns [x C, (x + 1) C) of its
    state, C = N padded to 16 / ``col_blocks``, through all
    ``state_chunks_per_block`` chunks.  The chunk kernel's grid (x, y) =
    ``chunk_grid`` = (chunks x ``row_split``, rows): block x computes chunk
    x // ``row_split``, all N value columns, for the 16-step row
    sub-chunks ``sub_chunks[x % row_split]`` (``chunks_per_block`` 1).
    Both kernels' blocks have 256 threads.  ``workspace_bytes`` is the
    float32 state in front of every chunk that the first kernel writes and
    the second reads."""
    state_grid: tuple
    col_blocks: int
    state_chunks_per_block: int
    chunk_grid: tuple
    row_split: int
    sub_chunks: tuple
    chunks_per_block: int
    smem_state: int
    smem_chunk: int
    workspace_bytes: int


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=None)
def wkv6_plan(sms: int, R: int, T: int, N: int, chunk: int,
              esize: int = 2) -> WkvPlan:
    """The kernels' plan for R rows of T steps, head size N, r/k/v of
    ``esize`` bytes, on a card of ``sms`` SMs.

    The state chain is serial over a row's chunks, so its blocks are what
    the long prompt waits on: each row's state columns are split over the
    most blocks (1, 2 or 4; a multiple of 8 columns each, none empty)
    that keep the chain within one block per SM.  A chunk's output rows
    are split over two blocks (sub-chunks {0, 3} and {1, 2}: equal pair and
    product work) only at chunk 64 and only where the chunks are few
    (R x chunks <= :data:`SPLIT_CHUNKS_PER_SM` x sms): the halves share no
    work, but each reloads the chunk.  Shared-memory bytes mirror
    ``wkv6.cu``'s ``state_smem_bytes`` / ``chunk_smem_bytes`` (its launcher
    refuses a plan that disagrees)."""
    if chunk not in CHUNKS:
        raise ValueError(f"no wkv6 plan for chunk {chunk}: the kernel "
                         f"takes {CHUNKS}")
    if (R < 1 or T < 1 or N < 1 or N > MAX_N or N % 4 or T % chunk
            or esize not in (2, 4)):
        raise ValueError(f"no wkv6 plan for R={R}, T={T}, N={N}, chunk "
                         f"{chunk}, esize {esize}")
    L, NP = chunk, _pad16(N)
    nc = T // L
    cb = MAX_COL_BLOCKS
    while cb > 1 and (NP % (8 * cb) or N <= NP - NP // cb or R * cb > sms):
        cb //= 2
    split = 2 if L == 64 and R * nc <= SPLIT_CHUNKS_PER_SM * sms else 1
    ns = L // 16
    if split == 1:
        subs = (tuple(range(ns)),)
    else:
        subs = tuple((p, ns - 1 - p) for p in range(split))
    sa = NP + 4
    smem_state = (3 * L * (N * (esize + 4) + (NP // cb + 8) * esize)
                  + 8 * (L * (NP + 8) + NP))
    smem_chunk = (4 * (2 * L * sa + 2 * max(L, NP) * sa + NP + L)
                  + L * (N + 8) * esize
                  + max(2 * L * N * esize, 4 * L * (L + 4)))
    return WkvPlan(state_grid=(cb, R), col_blocks=cb,
                   state_chunks_per_block=nc, chunk_grid=(nc * split, R),
                   row_split=split, sub_chunks=subs, chunks_per_block=1,
                   smem_state=smem_state, smem_chunk=smem_chunk,
                   workspace_bytes=4 * R * nc * N * N)


def wkv6_rows(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
              chunk: int = 64, backend: str = "auto"):
    """Chunked WKV6 in kernel layout.  r/k/v: (R, T, N) float32 or
    bfloat16 (one dtype); log_w: (R, T, N) float32, <= 0; u: (R, N)
    float32; state: (R, N, N) float32.  ``T % chunk == 0``.  Returns
    (out (R, T, N) float32, state_out (R, N, N) float32); ``state`` is not
    modified.  An active ``op_analysis`` counts 4·R·T·N·(chunk + N)
    FLOPs: per chunk, two chunk x chunk x N products and two chunk x N x N
    ones."""
    R, T, N = r.shape
    with op_analysis.kernel_call("wkv6",
                                 flops=4.0 * R * T * N * (chunk + N)):
        return _wkv6_rows(r, k, v, log_w, u, state, chunk, backend)


def _wkv6_rows(r, k, v, log_w, u, state, chunk, backend):
    R, T, N = r.shape
    if (backend != "plain" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (r, k, v, log_w, u, state))):
        raise KernelInputError(
            "the wkv6 kernel has no backward: inputs that need a gradient "
            "take the plain version, named with backend='plain'")
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = wkv6_plan(sms, R, T, N, chunk, r.element_size())
    ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                     device=dev)
    from repro_torch.kernels.wkv6.build import library
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wkv6_launch(
            *(ctypes.c_void_p(t.data_ptr())
              for t in (r, k, v, log_w, u, state, out, s_out, ws)),
            R, T, N, chunk, plan.row_split, plan.col_blocks, code,
            plan.smem_state, plan.smem_chunk, ctypes.c_void_p(stream))
    if rc != 0:
        raise KernelError(f"wkv6 kernel launch failed: CUDA error {rc}")
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
