"""Wrapper around the BitParticle matmul CUDA kernel (port of
``repro/kernels/bitparticle_matmul/ops.py::bp_matmul``).

``bp_matmul`` checks device, dtype, shape, layout and contiguity, allocates
the output, launches the kernel on PyTorch's current stream and counts the
launch in :data:`LAUNCHES` (every call under ``bp_matmul``, and under the
route it took: ``gemv`` or ``tile``).  Backends:

  ``auto``    the kernel for CUDA tensors, the plain version (``ref.py``)
              for CPU tensors: the choice follows where the tensor lies,
              never whether the kernel builds;
  ``kernel``  the kernel; a CPU tensor raises;
  ``plain``   the plain version on any device (the card's A/B reference).

There is no fallback: a failed build or launch raises.

Decode calls (at most :data:`GEMV_MAX_M` rows) take the kernel's split-K
GEMV, whose K slices :func:`gemv_plan` chooses from the shapes alone.  Its
split sums meet in an int32 workspace that the kernel leaves zeroed
(:func:`_workspace`, one per device, grown on demand); calls on one device
must therefore run on one stream at a time.  The serving path launches on
PyTorch's current stream, which is the device's default stream in every
thread (serve loops, their watchdog workers, front-door replicas), so the
calls of several host threads queue on that one stream in order.  The
workspace's growth and the launch counts are guarded by a lock, as host
state that several threads update.
Prefill calls (more rows) take the tensor-core tile kernels, whose tiles,
K split and ring :func:`tile_plan` chooses; the K slices of one output
tile run as a thread block cluster and sum through its shared memory.

Unlike the TPU wrapper there is no host-side padding (the kernel masks
ragged edges itself) and the weight must be K-major: ``w_q`` is the logical
(K, N) weight whose storage is (N, K) row-major, i.e. ``w_q.stride() ==
(1, K)``.  :func:`kmajor` makes that copy once; the serving engine applies
it when it quantizes the weights.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels.bitparticle_matmul import ref
from repro_torch.kernels.build import KernelError, KernelInputError

BACKENDS = ("auto", "plain", "kernel")

#: kernel launches since the last :func:`reset_launches` (plain-version
#: calls are not counted)
LAUNCHES = {"bp_matmul": 0, "gemv": 0, "tile": 0}

#: rows up to which the kernel takes its decode GEMV (``bp_gemv_kernel``)
GEMV_MAX_M = 8
#: warps of one GEMV block, and output columns of one warp
GEMV_WARPS = 8
GEMV_WARP_COLS = 4
#: shared memory a GEMV block may give its slice of A (and its particles)
GEMV_SMEM_A = 108 * 1024
#: GEMV blocks resident on each SM at once (the kernel's launch bounds)
GEMV_BLOCKS_PER_SM = 2
#: share of the resident warps that must get a part of a column group's K
#: range before the plan stops giving a column group more warps
GEMV_MIN_FILL = 0.7

#: the prefill tile kernels (M > GEMV_MAX_M): K bytes of one ring stage
TILE_K = 128
#: the (BM, BN) output tiles built for each route, largest first.  Exact
#: mode takes ``wgmma`` (``bp_wgmma_kernel``) on 64 x 64 tiles and up and
#: ``mma.sync`` (``bp_tile_kernel``) on the smaller ones, which give small
#: shapes more blocks; approx mode forms its particles in the ``mma.sync``
#: fragment registers on every tile.
TILE_SHAPES_WGMMA = ((128, 128), (128, 64), (64, 128), (64, 64))
TILE_SHAPES_MMA = ((32, 128), (32, 64))
TILE_SHAPES_APPROX = ((128, 128), (128, 64), (64, 128), (64, 64), (32, 128),
                      (32, 64))
#: shared memory a tile block's ring may take (two blocks fit an SM), and
#: the ring's depth in stages
TILE_SMEM = 96 * 1024
TILE_MIN_STAGES = 3
TILE_MAX_STAGES = 6
#: K slices of one output tile at most: they form one thread block cluster
TILE_MAX_SPLIT = 8
#: the plan's thresholds, fitted to a sweep of every tile x split at the
#: serves' prefill shapes on the H100 (``chip_smoke.py --tile-sweep``,
#: PERF.md): the tile is the largest whose grid gives TILE_FILL of the SMs
#: a block; where the tiles give fewer than TILE_SPLIT_FILL blocks per SM,
#: or K is longer than TILE_MAX_SLICE stages, K is split into a power of
#: two of slices (clusters of 3 or 6 blocks pack the SMs worse)
TILE_FILL = 0.25
TILE_SPLIT_FILL = 1.5
TILE_MAX_SLICE = 64

_WORKSPACE: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """The same logical (..., K, N) weight with K-major storage: each
    (K, N) matrix is stored as (N, K) row-major (strides (1, K))."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def is_kmajor(w: torch.Tensor) -> bool:
    k, n = w.shape[-2:]
    return w.stride(-2) == 1 and (w.stride(-1) == k or n == 1)


@functools.lru_cache(maxsize=None)
def gemv_plan(sms: int, m: int, n: int, k: int, approx: bool
              ) -> tuple[int, int, int, int]:
    """(wk, split, kslice, n_blocks) of the decode GEMV.  K is cut into
    ``split`` slices of ``kslice`` bytes, a multiple of 16 (so every slice
    of a ``vec`` call starts 16-byte aligned), covering K exactly: split *
    kslice >= k > (split - 1) * kslice; K is split across blocks only where
    the staged slice of A (three copies in approx mode) would outgrow
    :data:`GEMV_SMEM_A`.  A block's 8 warps are 8 / wk groups of 4 columns,
    and the wk warps of a group share its K range: the fewest (1, 2, 4 or
    8) that give :data:`GEMV_MIN_FILL` of the resident warps a part.  The
    ``n_blocks`` blocks of each slice, at most the resident ones, walk the
    column tiles."""
    if not 1 <= m <= GEMV_MAX_M or n < 1 or k < 1:
        raise ValueError(f"no GEMV plan for M={m}, N={n}, K={k}")
    mp = 4 if m <= 4 else 8     # the kernel's row counts
    cap = GEMV_SMEM_A // (mp * (3 if approx else 1)) // 16 * 16
    kslice = -(-k // -(-k // cap))
    kslice = -(-kslice // 16) * 16
    split = -(-k // kslice)
    resident = max(1, GEMV_BLOCKS_PER_SM * sms // split)
    groups = -(-n // GEMV_WARP_COLS)
    wk = GEMV_WARPS
    for cand in (1, 2, 4):
        if groups * cand >= GEMV_MIN_FILL * GEMV_WARPS * resident:
            wk = cand
            break
    tiles = -(-n // (GEMV_WARP_COLS * (GEMV_WARPS // wk)))
    return wk, split, kslice, min(tiles, resident)


def tile_uses_wgmma(bm: int, bn: int, approx: bool) -> bool:
    """Whether a tile plan's (bm, bn) runs on ``wgmma`` (else
    ``mma.sync``)."""
    return not approx and (bm, bn) in TILE_SHAPES_WGMMA


@functools.lru_cache(maxsize=None)
def tile_plan(sms: int, m: int, n: int, k: int, approx: bool
              ) -> tuple[int, int, int, int, int]:
    """(bm, bn, split, kslice, stages) of the prefill tile kernels.

    The tile is the first of the mode's tiles (exact: the ``wgmma`` ones,
    then the ``mma.sync`` ones; approx: its ``mma.sync`` ones; largest
    first) that is no taller than M's power of two (at least 32) and whose
    grid gives :data:`TILE_FILL` of the SMs a block, else the smallest.
    Where the tiles give fewer than :data:`TILE_SPLIT_FILL` blocks per SM,
    K is split across a cluster of blocks: about that many blocks per SM
    over the tiles, at least one slice per :data:`TILE_MAX_SLICE` stages of
    K, at most one per stage and :data:`TILE_MAX_SPLIT`, rounded down to a
    power of two.  ``kslice`` is a multiple of :data:`TILE_K` and covers K
    exactly: split * kslice >= k > (split - 1) * kslice.  The ring takes
    the stages that fit :data:`TILE_SMEM`, 3 to 6."""
    if m <= GEMV_MAX_M or n < 1 or k < 1:
        raise ValueError(f"no tile plan for M={m}, N={n}, K={k}")

    def tiles(t):
        return -(-m // t[0]) * -(-n // t[1])

    cap = max(32, 1 << (m - 1).bit_length())
    shapes = (TILE_SHAPES_APPROX if approx
              else TILE_SHAPES_WGMMA + TILE_SHAPES_MMA)
    cands = [t for t in shapes if t[0] <= cap]
    bm, bn = next((t for t in cands if tiles(t) >= TILE_FILL * sms),
                  cands[-1])
    steps = -(-k // TILE_K)
    want = 1
    if tiles((bm, bn)) < TILE_SPLIT_FILL * sms:
        want = max(min(int(TILE_SPLIT_FILL * sms / tiles((bm, bn)) + 0.5),
                       steps),
                   -(-steps // TILE_MAX_SLICE))
        want = 1 << (min(want, TILE_MAX_SPLIT).bit_length() - 1)
    kslice = -(-steps // want) * TILE_K
    split = -(-k // kslice)
    stages = max(TILE_MIN_STAGES,
                 min(TILE_MAX_STAGES, TILE_SMEM // ((bm + bn) * TILE_K)))
    return bm, bn, split, kslice, stages


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _workspace(dev: torch.device, m: int, n: int):
    """Zeroed int32 scratch for split sums (m * n) and per-tile arrival
    counters (at most one per 4 columns), kept per device; the kernel
    leaves both zero again."""
    tiles = -(-n // GEMV_WARP_COLS)
    with _LOCK:
        ws, cnt = _WORKSPACE.get(dev, (None, None))
        if ws is None or ws.numel() < m * n or cnt.numel() < tiles:
            ws = torch.zeros(max(m * n, 0 if ws is None else ws.numel()),
                             dtype=torch.int32, device=dev)
            cnt = torch.zeros(max(tiles, 0 if cnt is None else cnt.numel()),
                              dtype=torch.int32, device=dev)
            _WORKSPACE[dev] = (ws, cnt)
    return ws, cnt


def _use_kernel(a_q: torch.Tensor, backend: str) -> bool:
    if backend == "plain":
        return False
    if backend == "kernel":
        if not a_q.is_cuda:
            raise KernelInputError(
                "matmul backend 'kernel' needs CUDA tensors")
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
    sms = _sm_count(dev)
    from repro_torch.kernels.bitparticle_matmul.build import library
    lib = library()
    ptrs = [ctypes.c_void_p(t.data_ptr() if t is not None else 0)
            for t in (a2, w_q, sa, sw, out)]
    if m <= GEMV_MAX_M:
        route = "gemv"
        wk, split, kslice, n_blocks = gemv_plan(sms, m, n, k, bool(approx))
        ws, cnt = _workspace(dev, m, n) if split > 1 else (None, None)
        args = (split, kslice, wk, n_blocks,
                ctypes.c_void_p(0 if ws is None else ws.data_ptr()),
                ctypes.c_void_p(0 if cnt is None else cnt.data_ptr()))
        launch = lib.bp_matmul_launch
    else:
        route = "tile"
        args = tile_plan(sms, m, n, k, bool(approx))
        launch = lib.bp_tile_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(*ptrs, m, n, k, int(approx), int(fuse), int(vec), *args,
                    ctypes.c_void_p(stream))
    if rc != 0:
        raise KernelError(f"bp_matmul kernel launch failed ({route}): CUDA "
                          f"error {rc}")
    with _LOCK:
        LAUNCHES["bp_matmul"] += 1
        LAUNCHES[route] += 1
    return out.reshape(*lead, n)
