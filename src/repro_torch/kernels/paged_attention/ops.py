"""Wrapper around the paged-attention decode CUDA kernel (port of
``repro/kernels/paged_attention/ops.py::paged_attention``).

``paged_attention`` checks device, dtype, shape and contiguity, allocates
the output, launches the kernel on PyTorch's current stream and counts the
launch in :data:`LAUNCHES`.  Backends, as the BitParticle matmul's:

  ``auto``    the kernel for CUDA tensors, the plain version (``ref.py``)
              for CPU tensors;
  ``kernel``  the kernel; a CPU tensor raises;
  ``plain``   the plain version on any device (the card's A/B reference).

int8 KV scale pages: the kernel gathers float pages only, so ``auto`` takes
the plain gather for them, which is the reference's route too, and counts
each such call in :data:`ROUTED_PLAIN` (``"int8_kv"``); ``kernel`` with
scale pages raises.  Nothing falls back quietly: a failed build or launch
raises.

Each sequence's positions are split over several blocks, planned from
shapes only by :func:`split_plan` (the lengths stay on the device); the
last block of a (sequence, kv head) merges the splits through an int32
arrival counter that the kernel leaves zeroed (:func:`_counters`, one
buffer per device, grown on demand), so calls on one device must run on one
stream at a time: every host thread of the serving path launches on the
device's default stream (see ``bitparticle_matmul/ops.py``), and the
buffer's growth and the counts are guarded by a lock.

The split-KV ``return_state`` variant of the reference (the mesh's
flash-decoding merge) is not ported.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels.build import KernelError, KernelInputError
from repro_torch.kernels.paged_attention import ref

BACKENDS = ("auto", "plain", "kernel")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: K/V rows of one stage of the kernel's ring (8 warps x 16 rows)
STAGE_ROWS = 128
#: query rows of one kv head that one block takes (G is grouped by these)
MAX_GROUP = 8
#: padded bytes of one K/V row the kernel takes (16-byte chunks on 32 lanes)
MAX_ROW_BYTES = 512
#: most table entries one split may span (its copy in shared memory)
MAX_SPLIT_PAGES = 1024
#: most blocks one sequence's positions are split over
MAX_SPLITS = 128
#: blocks the plan counts as resident on one SM (bf16 at D 128: its
#: ring takes most of the SM's shared memory)
BLOCKS_PER_SM = 1
#: a block's fixed cost (ring fill, state merge), and the cross-split merge
#: of the last block, in stage times
BLOCK_OVERHEAD_STAGES = 1
MERGE_STAGES = 1

#: kernel launches since the last :func:`reset_launches` (plain-version
#: calls are not counted)
LAUNCHES = {"paged_attention": 0}
#: calls on CUDA tensors that ``auto`` routed to the plain version, by reason
ROUTED_PLAIN = {"int8_kv": 0}

_COUNTERS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES["paged_attention"] = 0
    ROUTED_PLAIN["int8_kv"] = 0


def _use_kernel(q: torch.Tensor, backend: str, scaled: bool) -> bool:
    if backend == "plain":
        return False
    if backend == "kernel":
        if scaled:
            raise ValueError("the paged-attention kernel gathers float pages "
                             "only; int8 KV scale pages take the 'plain' or "
                             "'auto' backend")
        if not q.is_cuda:
            raise KernelInputError("paged-attention backend 'kernel' needs "
                                   "CUDA tensors")
        return True
    if backend == "auto":
        if not q.is_cuda:
            return False
        if scaled:
            with _LOCK:
                ROUTED_PLAIN["int8_kv"] += 1
            return False
        return True
    raise ValueError(f"unknown paged-attention backend {backend!r}; "
                     f"expected one of {BACKENDS}")


@functools.lru_cache(maxsize=None)
def split_plan(sms: int, heads: int, table_rows: int, bs: int
               ) -> tuple[int, int]:
    """(n_split, rows_per_split) for ``heads`` (sequence, kv head, query
    group) walks over ``table_rows`` positions: at most :data:`MAX_SPLITS`
    splits of whole ring stages (:data:`STAGE_ROWS`) that cover every
    position exactly once, chosen to minimise (rounds of resident blocks) x
    (stages per block + a block's fixed cost) + the merge where there is
    more than one split, fewer splits on a tie.  Decided from shapes only; a
    split whose positions lie past a sequence's length exits at once."""
    if heads < 1 or table_rows < 1 or bs < 1:
        raise ValueError(f"no split plan for {heads} walks over "
                         f"{table_rows} positions (block size {bs})")
    stages = -(-table_rows // STAGE_ROWS)
    resident = BLOCKS_PER_SM * sms
    best = None
    for n in range(1, min(stages, MAX_SPLITS) + 1):
        per = -(-stages // n)
        if -(-stages // per) != n:
            continue            # the same split as a smaller n
        if -(-per * STAGE_ROWS // bs) + 1 > MAX_SPLIT_PAGES:
            continue
        cost = (-(-heads * n // resident) * (per + BLOCK_OVERHEAD_STAGES)
                + (MERGE_STAGES if n > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, n, per * STAGE_ROWS)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """Zeroed int32 arrival counters, kept per device; the kernel leaves
    them zero again."""
    with _LOCK:
        cnt = _COUNTERS.get(dev)
        if cnt is None or cnt.numel() < n:
            cnt = torch.zeros(n, dtype=torch.int32, device=dev)
            _COUNTERS[dev] = cnt
    return cnt


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *, k_scale_pages=None,
                    v_scale_pages=None, backend: str = "auto"
                    ) -> torch.Tensor:
    """Paged decode attention.  q: (B, H, D); k_pages/v_pages: (N, bs, KH,
    D); block_tables: (B, P) page ids; lengths: (B,) last valid position
    (inclusive, any integer dtype).  Optional int8-KV scale pages (N, bs,
    KH).  Returns (B, H, D) in q.dtype."""
    scaled = k_scale_pages is not None or v_scale_pages is not None
    if not _use_kernel(q, backend, scaled):
        return ref.paged_attention_plain(
            q, k_pages, v_pages, block_tables, lengths,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)

    B, H, D = q.shape
    N, bs, KH, Dk = k_pages.shape
    P = block_tables.shape[-1]
    dev = q.device
    if (v_pages.shape != k_pages.shape or Dk != D or H % KH
            or block_tables.shape != (B, P) or lengths.shape != (B,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k_pages.shape)} "
            f"v {tuple(v_pages.shape)} tables {tuple(block_tables.shape)} "
            f"lengths {tuple(lengths.shape)}")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"the kernel takes q and pages of one dtype, float32 "
                        f"or bfloat16; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if D * q.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"the kernel takes rows of at most {MAX_ROW_BYTES} "
                         f"bytes; head dim {D} in {q.dtype} is larger")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the kernel reads int32 tables and lengths (the engine's positions are
    # int64): a no-op when they already are
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    G = H // KH
    n_groups = -(-G // MAX_GROUP)
    group = -(-G // n_groups)
    n_split, rows = split_plan(_sm_count(dev), B * KH * n_groups, P * bs, bs)
    part = cnt = None
    if n_split > 1:
        dp4 = -(-D // 4) * 4
        part = torch.empty(B * KH * n_groups * n_split * group * (dp4 + 2),
                           dtype=torch.float32, device=dev)
        cnt = _counters(dev, B * KH * n_groups)
    from repro_torch.kernels.paged_attention.build import library
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_attention_launch(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k_pages.data_ptr()),
            ctypes.c_void_p(v_pages.data_ptr()),
            ctypes.c_void_p(tables.data_ptr()),
            ctypes.c_void_p(lens.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            B, H, KH, D, bs, P, ctypes.c_float(D ** -0.5), code, n_groups,
            n_split, rows,
            ctypes.c_void_p(0 if part is None else part.data_ptr()),
            ctypes.c_void_p(0 if cnt is None else cnt.data_ptr()),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise KernelError(f"paged_attention kernel launch failed: CUDA "
                          f"error {rc}")
    with _LOCK:
        LAUNCHES["paged_attention"] += 1
    return out
