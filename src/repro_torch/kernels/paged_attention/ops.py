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

The split-KV ``return_state`` variant of the reference (the mesh's
flash-decoding merge) is not ported.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.paged_attention import ref

BACKENDS = ("auto", "plain", "kernel")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: K/V rows one block of the kernel takes per step (its thread count)
_ROWS_PER_STEP = 128

#: kernel launches since the last :func:`reset_launches` (plain-version
#: calls are not counted)
LAUNCHES = {"paged_attention": 0}
#: calls on CUDA tensors that ``auto`` routed to the plain version, by reason
ROUTED_PLAIN = {"int8_kv": 0}


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
            raise ValueError("paged-attention backend 'kernel' needs CUDA "
                             "tensors")
        return True
    if backend == "auto":
        if not q.is_cuda:
            return False
        if scaled:
            ROUTED_PLAIN["int8_kv"] += 1
            return False
        return True
    raise ValueError(f"unknown paged-attention backend {backend!r}; "
                     f"expected one of {BACKENDS}")


def _n_split(dev: torch.device, B: int, KH: int, table_rows: int) -> int:
    """Blocks each (sequence, kv head) is split over: enough for about two
    blocks per SM, and no more than a full table has steps.  Decided from
    shapes only (the lengths stay on the device); a split whose pages lie
    past a sequence's length exits at once."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = -(-2 * sms // (B * KH))
    return max(1, min(want, -(-table_rows // _ROWS_PER_STEP)))


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
    n_split = _n_split(dev, B, KH, P * bs)
    part = (torch.empty(B * KH * n_split * (H // KH) * (D + 2),
                        dtype=torch.float32, device=dev)
            if n_split > 1 else None)
    from repro_torch.kernels.paged_attention.build import library
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_attention_launch(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k_pages.data_ptr()),
            ctypes.c_void_p(v_pages.data_ptr()),
            ctypes.c_void_p(tables.data_ptr()),
            ctypes.c_void_p(lens.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            B, H, KH, D, bs, P, ctypes.c_float(D ** -0.5), code, n_split,
            ctypes.c_void_p(0 if part is None else part.data_ptr()),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["paged_attention"] += 1
    return out
