"""Plain PyTorch version of the paged-attention decode kernel (port of
``repro/kernels/paged_attention/ref.py``).

Gathers each sequence's pages into a dense (B, T, KH, D) view and runs the
arithmetic of the reference's gather oracle: the same einsum forms, the
same masking and the same float32 softmax.  The tests hold it against the
JAX package, and ``chip_smoke.py`` holds the CUDA kernel against it on the
card.  The serving path runs it for tensors on the CPU, for int8 KV scale
pages (the kernel gathers float pages only), or when the ``plain`` backend
is asked for by name.  :func:`paged_attention_state_plain` is the same for
the state variant (the reference kernel's ``return_state=True``), which a
split-KV mesh shard runs.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """(N, bs, ...) pages + (B, P) tables -> (B, P*bs, ...) dense view."""
    g = pages[block_tables.long()]                # (B, P, bs, ...)
    B, P, bs = g.shape[:3]
    return g.reshape(B, P * bs, *g.shape[3:])


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, *, k_scale_pages=None,
                          v_scale_pages=None) -> torch.Tensor:
    """q: (B, H, D); k_pages/v_pages: (N, bs, KH, D); block_tables: (B, P);
    lengths: (B,) last valid position (inclusive).  Optional int8-KV scale
    pages: (N, bs, KH).  Returns (B, H, D) in q.dtype."""
    B, H, D = q.shape
    KH = k_pages.shape[2]
    G = H // KH
    dev = q.device
    k = gather_pages(k_pages, block_tables)       # (B, T, KH, D)
    v = gather_pages(v_pages, block_tables)
    T = k.shape[1]
    scale = D ** -0.5
    qr = (q.to(torch.float32) * scale).reshape(B, KH, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qr, k.to(torch.float32))
    if k_scale_pages is not None:
        ks = gather_pages(k_scale_pages, block_tables)     # (B, T, KH)
        s = s * ks.permute(0, 2, 1)[:, :, None, :]
    lengths = torch.as_tensor(lengths, device=dev)
    valid = (torch.arange(T, device=dev)[None, :]
             <= lengths[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    if v_scale_pages is not None:
        vs = gather_pages(v_scale_pages, block_tables)
        p = p * vs.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkgt,btkd->bkgd", p, v.to(torch.float32))
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention_state_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                lengths: torch.Tensor):
    """The raw flash-decoding state of :func:`paged_attention_plain`
    without its normalization: (acc (B, KH, G, D), m (B, KH, G, 1), l (B,
    KH, G, 1)), all float32, with m the largest valid score, l the sum of
    e^(s - m) over valid positions and acc that sum's weighted values.  A
    row with no valid position (a negative length) gives the neutral state
    (0, -0.7 FLT_MAX, 0)."""
    B, H, D = q.shape
    KH = k_pages.shape[2]
    G = H // KH
    dev = q.device
    k = gather_pages(k_pages, block_tables)       # (B, T, KH, D)
    v = gather_pages(v_pages, block_tables)
    T = k.shape[1]
    qr = (q.to(torch.float32) * D ** -0.5).reshape(B, KH, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qr, k.to(torch.float32))
    lengths = torch.as_tensor(lengths, device=dev)
    valid = (torch.arange(T, device=dev)[None, :]
             <= lengths[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(s - m), 0.0)
    acc = torch.einsum("bkgt,btkd->bkgd", e, v.to(torch.float32))
    return acc, m, e.sum(dim=-1, keepdim=True)
