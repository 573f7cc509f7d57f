"""Attention (port of ``repro/models/attention.py``): GQA projections,
chunked online-softmax prefill attention, and decode attention over the slab
KV cache (S >= 1 rows, scalar or per-slot ``cache_len``, int8 scales).

These are jnp code in the reference, not Pallas kernels, so they stay plain
PyTorch.  The contractions are written out as einsums with an explicit
softmax, as in the reference, so the numerics line up with it.

With a tracer active (``repro_torch.tracing``) the score, softmax and value
part of each attention call (not its projections) is an ``attention`` span,
timed on the device in a prefill, with args ``rows``, ``q_len`` and
``kv_len`` (the KV positions the call spans: the slab's or the block
table's capacity).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.models import layers

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def init_attention(gen, cfg, lead=(), device=None):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(lead=lead, device=device)
    return {
        "wq": layers.init_dense(gen, d, cfg.num_heads * hd,
                                bias=cfg.qkv_bias, **kw),
        "wk": layers.init_dense(gen, d, cfg.num_kv_heads * hd,
                                bias=cfg.qkv_bias, **kw),
        "wv": layers.init_dense(gen, d, cfg.num_kv_heads * hd,
                                bias=cfg.qkv_bias, **kw),
        "wo": layers.init_dense(gen, cfg.num_heads * hd, d, **kw),
    }


def qkv_proj(params, x: torch.Tensor, cfg, mode: str, probe=None):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    be = cfg.matmul_backend
    q = layers.dense(params["wq"], x, mode, be, probe).reshape(
        B, S, cfg.num_heads, hd)
    k = layers.dense(params["wk"], x, mode, be, probe).reshape(
        B, S, cfg.num_kv_heads, hd)
    v = layers.dense(params["wv"], x, mode, be, probe).reshape(
        B, S, cfg.num_kv_heads, hd)
    return q, k, v


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    chunk: int = 1024,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B,S,H,D); k/v (B,T,KH,D).  Returns (B,S,H,D).  Online softmax
    over KV chunks of ``min(chunk, T)`` positions (T must divide).  With a
    tracer active, an ``attention`` span."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of the chunk {chunk}")
    scale = D ** -0.5
    dev = q.device
    with (tracing.NULL_SPAN if tracing.local.tracer is None else
          tracing.device_span("attention", q, rows=B, q_len=S, kv_len=T)):
        qr = (q.to(torch.float32) * scale).reshape(B, S, KH, G, D)
        m = torch.full((B, S, KH, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, S, KH, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, S, KH, G, D), dtype=torch.float32, device=dev)
        qpos = q_offset + torch.arange(S, device=dev)
        for idx in range(T // chunk):
            ks = k[:, idx * chunk:(idx + 1) * chunk].to(torch.float32)
            vs = v[:, idx * chunk:(idx + 1) * chunk].to(torch.float32)
            s = torch.einsum("bskgd,bckd->bskgc", qr, ks)
            kpos = idx * chunk + torch.arange(chunk, device=dev)
            mask = torch.ones((S, chunk), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if kv_len is not None:
                mask &= kpos[None, :] < kv_len
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bskgc,bckd->bskgd", p, vs))
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-37)
        return out.reshape(B, S, H, D).to(q.dtype)


def _cache_len(cache_len, device) -> torch.Tensor:
    return torch.as_tensor(cache_len, device=device)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,S,H,D) against cache (B,T,KH,D).  Query row j sits at position
    ``cache_len + j`` and attends to cache positions ``<= cache_len + j``.
    ``cache_len`` is a scalar (whole batch at one depth) or a (B,) vector.

    int8 KV cache (per-token-per-head scales, exact factorization):
        score[b,kh,g,t] = (q . k_q[t]) * k_scale[b,t,kh]
        out = sum_t p[t] * v_scale[b,t,kh] * v_q[t]
    """
    B, S, H, D = q.shape
    T, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    dev = q.device
    scale = D ** -0.5
    with (tracing.NULL_SPAN if tracing.local.tracer is None else
          tracing.device_span("attention", q, rows=B, q_len=S, kv_len=T)):
        qr = (q.to(torch.float32) * scale).reshape(B, S, KH, G, D)
        s = torch.einsum("bskgd,btkd->bskgt", qr, k_cache.to(torch.float32))
        if k_scale is not None:
            s = s * k_scale.permute(0, 2, 1)[:, None, :, None, :]
        cl = _cache_len(cache_len, dev)
        t = torch.arange(T, device=dev)
        if cl.ndim == 0:
            lim = cache_len + torch.arange(S, device=dev)           # (S,)
            valid = (t[None, :] <= lim[:, None])[None, :, None, None, :]
        else:
            lim = cl[:, None] + torch.arange(S, device=dev)[None, :]  # (B,S)
            valid = (t[None, None, :]
                     <= lim[:, :, None])[:, :, None, None, :]
        s = torch.where(valid, s, NEG_INF)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        if v_scale is not None:
            p = p * v_scale.permute(0, 2, 1)[:, None, :, None, :]
        out = torch.einsum("bskgt,btkd->bskgd", p,
                           v_cache.to(torch.float32))
        return out.reshape(B, S, H, D).to(q.dtype)


def decode_positions(cache_len, B: int, S: int = 1,
                     device=None) -> torch.Tensor:
    """(B, S) RoPE positions: row j of slot b sits at ``cache_len[b] + j``
    (scalar ``cache_len`` = whole batch at one depth)."""
    cl = _cache_len(cache_len, device)
    ar = torch.arange(S, device=cl.device)
    if cl.ndim == 0:
        return (cl + ar)[None].expand(B, S)
    return cl[:, None] + ar[None, :]


def write_kv(cache: torch.Tensor, new: torch.Tensor,
             cache_len) -> torch.Tensor:
    """Write ``new`` (B, S, ...) into ``cache`` (B, T, ...) IN PLACE at
    positions ``cache_len .. cache_len + S - 1`` and return ``cache``.

    Mirrors the reference's scatter semantics: positions at or past T are
    DROPPED (a speculative tail past the slab capacity lands nowhere), where
    torch indexing would raise.  The one exception is the reference's
    scalar-position single-row write, a ``dynamic_update_slice`` whose start
    is clamped into range."""
    T = cache.shape[1]
    B, S = new.shape[0], new.shape[1]
    dev = cache.device
    new = new.to(cache.dtype)
    if isinstance(cache_len, int) or torch.as_tensor(cache_len).ndim == 0:
        start = int(cache_len)
        if S == 1:
            cache[:, min(max(start, 0), T - 1)] = new[:, 0]
            return cache
        lo, hi = max(start, 0), min(start + S, T)
        if hi > lo:
            cache[:, lo:hi] = new[:, lo - start:hi - start]
        return cache
    cl = cache_len.to(dev)
    bidx = torch.arange(B, device=dev)
    if S == 1:
        # one row per slot, so no two writes share a position: an
        # out-of-range row rewrites the clamped entry's own value, which
        # drops it without a host-side sync
        pos = torch.clamp(cl, 0, T - 1)
        keep = ((cl >= 0) & (cl < T)).reshape(B, *([1] * (new.ndim - 2)))
        cache[bidx, pos] = torch.where(keep, new[:, 0], cache[bidx, pos])
        return cache
    pos = cl[:, None] + torch.arange(S, device=dev)[None, :]
    keep = (pos >= 0) & (pos < T)
    cache[bidx[:, None].expand(B, S)[keep], pos[keep]] = new[keep]
    return cache


def paged_write_kv(pages: torch.Tensor, new: torch.Tensor,
                   block_ids: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, S, ...) into block-paged ``pages`` (N, bs, ...) IN
    PLACE at per-(sequence, row) (physical block, in-block offset)
    positions, both (B, S), and return ``pages``.  Inactive rows and
    speculative overhang past a slot's block table target the trash block
    (id 0): written, never read, so duplicate indices there are harmless."""
    pages[block_ids, offsets] = new.to(pages.dtype)
    return pages


def paged_verify_attention(q, k_pages, v_pages, block_tables, cache_len, *,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Multi-token verify attention over block-paged KV: gather each slot's
    pages dense through its block table, then the causal-wedge masking of
    :func:`decode_attention`.  The decode kernel takes one query row, so
    the S > 1 path has no kernel."""
    from repro_torch.kernels.paged_attention.ref import gather_pages

    def lin(p):
        return None if p is None else gather_pages(p, block_tables)

    return decode_attention(q, lin(k_pages), lin(v_pages), cache_len,
                            k_scale=lin(k_scale), v_scale=lin(v_scale))


def paged_decode_attention(q, k_pages, v_pages, block_tables, cache_len, *,
                           k_scale=None, v_scale=None,
                           backend: str = "auto", mesh=None) -> torch.Tensor:
    """q (B,1,H,D) against block-paged K/V (N, bs, KH, D) through per-slot
    block tables (B, P); positions <= cache_len valid, exactly as
    :func:`decode_attention`.  Dispatches to the paged-attention CUDA kernel
    or its plain version per ``backend`` (the config's matmul backend),
    split over ``mesh``'s shards when one is given."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    with (tracing.NULL_SPAN if tracing.local.tracer is None else
          tracing.device_span("attention", q, rows=q.shape[0], q_len=1,
                              kv_len=block_tables.shape[1]
                              * k_pages.shape[1])):
        out = paged_attention(q[:, 0].contiguous(), k_pages, v_pages,
                              block_tables, cache_len, k_scale_pages=k_scale,
                              v_scale_pages=v_scale, backend=backend,
                              mesh=mesh)
    return out[:, None]


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """Per (batch, position, head) symmetric int8 quantization of K/V.

    k/v (B, S, KH, D) -> (k_q int8, k_scale f32 (B,S,KH), v_q, v_scale)."""
    def one(t):
        tf = t.to(torch.float32)
        amax = tf.abs().amax(dim=-1)
        s = torch.clamp_min(amax, 1e-8) / 127.0
        q = torch.clamp(torch.round(tf / s[..., None]), -127, 127)
        return q.to(torch.int8), s

    kq, ks = one(k)
    vq, vs = one(v)
    return kq, ks, vq, vs


def attention_block(params, x: torch.Tensor, cfg, mode: str, *, cos, sin,
                    causal: bool = True, probe=None):
    """Attention sub-block for prefill; returns (out, (k, v))."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(params, x, cfg, mode, probe)
    if cos is not None:
        q = layers.apply_rope(q, cos, sin)
        k = layers.apply_rope(k, cos, sin)
    out = flash_attention(q, k, v, causal=causal)
    out = out.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim)
    return (layers.dense(params["wo"], out, mode, cfg.matmul_backend, probe),
            (k, v))
