"""Decoder-only causal LM, dense family (port of
``repro/models/causal_lm.py``).

Layer parameters are stacked on a leading L axis exactly as the reference's
``lax.scan`` layout; the forward pass is a Python loop over that axis.  The
slab KV cache leaves are (L, B, T, KH, hd) (+ (L, B, T, KH) float32 scales
with ``kv_cache_int8``); the decode and verify steps write the new tokens'
K/V into the given cache IN PLACE (the reference donates the buffer and gets
a new one back) and return it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention, layers


def init(gen: torch.Generator, cfg, device=None):
    """Random-init parameters from ``gen`` (same structure as the
    reference's pytree: every layer leaf has a leading L axis)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    L = cfg.num_layers
    params = {
        "embed": layers.init_embedding(gen, cfg.vocab_padded, cfg.d_model,
                                       device=device),
        "layers": {
            "attn_norm": layers.init_rmsnorm(cfg.d_model, (L,), device),
            "attn": attention.init_attention(gen, cfg, (L,), device),
            "ffn_norm": layers.init_rmsnorm(cfg.d_model, (L,), device),
            "ffn": layers.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_type,
                                   (L,), device),
        },
        "final_norm": layers.init_rmsnorm(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_dense(gen, cfg.d_model,
                                              cfg.vocab_padded, device=device)
    return params


def layer_params(params, l: int):
    """Layer ``l``'s slice of the stacked layer tree (views, no copies)."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[l]
    return take(params["layers"])


def _angles(cfg, positions: torch.Tensor):
    return layers.rope_angles(positions, cfg.resolved_head_dim,
                              cfg.rope_theta)


def _block(lp, x, cfg, mode, cos, sin):
    h = layers.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
    attn_out, kv = attention.attention_block(lp["attn"], h, cfg, mode,
                                             cos=cos, sin=sin)
    x = x + attn_out
    h = layers.rms_norm(lp["ffn_norm"], x, cfg.norm_eps)
    x = x + layers.ffn(lp["ffn"], h, cfg.ffn_type, mode, cfg.matmul_backend)
    return x, kv


def cache_specs(cfg, B: int, cache_T: int):
    """{leaf name: (shape, dtype)} of the slab KV cache."""
    kv = (cfg.num_layers, B, cache_T, cfg.num_kv_heads,
          cfg.resolved_head_dim)
    if cfg.kv_cache_int8:
        sc = kv[:-1]
        return {"k": (kv, torch.int8), "k_scale": (sc, torch.float32),
                "v": (kv, torch.int8), "v_scale": (sc, torch.float32)}
    return {"k": (kv, layers.DTYPE), "v": (kv, layers.DTYPE)}


def zeros_cache(cfg, B: int, cache_T: int, device):
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in cache_specs(cfg, B, cache_T).items()}


def forward(params, cfg, batch, *, return_cache: bool = False,
            cache_T: Optional[int] = None):
    """Returns (hidden (B,S,D), cache|None)."""
    mode = cfg.matmul_mode
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = layers.embed(params["embed"], tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=dev)[None].expand(B, S)
    cos, sin = _angles(cfg, positions)
    cache = None
    if return_cache:
        cache = zeros_cache(cfg, B, max(cache_T or S, S), dev)
    for l in range(cfg.num_layers):
        x, (k, v) = _block(layer_params(params, l), x, cfg, mode, cos, sin)
        if return_cache:
            if cfg.kv_cache_int8:
                k, ks_, v, vs_ = attention.quantize_kv(k, v)
                cache["k_scale"][l, :, :S] = ks_
                cache["v_scale"][l, :, :S] = vs_
            cache["k"][l, :, :S] = k
            cache["v"][l, :, :S] = v
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, cache


def logits_from_hidden(params, cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], x)
    return layers.dense(params["lm_head"], x, cfg.matmul_mode,
                        cfg.matmul_backend)


def prefill(params, cfg, batch, cache_T: int, prompt_lens=None):
    """Run the prompt, return (last-position logits (B, V), KV cache padded
    to cache_T).  ``prompt_lens`` (B,) gathers each row's logits at its own
    last valid position (ragged right-padded batches)."""
    x, cache = forward(params, cfg, batch, return_cache=True, cache_T=cache_T)
    if prompt_lens is None:
        last = x[:, -1:, :]
    else:
        idx = torch.as_tensor(prompt_lens, device=x.device).long() - 1
        last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    logits = logits_from_hidden(params, cfg, last)[:, 0]
    return logits, cache


def _decode_common(params, cfg, batch, *, write_fn, attend_fn):
    """Shared decode/verify body over S >= 1 appended tokens.  Returns
    (logits (B, S, V), cache) with the cache updated in place."""
    mode = cfg.matmul_mode
    tokens, cache = batch["tokens"], batch["cache"]
    B, S = tokens.shape
    dev = tokens.device
    x = layers.embed(params["embed"], tokens)
    pos = attention.decode_positions(batch["cache_len"], B, S, device=dev)
    cos, sin = _angles(cfg, pos)
    hd = cfg.resolved_head_dim
    int8kv = cfg.kv_cache_int8
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        h = layers.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q, k, v = attention.qkv_proj(lp["attn"], h, cfg, mode)
        q = layers.apply_rope(q, cos, sin)
        k = layers.apply_rope(k, cos, sin)
        ksc = vsc = None
        if int8kv:
            k, ks_, v, vs_ = attention.quantize_kv(k, v)
            ksc = write_fn(cache["k_scale"][l], ks_)
            vsc = write_fn(cache["v_scale"][l], vs_)
        kc = write_fn(cache["k"][l], k)
        vc = write_fn(cache["v"][l], v)
        out = attend_fn(q, kc, vc, ksc, vsc).reshape(B, S,
                                                      cfg.num_heads * hd)
        x = x + layers.dense(lp["attn"]["wo"], out, mode, cfg.matmul_backend)
        h = layers.rms_norm(lp["ffn_norm"], x, cfg.norm_eps)
        x = x + layers.ffn(lp["ffn"], h, cfg.ffn_type, mode,
                           cfg.matmul_backend)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x), cache


def _slab_fns(batch):
    """(write_fn, attend_fn) over the slab cache layout."""
    cache_len = batch["cache_len"]

    def write_fn(c, new):
        return attention.write_kv(c, new, cache_len)

    def attend_fn(q, kc, vc, ksc, vsc):
        return attention.decode_attention(q, kc, vc, cache_len,
                                          k_scale=ksc, v_scale=vsc)

    return write_fn, attend_fn


def decode_step(params, cfg, batch):
    """One-token decode.  batch: tokens (B,1), cache (slab, updated in
    place), cache_len: int (whole batch at one depth) or (B,) tensor.
    Returns (logits (B,V), cache)."""
    write_fn, attend_fn = _slab_fns(batch)
    logits, cache = _decode_common(params, cfg, batch, write_fn=write_fn,
                                   attend_fn=attend_fn)
    return logits[:, 0], cache


def verify_step(params, cfg, batch):
    """Multi-token append at per-slot positions ``cache_len ..
    cache_len + S - 1`` in one pass.  Returns (logits (B, S, V), cache)."""
    write_fn, attend_fn = _slab_fns(batch)
    return _decode_common(params, cfg, batch, write_fn=write_fn,
                          attend_fn=attend_fn)
