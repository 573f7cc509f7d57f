"""Encoder-decoder, the ``audio`` family (port of
``repro/models/encdec.py``, seamless-m4t-medium): a bidirectional encoder
over precomputed modality-frontend frame embeddings (``src_embeds``; the
frontend is a stub) and a causal decoder with cross-attention.

The parameter tree keeps the reference's structure and names (``embed``,
``encoder`` and ``decoder`` with a leading layer axis on every leaf,
``enc_norm``, ``final_norm``, ``lm_head``).

The decode cache is the decoder's self-attention KV, (L, B, T, KH, hd),
the cross-attention K/V of the encoded source, (L, B, Se, KH, hd), and
``cross_len`` (B,) int32, each row's source length.  Decode attends to the
cross positions below ``cross_len`` only.  The reference has no such leaf:
its slot pool holds ``max(cache_T // 4, 128)`` cross positions, a shorter
source fills the leading ones, and decode attends to all of them, so a
short source reads zeros or an earlier occupant's K/V.  With the mask, a
serve of a short source gives the reference's ``generate()`` stream, and a
source that fills the pool's cross length gives the reference's serve.

``loss_fn`` is the training objective; its forward checkpoints each
encoder and decoder layer (``models/remat.py``), as the reference's two
scan bodies are ``jax.checkpoint``-ed.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention, layers, remat as remat_lib
from repro_torch.models.causal_lm import lm_loss, logits_from_hidden


def init(gen: torch.Generator, cfg, device=None):
    """Random-init parameters from ``gen`` (the reference's tree)."""
    d, Le, L = cfg.d_model, cfg.encoder_layers, cfg.num_layers
    kw = dict(device=device)
    embed = layers.init_embedding(gen, cfg.vocab_padded, d, **kw)
    encoder = {
        "attn_norm": layers.init_rmsnorm(d, (Le,), device),
        "attn": attention.init_attention(gen, cfg, (Le,), device),
        "ffn_norm": layers.init_rmsnorm(d, (Le,), device),
        "ffn": layers.init_ffn(gen, d, cfg.d_ff, cfg.ffn_type, (Le,),
                               device),
    }
    decoder = {
        "attn_norm": layers.init_rmsnorm(d, (L,), device),
        "attn": attention.init_attention(gen, cfg, (L,), device),
        "cross_norm": layers.init_rmsnorm(d, (L,), device),
        "cross": attention.init_attention(gen, cfg, (L,), device),
        "ffn_norm": layers.init_rmsnorm(d, (L,), device),
        "ffn": layers.init_ffn(gen, d, cfg.d_ff, cfg.ffn_type, (L,),
                               device),
    }
    return {"embed": embed, "encoder": encoder,
            "enc_norm": layers.init_rmsnorm(d, device=device),
            "decoder": decoder,
            "final_norm": layers.init_rmsnorm(d, device=device),
            "lm_head": layers.init_dense(gen, d, cfg.vocab_padded, **kw)}


def cross_T(cache_T: int) -> int:
    """Cross positions per slot of the serving pool (the reference's
    ``max(cache_T // 4, 128)``)."""
    return max(cache_T // 4, 128)


def cache_specs(cfg, B: int, cache_T: int):
    """{leaf name: (shape, dtype)} of the slab decode cache of an
    ``B``-slot pool."""
    kv = (cfg.num_layers, B, cache_T, cfg.num_kv_heads,
          cfg.resolved_head_dim)
    ckv = (cfg.num_layers, B, cross_T(cache_T), cfg.num_kv_heads,
           cfg.resolved_head_dim)
    return {"k": (kv, layers.DTYPE), "v": (kv, layers.DTYPE),
            "cross_k": (ckv, layers.DTYPE), "cross_v": (ckv, layers.DTYPE),
            "cross_len": ((B,), torch.int32)}


#: the slot/batch axis of every cache leaf
CACHE_BATCH_AXES = {"k": 1, "v": 1, "cross_k": 1, "cross_v": 1,
                    "cross_len": 0}
#: leaves whose prefill rows may be shorter than the pool's (axis 1 of the
#: row): the cross K/V of a source shorter than the pool's cross length
SHORT_ROW_LEAVES = ("cross_k", "cross_v")


def zeros_cache(cfg, B: int, cache_T: int, device):
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in cache_specs(cfg, B, cache_T).items()}


def _enc_layer(lp, x, cfg, mode, cos, sin):
    h = layers.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
    out, _ = attention.attention_block(lp["attn"], h, cfg, mode, cos=cos,
                                       sin=sin, causal=False)
    x = x + out
    h = layers.rms_norm(lp["ffn_norm"], x, cfg.norm_eps)
    return x + layers.ffn(lp["ffn"], h, cfg.ffn_type, mode,
                          cfg.matmul_backend)


def encode(params, cfg, src_embeds: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """src_embeds (B, Se, D) -> encoder output (B, Se, D): non-causal
    attention with RoPE over the frames.  ``remat`` checkpoints each layer
    while grad is on (the training forward)."""
    mode = cfg.matmul_mode
    B, Se, _ = src_embeds.shape
    x = src_embeds.to(layers.DTYPE)
    positions = torch.arange(Se, device=x.device)[None].expand(B, Se)
    cos, sin = layers.rope_angles(positions, cfg.resolved_head_dim,
                                  cfg.rope_theta)
    for l in range(cfg.encoder_layers):
        x = remat_lib.checkpointed(
            _enc_layer, layers.stack_slice(params["encoder"], l), x, cfg,
            mode, cos, sin, enabled=remat)
    return layers.rms_norm(params["enc_norm"], x, cfg.norm_eps)


def cross_kv(params, cfg, enc_out: torch.Tensor):
    """Every decoder layer's cross K/V: two (L, B, Se, KH, hd) tensors."""
    mode = cfg.matmul_mode
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.num_kv_heads, cfg.resolved_head_dim)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        cp = layers.stack_slice(params["decoder"], l)["cross"]
        ks.append(layers.dense(cp["wk"], enc_out, mode,
                               cfg.matmul_backend).reshape(shape))
        vs.append(layers.dense(cp["wv"], enc_out, mode,
                               cfg.matmul_backend).reshape(shape))
    return torch.stack(ks), torch.stack(vs)


def _cross(lp, x, cfg, mode, attend):
    """The cross-attention sub-block: ``attend(q)`` attends the queries to
    the layer's cross K/V."""
    B, hd = x.shape[0], cfg.resolved_head_dim
    h = layers.rms_norm(lp["cross_norm"], x, cfg.norm_eps)
    q = layers.dense(lp["cross"]["wq"], h, mode, cfg.matmul_backend).reshape(
        B, -1, cfg.num_heads, hd)
    out = attend(q).reshape(B, -1, cfg.num_heads * hd)
    return x + layers.dense(lp["cross"]["wo"], out, mode, cfg.matmul_backend)


def _ffn(lp, x, cfg, mode):
    h = layers.rms_norm(lp["ffn_norm"], x, cfg.norm_eps)
    return x + layers.ffn(lp["ffn"], h, cfg.ffn_type, mode,
                          cfg.matmul_backend)


def _train_dec_layer(lp, x, cfg, mode, cos, sin, ck, cv):
    """One decoder layer of the training forward; no K/V kept."""
    h = layers.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
    out, _ = attention.attention_block(lp["attn"], h, cfg, mode, cos=cos,
                                       sin=sin)
    x = _cross(lp, x + out, cfg, mode, lambda q: attention.flash_attention(
        q, ck, cv, causal=False))
    return _ffn(lp, x, cfg, mode)


def loss_fn(params, cfg, batch, *, remat: bool = True):
    """Next-token cross-entropy of the decoder over ``batch["tokens"]``
    given ``batch["src_embeds"]`` (final position masked; the reference
    applies no ``loss_mask`` here).  Returns (loss, {"ce_loss",
    "valid_tokens"}).  ``remat`` checkpoints each encoder and decoder
    layer while grad is on."""
    mode = cfg.matmul_mode
    tokens = batch["tokens"]
    B, S = tokens.shape
    cks, cvs = cross_kv(params, cfg, encode(params, cfg, batch["src_embeds"],
                                            remat=remat))
    x = layers.embed(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    cos, sin = layers.rope_angles(positions, cfg.resolved_head_dim,
                                  cfg.rope_theta)
    for l in range(cfg.num_layers):
        x = remat_lib.checkpointed(
            _train_dec_layer, layers.stack_slice(params["decoder"], l), x,
            cfg, mode, cos, sin, cks[l], cvs[l], enabled=remat)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    loss, n_valid = lm_loss(params, cfg, x, tokens)
    return loss, {"ce_loss": loss, "valid_tokens": n_valid}


def prefill(params, cfg, batch, cache_T: int, prompt_lens=None):
    """Encode ``batch["src_embeds"]`` and run the decoder prompt; return
    (last-position logits (B, V), cache): self K/V padded to cache_T, the
    cross K/V at the source's length, and ``cross_len``.  ``prompt_lens``
    (B,) gathers each row's logits at its own last valid position (ragged
    right-padded decoder prompts; causal self-attention keeps the valid
    rows independent of the padding)."""
    mode = cfg.matmul_mode
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    cks, cvs = cross_kv(params, cfg, encode(params, cfg,
                                            batch["src_embeds"]))
    x = layers.embed(params["embed"], tokens)
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    cos, sin = layers.rope_angles(positions, cfg.resolved_head_dim,
                                  cfg.rope_theta)
    T = max(cache_T, S)
    shape = (cfg.num_layers, B, T, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {"k": torch.zeros(shape, dtype=layers.DTYPE, device=dev),
             "v": torch.zeros(shape, dtype=layers.DTYPE, device=dev),
             "cross_k": cks, "cross_v": cvs,
             "cross_len": torch.full((B,), cks.shape[2], dtype=torch.int32,
                                     device=dev)}
    for l in range(cfg.num_layers):
        lp = layers.stack_slice(params["decoder"], l)
        h = layers.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        out, (k, v) = attention.attention_block(lp["attn"], h, cfg, mode,
                                                cos=cos, sin=sin)
        x = x + out
        cache["k"][l, :, :S] = k
        cache["v"][l, :, :S] = v
        x = _cross(lp, x, cfg, mode, lambda q, l=l: attention.flash_attention(
            q, cks[l], cvs[l], causal=False))
        x = _ffn(lp, x, cfg, mode)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if prompt_lens is None:
        last = x[:, -1:, :]
    else:
        idx = torch.as_tensor(prompt_lens, device=dev).long() - 1
        last = x[torch.arange(B, device=dev), idx][:, None]
    return logits_from_hidden(params, cfg, last)[:, 0], cache


def decode_step(params, cfg, batch):
    """One-token decode.  batch: tokens (B, 1), cache (self K/V updated in
    place), cache_len: int or (B,).  Cross-attention sees each row's
    positions below ``cross_len``.  Returns (logits (B, V), cache)."""
    mode = cfg.matmul_mode
    tokens, cache, cache_len = batch["tokens"], batch["cache"], \
        batch["cache_len"]
    B = tokens.shape[0]
    hd = cfg.resolved_head_dim
    x = layers.embed(params["embed"], tokens)
    pos = attention.decode_positions(cache_len, B, device=tokens.device)
    cos, sin = layers.rope_angles(pos, hd, cfg.rope_theta)
    cross_last = cache["cross_len"].long() - 1
    for l in range(cfg.num_layers):
        lp = layers.stack_slice(params["decoder"], l)
        h = layers.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q, k, v = attention.qkv_proj(lp["attn"], h, cfg, mode)
        q = layers.apply_rope(q, cos, sin)
        k = layers.apply_rope(k, cos, sin)
        kc = attention.write_kv(cache["k"][l], k, cache_len)
        vc = attention.write_kv(cache["v"][l], v, cache_len)
        out = attention.decode_attention(q, kc, vc, cache_len)
        x = x + layers.dense(lp["attn"]["wo"],
                             out.reshape(B, 1, cfg.num_heads * hd), mode,
                             cfg.matmul_backend)
        x = _cross(lp, x, cfg, mode, lambda q, l=l: attention.decode_attention(
            q, cache["cross_k"][l], cache["cross_v"][l], cross_last))
        x = _ffn(lp, x, cfg, mode)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x)[:, 0], cache
