"""Zamba2 hybrid (port of ``repro/models/zamba_model.py``): a Mamba-2
backbone plus ONE shared attention+FFN block applied after every
``attn_every`` Mamba layers, with per-invocation input norms.

The parameter tree keeps the reference's structure and names: the Mamba
layers stacked (n_super, attn_every, ...), the shared ``shared_attn`` and
``shared_ffn`` unstacked, the per-invocation norms ``inv_norm`` and
``inv_ffn_norm`` stacked (n_super, ...).  Python loops over the two
stacked axes replace the reference's nested ``scan``.

The slab decode cache is the conv and SSM states of every Mamba layer,
(n_super, attn_every, B, ...) with the batch on axis 2, and a KV cache per
shared-attention invocation, (n_super, B, T, KH, hd).  ``loss_fn``'s
forward checkpoints each super-block (``models/remat.py``), as the
reference's outer scan body is ``jax.checkpoint``-ed.  The decode step
writes every layer's new state and K/V into the cache it is given IN
PLACE and returns it.  The family serves on the slab store only, from
exact-length prefill groups: its recurrent state integrates every token
it is given, and the module has no paged or multi-token verify path.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention, layers, mamba2, remat as remat_lib
from repro_torch.models.causal_lm import lm_loss, logits_from_hidden


def n_super(cfg) -> int:
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple "
                         f"of attn_every {cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


def init(gen: torch.Generator, cfg, device=None):
    """Random-init parameters from ``gen`` (the reference's tree)."""
    ns, ae, d = n_super(cfg), cfg.attn_every, cfg.d_model
    return {
        "embed": layers.init_embedding(gen, cfg.vocab_padded, d,
                                       device=device),
        "mamba": {"norm": layers.init_rmsnorm(d, (ns, ae), device),
                  "mixer": mamba2.init_mamba2(gen, cfg, (ns, ae), device)},
        "shared_attn": attention.init_attention(gen, cfg, device=device),
        "shared_ffn": layers.init_ffn(gen, d, cfg.d_ff, cfg.ffn_type,
                                      device=device),
        "inv_norm": layers.init_rmsnorm(d, (ns,), device),
        "inv_ffn_norm": layers.init_rmsnorm(d, (ns,), device),
        "final_norm": layers.init_rmsnorm(d, device=device),
        "lm_head": layers.init_dense(gen, d, cfg.vocab_padded,
                                     device=device),
    }


def cache_specs(cfg, B: int, cache_T: int):
    """{leaf name: (shape, dtype)} of the slab decode cache."""
    ns, ae = n_super(cfg), cfg.attn_every
    kv = (ns, B, cache_T, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "conv": ((ns, ae, B, cfg.ssm_conv_width - 1, mamba2.conv_dim(cfg)),
                 layers.DTYPE),
        "ssm": ((ns, ae, B, mamba2.n_ssm_heads(cfg), cfg.ssm_head_dim,
                 cfg.ssm_state), torch.float32),
        "k": (kv, layers.DTYPE),
        "v": (kv, layers.DTYPE),
    }


#: the slot/batch axis of every cache leaf
CACHE_BATCH_AXES = {"conv": 2, "ssm": 2, "k": 1, "v": 1}


def zeros_cache(cfg, B: int, cache_T: int, device):
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in cache_specs(cfg, B, cache_T).items()}


def _shared_block(params, x, cfg, mode, s, attend):
    """Invocation ``s`` of the shared attention+FFN block; ``attend(h)``
    is the attention sub-block's output on the normed input ``h``."""
    h = layers.rms_norm(layers.stack_slice(params["inv_norm"], s), x, cfg.norm_eps)
    x = x + attend(h)
    h = layers.rms_norm(layers.stack_slice(params["inv_ffn_norm"], s), x, cfg.norm_eps)
    return x + layers.ffn(params["shared_ffn"], h, cfg.ffn_type, mode,
                          cfg.matmul_backend)


def _train_super(params, x, cfg, mode, s, cos, sin):
    """Super-block ``s`` of the training forward: its Mamba-2 layers from
    a zero state, then the shared block; no state or K/V kept."""
    for a in range(cfg.attn_every):
        lp = layers.stack_slice(params["mamba"], s, a)
        h = layers.rms_norm(lp["norm"], x, cfg.norm_eps)
        x = x + mamba2.mamba2_block(lp["mixer"], h, cfg, mode)[0]

    def attend(h):
        return attention.attention_block(params["shared_attn"], h, cfg, mode,
                                         cos=cos, sin=sin)[0]

    return _shared_block(params, x, cfg, mode, s, attend)


def loss_fn(params, cfg, batch, *, remat: bool = True):
    """Next-token cross-entropy (final position masked; the reference
    applies no ``loss_mask`` here).  Returns (loss, {"ce_loss",
    "valid_tokens"}).  ``remat`` checkpoints each super-block while grad
    is on."""
    mode = cfg.matmul_mode
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = layers.embed(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    cos, sin = layers.rope_angles(positions, cfg.resolved_head_dim,
                                  cfg.rope_theta)
    for s in range(n_super(cfg)):
        x = remat_lib.checkpointed(_train_super, params, x, cfg, mode, s,
                                   cos, sin, enabled=remat)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    loss, n_valid = lm_loss(params, cfg, x, tokens)
    return loss, {"ce_loss": loss, "valid_tokens": n_valid}


def prefill(params, cfg, batch, cache_T: int):
    """Run the prompt from a zero state; return (last-position logits
    (B, V), cache with K/V padded to cache_T)."""
    mode = cfg.matmul_mode
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = layers.embed(params["embed"], tokens)
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    cos, sin = layers.rope_angles(positions, cfg.resolved_head_dim,
                                  cfg.rope_theta)
    cache = zeros_cache(cfg, B, max(cache_T, S), dev)
    for s in range(n_super(cfg)):
        for a in range(cfg.attn_every):
            lp = layers.stack_slice(params["mamba"], s, a)
            h = layers.rms_norm(lp["norm"], x, cfg.norm_eps)
            y, conv_s, ssm_s = mamba2.mamba2_block(lp["mixer"], h, cfg, mode)
            x = x + y
            cache["conv"][s, a] = conv_s
            cache["ssm"][s, a] = ssm_s

        def attend(h):
            out, (k, v) = attention.attention_block(
                params["shared_attn"], h, cfg, mode, cos=cos, sin=sin)
            cache["k"][s, :, :S] = k
            cache["v"][s, :, :S] = v
            return out

        x = _shared_block(params, x, cfg, mode, s, attend)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_from_hidden(params, cfg, x[:, -1:, :])[:, 0]
    return logits, cache


def decode_step(params, cfg, batch):
    """One-token decode.  batch: tokens (B, 1), cache (updated in place),
    cache_len: int or (B,).  Returns (logits (B, V), cache)."""
    mode = cfg.matmul_mode
    tokens, cache, cache_len = batch["tokens"], batch["cache"], \
        batch["cache_len"]
    B = tokens.shape[0]
    hd = cfg.resolved_head_dim
    x = layers.embed(params["embed"], tokens)
    pos = attention.decode_positions(cache_len, B, device=tokens.device)
    cos, sin = layers.rope_angles(pos, hd, cfg.rope_theta)
    sa = params["shared_attn"]
    for s in range(n_super(cfg)):
        for a in range(cfg.attn_every):
            lp = layers.stack_slice(params["mamba"], s, a)
            h = layers.rms_norm(lp["norm"], x, cfg.norm_eps)
            y, conv_s, ssm_s = mamba2.mamba2_block(
                lp["mixer"], h, cfg, mode, conv_state=cache["conv"][s, a],
                ssm_state=cache["ssm"][s, a], single_step=True)
            x = x + y
            cache["conv"][s, a] = conv_s
            cache["ssm"][s, a] = ssm_s

        def attend(h):
            q, k, v = attention.qkv_proj(sa, h, cfg, mode)
            q = layers.apply_rope(q, cos, sin)
            k = layers.apply_rope(k, cos, sin)
            kc = attention.write_kv(cache["k"][s], k, cache_len)
            vc = attention.write_kv(cache["v"][s], v, cache_len)
            out = attention.decode_attention(q, kc, vc, cache_len)
            return layers.dense(sa["wo"], out.reshape(B, 1,
                                                      cfg.num_heads * hd),
                                mode, cfg.matmul_backend)

        x = _shared_block(params, x, cfg, mode, s, attend)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x)[:, 0], cache

