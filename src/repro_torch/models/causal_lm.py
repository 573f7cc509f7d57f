"""Decoder-only causal LM: the dense, mixture-of-experts and
vision-language families (port of ``repro/models/causal_lm.py``).

The vision-language family (``vlm``, qwen2-vl-7b) is the dense model with
two additions: prefill splices precomputed patch embeddings
(``vision_embeds``, cast to bf16) into the token embeddings where
``vision_mask`` is set, and rotary angles are M-RoPE over (3, B, S)
positions (``layers.mrope_angles``).  A prefill without ``positions`` gets
the plain 0..S-1 on all three rows, and the decode and verify steps
continue every row at ``cache_len``, as the reference does.

Layer parameters are stacked on a leading L axis exactly as the reference's
``lax.scan`` layout; the forward pass is a Python loop over that axis.  The
slab KV cache leaves are (L, B, T, KH, hd) (+ (L, B, T, KH) float32 scales
with ``kv_cache_int8``), the block-paged ones (L, num_blocks, block_size,
KH, hd) (+ scales) addressed through per-slot block tables; the decode and
verify steps write the new tokens' K/V into the given cache IN PLACE (the
reference donates the buffer and gets a new one back) and return it.

``loss_fn`` is the training objective (next-token cross-entropy plus 0.01 x
the MoE aux loss); its forward checkpoints each layer
(``models/remat.py``), as the reference's scan body is
``jax.checkpoint``-ed.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention, layers, moe, remat as remat_lib


def init(gen: torch.Generator, cfg, device=None):
    """Random-init parameters from ``gen`` (same structure as the
    reference's pytree: every layer leaf has a leading L axis)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    L = cfg.num_layers
    # drawn in this order: the embedding, then the layers, then the head
    embed = layers.init_embedding(gen, cfg.vocab_padded, cfg.d_model,
                                  device=device)
    stack = {
        "attn_norm": layers.init_rmsnorm(cfg.d_model, (L,), device),
        "attn": attention.init_attention(gen, cfg, (L,), device),
        "ffn_norm": layers.init_rmsnorm(cfg.d_model, (L,), device),
    }
    if cfg.num_experts:
        stack["moe"] = moe.init_moe(gen, cfg, (L,), device)
    else:
        stack["ffn"] = layers.init_ffn(gen, cfg.d_model, cfg.d_ff,
                                       cfg.ffn_type, (L,), device)
    params = {
        "embed": embed,
        "layers": stack,
        "final_norm": layers.init_rmsnorm(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_dense(gen, cfg.d_model,
                                              cfg.vocab_padded, device=device)
    return params


def layer_params(params, l: int):
    """Layer ``l``'s slice of the stacked layer tree (views, no copies)."""
    return layers.stack_slice(params["layers"], l)


def _angles(cfg, positions: torch.Tensor):
    """positions: (B, S), or (3, B, S) for M-RoPE."""
    hd = cfg.resolved_head_dim
    if cfg.mrope_sections:
        if positions.ndim != 3:
            raise ValueError(f"M-RoPE takes (3, B, S) positions, got "
                             f"{tuple(positions.shape)}")
        return layers.mrope_angles(positions, hd, cfg.rope_theta,
                                   cfg.mrope_sections)
    return layers.rope_angles(positions, hd, cfg.rope_theta)


def _embed_inputs(params, cfg, batch):
    """(x (B, S, D), positions): the token embeddings with the vision
    splice, and the batch's positions or the default 0..S-1 (on three rows
    for M-RoPE)."""
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        x = torch.where(batch["vision_mask"][..., None],
                        batch["vision_embeds"].to(x.dtype), x)
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        if cfg.mrope_sections:
            positions = positions[None].expand(3, B, S)
    return x, positions


def _ffn(lp, h, cfg, mode, probe=None):
    """The layer's feed-forward: (out, aux loss or None)."""
    if cfg.num_experts:
        return moe.moe_ffn(lp["moe"], h, cfg, mode, probe)
    return layers.ffn(lp["ffn"], h, cfg.ffn_type, mode, cfg.matmul_backend,
                      probe), None


def _block(lp, x, cfg, mode, cos, sin, probe=None):
    h = layers.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
    attn_out, kv = attention.attention_block(lp["attn"], h, cfg, mode,
                                             cos=cos, sin=sin, probe=probe)
    x = x + attn_out
    h = layers.rms_norm(lp["ffn_norm"], x, cfg.norm_eps)
    f, aux = _ffn(lp, h, cfg, mode, probe)
    return x + f, kv, aux


def _train_block(lp, x, cfg, mode, cos, sin):
    """One layer of the training forward: (x, aux or None); no K/V kept."""
    x, _, aux = _block(lp, x, cfg, mode, cos, sin)
    return x, aux


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
            cache_T: Optional[int] = None, probe=None, remat: bool = False):
    """Returns (hidden (B,S,D), aux_loss, cache|None): the MoE layers'
    load-balancing losses summed (float32; 0 for the dense family).
    ``probe``: a ``core.probe.StatsCollector`` drained once per layer (None
    records nothing).  ``remat`` checkpoints each layer while grad is on
    (the training forward: no cache, no probe)."""
    if remat and (return_cache or probe is not None):
        raise ValueError("remat is for the training forward: no cache, "
                         "no probe")
    mode = cfg.matmul_mode
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x, positions = _embed_inputs(params, cfg, batch)
    cos, sin = _angles(cfg, positions)
    cache = None
    if return_cache:
        cache = zeros_cache(cfg, B, max(cache_T or S, S), dev)
    if probe is not None:
        probe.absorb_pending()
    auxs = []
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        if remat:
            x, aux = remat_lib.checkpointed(_train_block, lp, x, cfg, mode,
                                            cos, sin)
        else:
            x, (k, v), aux = _block(lp, x, cfg, mode, cos, sin, probe)
        if aux is not None:
            auxs.append(aux)
        if probe is not None:
            probe.drain_layer()
        if return_cache:
            if cfg.kv_cache_int8:
                k, ks_, v, vs_ = attention.quantize_kv(k, v)
                cache["k_scale"][l, :, :S] = ks_
                cache["v_scale"][l, :, :S] = vs_
            cache["k"][l, :, :S] = k
            cache["v"][l, :, :S] = v
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    aux = (torch.stack(auxs).sum() if auxs
           else torch.zeros((), dtype=torch.float32, device=dev))
    return x, aux, cache


def logits_from_hidden(params, cfg, x: torch.Tensor,
                       probe=None) -> torch.Tensor:
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], x)
    return layers.dense(params["lm_head"], x, cfg.matmul_mode,
                        cfg.matmul_backend, probe)


def lm_loss(params, cfg, x: torch.Tensor, tokens: torch.Tensor,
            loss_mask: Optional[torch.Tensor] = None):
    """Next-token cross-entropy over hidden states x (B, S, D), the
    reference's loss body shared by every family: logits in float32 with
    the padded vocabulary masked to -1e9, targets rolled left by one with
    the last position masked (and ``loss_mask`` where given), a float32
    log-sum-exp.  Returns (mean loss over valid positions, valid count)."""
    B, S = tokens.shape
    T = B * S
    logits = logits_from_hidden(params, cfg, x.reshape(T, -1)).to(
        torch.float32)
    # mask padded vocab out of the softmax, in place: no backward reads
    # the logits before the mask, and the copy is 4 bytes x T x vocab
    pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab_size
    logits.masked_fill_(pad[None, :], -1e9)
    targets = torch.roll(tokens, -1, dims=1).reshape(T).long()
    valid = torch.ones((B, S), dtype=torch.bool, device=x.device)
    valid[:, -1] = False
    if loss_mask is not None:
        valid &= loss_mask.to(torch.bool)
    valid = valid.reshape(T)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, 1, targets[:, None])[:, 0]
    n_valid = valid.sum()
    loss = ((lse - tgt) * valid).sum() / torch.clamp_min(n_valid, 1)
    return loss, n_valid


def loss_fn(params, cfg, batch, *, remat: bool = True):
    """Causal LM loss (next-token prediction, final position masked, the
    batch's ``loss_mask`` applied) plus 0.01 x the MoE aux loss.  Returns
    (loss, {"ce_loss", "aux_loss", "valid_tokens"}).  ``remat``
    checkpoints each layer while grad is on."""
    x, aux, _ = forward(params, cfg, batch, remat=remat)
    loss, n_valid = lm_loss(params, cfg, x, batch["tokens"],
                            batch.get("loss_mask"))
    return loss + 0.01 * aux, {"ce_loss": loss, "aux_loss": aux,
                               "valid_tokens": n_valid}


def prefill(params, cfg, batch, cache_T: int, prompt_lens=None,
            probe=None):
    """Run the prompt, return (last-position logits (B, V), KV cache padded
    to cache_T).  ``prompt_lens`` (B,) gathers each row's logits at its own
    last valid position (ragged right-padded batches)."""
    x, _, cache = forward(params, cfg, batch, return_cache=True,
                          cache_T=cache_T, probe=probe)
    if prompt_lens is None:
        last = x[:, -1:, :]
    else:
        idx = torch.as_tensor(prompt_lens, device=x.device).long() - 1
        last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    logits = logits_from_hidden(params, cfg, last, probe)[:, 0]
    return logits, cache


def _decode_common(params, cfg, batch, *, write_fn, attend_fn, probe=None):
    """Shared decode/verify body over S >= 1 appended tokens.  Returns
    (logits (B, S, V), cache) with the cache updated in place; ``probe`` as
    for :func:`forward`."""
    mode = cfg.matmul_mode
    tokens, cache = batch["tokens"], batch["cache"]
    B, S = tokens.shape
    dev = tokens.device
    x = layers.embed(params["embed"], tokens)
    pos = attention.decode_positions(batch["cache_len"], B, S, device=dev)
    if cfg.mrope_sections:
        pos = pos[None].expand(3, B, S)
    cos, sin = _angles(cfg, pos)
    hd = cfg.resolved_head_dim
    int8kv = cfg.kv_cache_int8
    if probe is not None:
        probe.absorb_pending()
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        h = layers.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q, k, v = attention.qkv_proj(lp["attn"], h, cfg, mode, probe)
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
        x = x + layers.dense(lp["attn"]["wo"], out, mode, cfg.matmul_backend,
                             probe)
        h = layers.rms_norm(lp["ffn_norm"], x, cfg.norm_eps)
        x = x + _ffn(lp, h, cfg, mode, probe)[0]
        if probe is not None:
            probe.drain_layer()
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x, probe), cache


def _slab_fns(batch):
    """(write_fn, attend_fn) over the slab cache layout."""
    cache_len = batch["cache_len"]

    def write_fn(c, new):
        return attention.write_kv(c, new, cache_len)

    def attend_fn(q, kc, vc, ksc, vsc):
        return attention.decode_attention(q, kc, vc, cache_len,
                                          k_scale=ksc, v_scale=vsc)

    return write_fn, attend_fn


def _paged_fns(cfg, batch):
    """(write_fn, attend_fn) over the block-paged layout.  Write targets
    past a slot's table span are redirected to the trash block (speculative
    overhang lands nowhere); the S = 1 attend dispatches to the
    paged-attention kernel or its plain version per ``cfg.matmul_backend``,
    split over the batch's ``mesh`` (the mesh executor's) when it has one;
    S > 1 takes the dense-gather verify formulation."""
    tables = batch["block_tables"]
    dev = tables.device
    cache_len = torch.as_tensor(batch["cache_len"], device=dev)
    lens32 = cache_len.to(torch.int32)
    bs = batch["cache"]["k"].shape[2]
    S = batch["tokens"].shape[1]
    P = tables.shape[1]
    # physical write target per (slot, row): table entry at pos // bs
    pos = cache_len[:, None].long() + torch.arange(S, device=dev)[None, :]
    bi = pos // bs
    blk = torch.gather(tables.long(), 1, torch.clamp(bi, max=P - 1))
    blk = torch.where(bi < P, blk, torch.zeros_like(blk))  # overhang: trash
    off = pos % bs

    def write_fn(c, new):
        return attention.paged_write_kv(c, new, blk, off)

    def attend_fn(q, kc, vc, ksc, vsc):
        if S == 1:
            return attention.paged_decode_attention(
                q, kc, vc, tables, lens32, k_scale=ksc, v_scale=vsc,
                backend=cfg.matmul_backend, mesh=batch.get("mesh"))
        return attention.paged_verify_attention(
            q, kc, vc, tables, cache_len, k_scale=ksc, v_scale=vsc)

    return write_fn, attend_fn


def decode_step(params, cfg, batch, probe=None):
    """One-token decode.  batch: tokens (B,1), cache (slab, updated in
    place), cache_len: int (whole batch at one depth) or (B,) tensor.
    Returns (logits (B,V), cache)."""
    write_fn, attend_fn = _slab_fns(batch)
    logits, cache = _decode_common(params, cfg, batch, write_fn=write_fn,
                                   attend_fn=attend_fn, probe=probe)
    return logits[:, 0], cache


def verify_step(params, cfg, batch, probe=None):
    """Multi-token append at per-slot positions ``cache_len ..
    cache_len + S - 1`` in one pass.  Returns (logits (B, S, V), cache)."""
    write_fn, attend_fn = _slab_fns(batch)
    return _decode_common(params, cfg, batch, write_fn=write_fn,
                          attend_fn=attend_fn, probe=probe)


def decode_step_paged(params, cfg, batch, probe=None):
    """One-token decode against a block-paged KV cache.

    batch: tokens (B, 1); cache {k, v[, k_scale, v_scale]} with KV paged as
    (L, num_blocks, block_size, KH, hd), updated in place; block_tables
    (B, P) int32 physical page ids on the device; cache_len (B,) per-slot
    positions.  The new token's K/V is scattered to (table[pos // bs],
    pos % bs) per slot, and attention gathers through the block table.
    Returns (logits (B, V), cache)."""
    write_fn, attend_fn = _paged_fns(cfg, batch)
    logits, cache = _decode_common(params, cfg, batch, write_fn=write_fn,
                                   attend_fn=attend_fn, probe=probe)
    return logits[:, 0], cache


def verify_step_paged(params, cfg, batch, probe=None):
    """Multi-token append against the block-paged cache: the
    :func:`verify_step` contract with ``block_tables`` routing the writes
    and the dense-gather verify attention."""
    write_fn, attend_fn = _paged_fns(cfg, batch)
    return _decode_common(params, cfg, batch, write_fn=write_fn,
                          attend_fn=attend_fn, probe=probe)
