"""RWKV-6 causal LM, attention-free (port of ``repro/models/rwkv_model.py``):
the ``rwkv6-7b`` family (``family="ssm"``).

The parameter tree keeps the reference's structure and names (``embed``,
``ln0``, ``layers.{ln1, tm, ln2, cm}`` with a leading L axis on every layer
leaf, ``final_norm``, ``lm_head``), so ``convert.params_from_numpy``
carries the reference's weights over unchanged.  A Python loop over the
layers replaces the reference's ``scan``; ``loss_fn``'s forward
checkpoints each layer (``models/remat.py``) as the reference's
``jax.checkpoint`` does, and takes the WKV recurrence's plain version by
name (the reference trains on its jnp form; the kernel has no backward).

The decode state per layer is the WKV state (B, H, N, N) float32 and the
two token-shift carries (B, D), stacked on a leading L axis:
``{"wkv", "x_tm", "x_cm"}``.  ``forward`` writes each layer's new state
into the state it was given IN PLACE and returns it: the serving executor
hands the pooled slot state to ``decode_step`` and keeps the same tensors,
with no per-step allocation (the reference returns a new pytree into a
donated buffer).  Without a state, ``forward`` starts from a zero state of
its own.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers, remat as remat_lib, rwkv6
from repro_torch.models.causal_lm import (layer_params, lm_loss,
                                          logits_from_hidden)


def init(gen: torch.Generator, cfg, device=None):
    """Random-init parameters from ``gen`` (the reference's tree; every
    layer leaf has a leading L axis)."""
    L, d = cfg.num_layers, cfg.d_model
    return {
        "embed": layers.init_embedding(gen, cfg.vocab_padded, d,
                                       device=device),
        "ln0": layers.init_layernorm(d, device=device),
        "layers": {
            "ln1": layers.init_layernorm(d, (L,), device),
            "tm": rwkv6.init_time_mix(gen, cfg, (L,), device),
            "ln2": layers.init_layernorm(d, (L,), device),
            "cm": rwkv6.init_channel_mix(gen, cfg, (L,), device),
        },
        "final_norm": layers.init_layernorm(d, device=device),
        "lm_head": layers.init_dense(gen, d, cfg.vocab_padded,
                                     device=device),
    }


def cache_specs(cfg, B: int, cache_T: int = 0):
    """{leaf name: (shape, dtype)} of the decode state (``cache_T`` is
    accepted for interface parity: the state does not grow)."""
    d, n, L = cfg.d_model, cfg.rwkv_head_dim, cfg.num_layers
    return {"wkv": ((L, B, d // n, n, n), torch.float32),
            "x_tm": ((L, B, d), layers.DTYPE),
            "x_cm": ((L, B, d), layers.DTYPE)}


def zeros_cache(cfg, B: int, cache_T: int, device):
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in cache_specs(cfg, B, cache_T).items()}


def forward(params, cfg, batch, state: Optional[dict] = None):
    """Returns (hidden (B, S, D) after the final norm, state), the state
    updated in place (a fresh zero state when none is given)."""
    mode = cfg.matmul_mode
    tokens = batch["tokens"]
    B = tokens.shape[0]
    if state is None:
        state = zeros_cache(cfg, B, 0, tokens.device)
    x = layers.embed(params["embed"], tokens)
    x = layers.layer_norm(params["ln0"], x)
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        h = layers.layer_norm(lp["ln1"], x)
        y, x_tm, wkv = rwkv6.time_mix(lp["tm"], h, state["x_tm"][l],
                                      state["wkv"][l], cfg, mode)
        x = x + y
        h = layers.layer_norm(lp["ln2"], x)
        y, x_cm = rwkv6.channel_mix(lp["cm"], h, state["x_cm"][l], mode,
                                    cfg.matmul_backend)
        x = x + y
        state["wkv"][l].copy_(wkv)
        state["x_tm"][l].copy_(x_tm)
        state["x_cm"][l].copy_(x_cm)
    return layers.layer_norm(params["final_norm"], x), state


def _train_layer(lp, x, cfg, mode, zero):
    """One layer of the training forward from the zero state ``zero``
    (one layer's slice); the new state is dropped."""
    h = layers.layer_norm(lp["ln1"], x)
    y, _, _ = rwkv6.time_mix(lp["tm"], h, zero["x_tm"], zero["wkv"], cfg,
                             mode, wkv_backend="plain")
    x = x + y
    h = layers.layer_norm(lp["ln2"], x)
    y, _ = rwkv6.channel_mix(lp["cm"], h, zero["x_cm"], mode,
                             cfg.matmul_backend)
    return x + y


def loss_fn(params, cfg, batch, *, remat: bool = True):
    """Next-token cross-entropy from a zero state (final position masked;
    the reference applies no ``loss_mask`` here).  Returns (loss,
    {"ce_loss", "valid_tokens"}).  ``remat`` checkpoints each layer while
    grad is on."""
    mode = cfg.matmul_mode
    tokens = batch["tokens"]
    zero = {name: torch.zeros(shape[1:], dtype=dtype, device=tokens.device)
            for name, (shape, dtype) in cache_specs(
                cfg, tokens.shape[0]).items()}
    x = layers.embed(params["embed"], tokens)
    x = layers.layer_norm(params["ln0"], x)
    for l in range(cfg.num_layers):
        x = remat_lib.checkpointed(_train_layer, layer_params(params, l), x,
                                   cfg, mode, zero, enabled=remat)
    x = layers.layer_norm(params["final_norm"], x)
    loss, n_valid = lm_loss(params, cfg, x, tokens)
    return loss, {"ce_loss": loss, "valid_tokens": n_valid}


def prefill(params, cfg, batch, cache_T: int = 0):
    """Run the prompt from a zero state; return (last-position logits
    (B, V), state).  Every token of every row enters the recurrent state,
    so ``api.prefill`` refuses right-padded ragged batches."""
    x, state = forward(params, cfg, batch)
    logits = logits_from_hidden(params, cfg, x[:, -1:, :])[:, 0]
    return logits, state


def decode_step(params, cfg, batch):
    """batch: tokens (B, 1), cache = the state (updated in place);
    ``cache_len`` is ignored (the state does not grow).  Returns (logits
    (B, V), cache)."""
    x, state = forward(params, cfg, {"tokens": batch["tokens"]},
                       state=batch["cache"])
    return logits_from_hidden(params, cfg, x)[:, 0], state
