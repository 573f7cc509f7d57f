"""Unified model API, dense slab slice (port of ``repro/models/api.py``).

    init(cfg, seed=..., device=...) -> params
    prefill(params, cfg, batch, cache_T) -> (logits, cache)
    decode_step(params, cfg, batch) -> (logits, cache)
    verify_step(params, cfg, batch) -> (logits (B, S, V), cache)

plus the slab cache helpers the serving engine uses.  Families other than
dense raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import causal_lm


def _module(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    return causal_lm


def init(cfg, *, seed: int = 0, generator: Optional[torch.Generator] = None,
         device="cuda"):
    """Random-init parameters on ``device`` (default the GPU; raises when
    CUDA is absent unless ``device="cpu"``), drawn from ``generator`` or a
    fresh generator seeded with ``seed``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return _module(cfg).init(generator, cfg, device=dev)


def prefill(params, cfg, batch, cache_T: int, prompt_lens=None):
    """``prompt_lens`` (B,) enables ragged right-padded prompt batches."""
    return _module(cfg).prefill(params, cfg, batch, cache_T,
                                prompt_lens=prompt_lens)


def decode_step(params, cfg, batch):
    return _module(cfg).decode_step(params, cfg, batch)


def verify_step(params, cfg, batch):
    return _module(cfg).verify_step(params, cfg, batch)


def cache_specs(cfg, B: int, cache_T: int
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{leaf name: (shape, dtype)} of the slab decode cache."""
    return _module(cfg).cache_specs(cfg, B, cache_T)


def cache_batch_axes(cfg) -> Dict[str, int]:
    """Slot/batch axis of every decode-cache leaf."""
    return {name: 1 for name in cache_specs(cfg, 1, 8)}


def zeros_cache(cfg, n_slots: int, cache_T: int, device):
    """All-zeros slab decode cache for an ``n_slots``-wide slot pool."""
    return _module(cfg).zeros_cache(cfg, n_slots, cache_T, device)


def slot_insert(cfg, pool_cache, src_cache, slot: int, src_index: int = 0):
    """Write request ``src_index`` of a prefill cache (padded to the pool's
    cache_T) into slot ``slot`` of the pooled cache, in place; returns the
    pool."""
    for name, ax in cache_batch_axes(cfg).items():
        pool, src = pool_cache[name], src_cache[name]
        row = src.select(ax, src_index)
        dst = pool.select(ax, slot)
        if row.shape != dst.shape:
            raise ValueError(f"cache leaf {name!r}: prefill row "
                             f"{tuple(row.shape)} does not fit the pool slot "
                             f"{tuple(dst.shape)}")
        dst.copy_(row)
    return pool_cache


def slot_extract(cfg, pool_cache, slot: int):
    """Slot ``slot`` of the pooled cache as a batch-1 cache (a copy)."""
    return {name: pool_cache[name].narrow(ax, slot, 1).clone()
            for name, ax in cache_batch_axes(cfg).items()}
