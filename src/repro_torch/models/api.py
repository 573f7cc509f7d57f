"""Unified model API: family dispatch (port of ``repro/models/api.py``).

    init(cfg, seed=..., device=...) -> params
    loss_fn(params, cfg, batch) -> (loss, metrics)          [train step]
    prefill(params, cfg, batch, cache_T) -> (logits, cache)
    decode_step(params, cfg, batch) -> (logits, cache)
    verify_step(params, cfg, batch) -> (logits (B, S, V), cache)

    decode_step_paged / verify_step_paged(params, cfg, batch) -> ...

    prefill_probed / decode_step_probed / decode_step_paged_probed /
    verify_step_probed / verify_step_paged_probed -> (..., stats)


plus the slab and block-paged cache helpers the serving engine uses, and
the partition specs of a mesh (``param_pspecs``, ``cache_pspecs``), and
the dry run's ``input_specs`` (meta tensors of every model input of a
workload shape) and ``model_flops``.  The
dense, mixture-of-experts and vision-language families (``causal_lm``)
have every entry point.  The RWKV-6 (``ssm``, ``rwkv_model``), hybrid
(``zamba_model``) and encoder-decoder (``audio``, ``encdec``) families
have the slab ones only and raise, as the reference does, on paged caches
and verify steps; the two recurrent ones also on ragged prefill.  The
probed entry points take the causal-LM families only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.probe import StatsCollector, probe_supported
from repro_torch.device import resolve_device
from repro_torch.models import (causal_lm, encdec, layers, rwkv_model,
                                zamba_model)

_FAMILY_MODULES = {"dense": causal_lm, "moe": causal_lm, "vlm": causal_lm,
                   "ssm": rwkv_model, "hybrid": zamba_model, "audio": encdec}
#: families whose decode cache is recurrent state, not position-indexed KV
_RECURRENT_FAMILIES = ("ssm", "hybrid")
#: families whose decode cache is position-indexed KV alone, which pages
_PAGED_FAMILIES = ("dense", "moe", "vlm")


def _module(cfg):
    mod = _FAMILY_MODULES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    return mod


def init(cfg, *, seed: int = 0, generator: Optional[torch.Generator] = None,
         device="cuda"):
    """Random-init parameters on ``device`` (default the GPU; raises when
    CUDA is absent unless ``device="cpu"``), drawn from ``generator`` or a
    fresh generator seeded with ``seed``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return _module(cfg).init(generator, cfg, device=dev)


def is_recurrent(cfg) -> bool:
    """Is this family's decode cache recurrent state?  Such a state
    integrates every token it is given (right padding included) and has no
    sequence axis to page."""
    return cfg.family in _RECURRENT_FAMILIES


def supports_paged(cfg) -> bool:
    """Does this family have a block-paged decode cache?  (Position-
    indexed KV alone: dense / moe / vlm.)"""
    _module(cfg)
    return cfg.family in _PAGED_FAMILIES


def prefill(params, cfg, batch, cache_T: int, prompt_lens=None):
    """``prompt_lens`` (B,) enables ragged right-padded prompt batches for
    families whose prefill is position-independent of right padding
    (attention KV families); recurrent families integrate every token into
    their state and do not support it."""
    if prompt_lens is None:
        return _module(cfg).prefill(params, cfg, batch, cache_T)
    if is_recurrent(cfg):
        raise ValueError(
            f"family {cfg.family!r} has recurrent state: right-padded "
            f"ragged prefill would corrupt it (use exact-length groups)")
    return _module(cfg).prefill(params, cfg, batch, cache_T,
                                prompt_lens=prompt_lens)


def loss_fn(params, cfg, batch, *, remat: bool = True):
    """The family's training loss: (scalar float32 loss, metrics).  The
    batch holds ``tokens`` (B, S) and, per family, ``loss_mask``,
    ``vision_embeds`` / ``vision_mask`` or ``src_embeds``.  ``remat``
    checkpoints each layer while grad is on."""
    return _module(cfg).loss_fn(params, cfg, batch, remat=remat)


def decode_step(params, cfg, batch):
    return _module(cfg).decode_step(params, cfg, batch)


def supports_verify(cfg) -> bool:
    """Can this family run the speculative multi-token verify step?
    (Position-indexed KV that can be rewound on rejection; recurrent state
    integrates every token irreversibly.)"""
    return hasattr(_module(cfg), "verify_step")


def verify_module(cfg, name: str = "verify_step"):
    """The family's ``name`` entry point of the multi-token verify step;
    raises ``ValueError`` for a family without one."""
    mod = _module(cfg)
    if not hasattr(mod, name):
        raise ValueError(
            f"family {cfg.family!r} has no multi-token verify path: "
            f"speculative decoding needs position-indexed KV that can be "
            f"rewound on rejection (recurrent state integrates every token "
            f"irreversibly); serve with draft='none'")
    return getattr(mod, name)


def verify_step(params, cfg, batch):
    return verify_module(cfg)(params, cfg, batch)


def decode_step_paged(params, cfg, batch):
    """Block-paged decode (``batch`` carries ``block_tables`` + per-slot
    ``cache_len``); position-indexed KV families only."""
    mod = _module(cfg)
    if not hasattr(mod, "decode_step_paged"):
        raise ValueError(
            f"family {cfg.family!r} has no paged decode path; "
            f"use the slab cache backend")
    return mod.decode_step_paged(params, cfg, batch)


def verify_step_paged(params, cfg, batch):
    """Block-paged multi-token verify (``batch`` carries
    ``block_tables``); see :func:`verify_step`."""
    return verify_module(cfg, "verify_step_paged")(params, cfg, batch)


# ---------------------------------------------------------------------------
# Probed entry points: the same forward with a stats collector passed down
# the layer loop; each also returns the (L[+1], N_STATS) float32 activation
# stats (``core/probe.py``).
# ---------------------------------------------------------------------------

def _probed(entry, params, cfg, batch, *args, **kw):
    if not probe_supported(cfg):
        raise ValueError(
            f"sparsity probe unsupported for family={cfg.family!r} "
            f"matmul_mode={cfg.matmul_mode!r}: the probe taps int8 operands "
            f"at the quantized-matmul boundary (causal-LM family + "
            f"bp_exact/bp_approx mode)")
    probe = StatsCollector()
    out = entry(params, cfg, batch, *args, probe=probe, **kw)
    return (*out, probe.collect())


def prefill_probed(params, cfg, batch, cache_T: int, prompt_lens=None):
    """:func:`prefill` -> (logits, cache, stats)."""
    return _probed(_module(cfg).prefill, params, cfg, batch, cache_T,
                   prompt_lens=prompt_lens)


def decode_step_probed(params, cfg, batch):
    """:func:`decode_step` -> (logits, cache, stats)."""
    return _probed(_module(cfg).decode_step, params, cfg, batch)


def decode_step_paged_probed(params, cfg, batch):
    """:func:`decode_step_paged` -> (logits, cache, stats)."""
    return _probed(_module(cfg).decode_step_paged, params, cfg, batch)


def verify_step_probed(params, cfg, batch):
    """:func:`verify_step` -> (logits (B, S, V), cache, stats)."""
    return _probed(verify_module(cfg), params, cfg, batch)


def verify_step_paged_probed(params, cfg, batch):
    """:func:`verify_step_paged` -> (logits (B, S, V), cache, stats)."""
    return _probed(verify_module(cfg, "verify_step_paged"), params, cfg,
                   batch)


def cache_specs(cfg, B: int, cache_T: int
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{leaf name: (shape, dtype)} of the slab decode cache."""
    return _module(cfg).cache_specs(cfg, B, cache_T)


def cache_batch_axes(cfg) -> Dict[str, int]:
    """Slot/batch axis of every decode-cache leaf: the family module's
    ``CACHE_BATCH_AXES`` (the hybrid's Mamba states stack their batch on
    axis 2, the audio family's ``cross_len`` on axis 0), else axis 1."""
    axes = getattr(_module(cfg), "CACHE_BATCH_AXES", None)
    return dict(axes) if axes is not None else {
        name: 1 for name in cache_specs(cfg, 1, 8)}


def zeros_cache(cfg, n_slots: int, cache_T: int, device):
    """All-zeros slab decode cache for an ``n_slots``-wide slot pool."""
    return _module(cfg).zeros_cache(cfg, n_slots, cache_T, device)


def slot_insert(cfg, pool_cache, src_cache, slot: int, src_index: int = 0):
    """Write request ``src_index`` of a prefill cache (padded to the pool's
    cache_T) into slot ``slot`` of the pooled cache, in place; returns the
    pool.  A leaf the family lists in ``SHORT_ROW_LEAVES`` (the audio
    family's cross K/V) may be shorter than the slot along the row's axis
    1: it fills the leading positions."""
    short = getattr(_module(cfg), "SHORT_ROW_LEAVES", ())
    for name, ax in cache_batch_axes(cfg).items():
        pool, src = pool_cache[name], src_cache[name]
        row = src.select(ax, src_index)
        dst = pool.select(ax, slot)
        if (name in short and row.shape[0] == dst.shape[0]
                and row.shape[2:] == dst.shape[2:]
                and row.shape[1] <= dst.shape[1]):
            dst = dst.narrow(1, 0, row.shape[1])
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


# ---------------------------------------------------------------------------
# Block-paged decode caches (paged cache backend)
# ---------------------------------------------------------------------------

def paged_cache_specs(cfg, num_blocks: int, block_size: int
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{leaf name: (shape, dtype)} of the block-paged decode cache: every KV
    leaf is (L, num_blocks, block_size, KH, hd), plus (L, num_blocks,
    block_size, KH) float32 scales with ``kv_cache_int8``.  Position-
    indexed KV families only: recurrent state has no sequence axis to
    page, and the audio family's cross K/V is not paged (as in the
    reference)."""
    _module(cfg)
    if not supports_paged(cfg):
        raise ValueError(f"no paged cache layout for family {cfg.family!r}")
    kv = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
          cfg.resolved_head_dim)
    if cfg.kv_cache_int8:
        sc = kv[:-1]
        return {"k": (kv, torch.int8), "k_scale": (sc, torch.float32),
                "v": (kv, torch.int8), "v_scale": (sc, torch.float32)}
    return {"k": (kv, layers.DTYPE), "v": (kv, layers.DTYPE)}


def zeros_paged_cache(cfg, num_blocks: int, block_size: int, device):
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype)
            in paged_cache_specs(cfg, num_blocks, block_size).items()}


def paged_insert(cfg, pages, src_cache, block_ids: torch.Tensor,
                 src_index: int = 0):
    """Scatter request ``src_index`` of a prefill cache (padded to
    ``len(block_ids) * block_size`` positions) into physical pages, IN
    PLACE; returns ``pages``.

    ``block_ids`` (P,): logical block i of the sequence lands in physical
    page ``block_ids[i]``.  Blocks that must NOT be written (prefix-sharing
    hits) are redirected to the trash page (id 0) by the caller."""
    ids = block_ids.long()
    P = ids.shape[0]
    for name, page in pages.items():
        row = src_cache[name][:, src_index]          # (L, T, ...)
        L, T = row.shape[0], row.shape[1]
        if T != P * page.shape[2]:
            raise ValueError(f"cache leaf {name!r}: prefill length {T} is "
                             f"not {P} blocks of {page.shape[2]}")
        page[:, ids] = row.reshape(L, P, T // P,
                                   *row.shape[2:]).to(page.dtype)
    return pages


# ---------------------------------------------------------------------------
# Partition specs of mesh serving: logical axes -> per-dimension mesh axes
# (``distributed/sharding.py``)
# ---------------------------------------------------------------------------

def cache_logical_axes(cfg) -> Dict[str, tuple]:
    """Logical axis names of every slab decode-cache leaf, resolved by the
    decode recipe: slots over "data", the KV sequence over "model"."""
    kv = (None, "batch", "cache_seq", "heads", None)
    sc = (None, "batch", "cache_seq", "heads")
    if cfg.family in _PAGED_FAMILIES:
        if cfg.kv_cache_int8:
            return {"k": kv, "k_scale": sc, "v": kv, "v_scale": sc}
        return {"k": kv, "v": kv}
    if cfg.family == "ssm":
        return {"wkv": (None, "batch", "heads", None, None),
                "x_tm": (None, "batch", None),
                "x_cm": (None, "batch", None)}
    if cfg.family == "hybrid":
        return {"conv": (None, None, "batch", None, None),
                "ssm": (None, None, "batch", "heads", None, None),
                "k": kv, "v": kv}
    if cfg.family == "audio":
        return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv,
                "cross_len": ("batch",)}
    raise NotImplementedError(f"family {cfg.family!r} is not ported")


def cache_pspec_tree(cfg, cache_like, mesh_axes, *, paged: bool = False
                     ) -> Dict[str, tuple]:
    """Spec of every leaf of ``cache_like`` (tensors, or the (shape, dtype)
    pairs of :func:`cache_specs`).  The paged cache is whole: its page
    pool has no batch or sequence axis to split, and the block tables go
    whole too."""
    from repro_torch.distributed import sharding

    axes = sharding.mesh_axes_dict(mesh_axes)
    names = None if paged else cache_logical_axes(cfg)
    out = {}
    for name, leaf in cache_like.items():
        shape = tuple(leaf.shape if isinstance(leaf, torch.Tensor)
                      else leaf[0])
        out[name] = (sharding.logical_pspec(shape, names[name], "decode",
                                            axes)
                     if names is not None else (None,) * len(shape))
    return out


def cache_pspecs(cfg, n_slots: int, cache_T: int, mesh_axes
                 ) -> Dict[str, tuple]:
    """Specs of the pooled slab decode cache of this family."""
    return cache_pspec_tree(cfg, cache_specs(cfg, n_slots, cache_T),
                            mesh_axes)


def param_pspecs(params, mesh_axes) -> dict:
    """Serve-recipe spec tree of the model params (weight-stationary
    tensor parallelism: last dims over "model")."""
    from repro_torch.distributed import sharding
    return sharding.param_specs(params, "serve", mesh_axes)


# ---------------------------------------------------------------------------
# The dry run's inputs and model FLOPs (``launch/dryrun.py``)
# ---------------------------------------------------------------------------

def input_specs(cfg, shape, device="meta") -> Dict[str, object]:
    """Every model input of one (arch x workload-shape) cell as tensors on
    ``device`` (meta by default: shapes and dtypes, no storage; zeros on a
    real device), with the reference's shapes and dtypes: int32
    ``tokens``; the VLM's ``vision_embeds``, ``vision_mask`` and 3-row
    ``positions``; the audio family's ``src_embeds`` of S/4 frames; for
    decode one token per row, the slab cache of :func:`cache_specs` (the
    audio family's has the port's ``cross_len`` leaf beside the
    reference's) and a scalar int32 ``cache_len``."""
    B, S = shape.global_batch, shape.seq_len

    def t(dims, dtype):
        return torch.zeros(tuple(int(d) for d in dims), dtype=dtype,
                           device=device)

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": t((B, S), torch.int32)}
        if cfg.family == "vlm":
            batch.update({"vision_embeds": t((B, S, cfg.d_model),
                                             layers.DTYPE),
                          "vision_mask": t((B, S), torch.bool),
                          "positions": t((3, B, S), torch.int32)})
        if cfg.family == "audio":
            batch["src_embeds"] = t((B, S // 4, cfg.d_model), layers.DTYPE)
        return batch
    if shape.kind == "decode":
        return {"tokens": t((B, 1), torch.int32),
                "cache": {name: t(dims, dtype) for name, (dims, dtype)
                          in cache_specs(cfg, B, S).items()},
                "cache_len": t((), torch.int32)}
    raise ValueError(shape.kind)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS, as the reference counts them: 6·N·D for training (N
    the params, active for MoE), 2·N·D for one forward; decode counts one
    token per sequence plus the attention reads over the cache."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch
    attn_read = 0.0
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        attn_read = (4.0 * cfg.num_layers * cfg.num_heads
                     * cfg.resolved_head_dim * shape.seq_len * tokens)
    if cfg.family == "hybrid":
        n_sup = cfg.num_layers // cfg.attn_every
        attn_read = (4.0 * n_sup * cfg.num_heads * cfg.resolved_head_dim
                     * shape.seq_len * tokens)
    return 2.0 * n_active * tokens + attn_read
