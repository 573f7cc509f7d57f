"""Weights of a Qwen2-style decoder made from the seed, by the benchmark.

Both sides get these: the program as its parameter tree, the plain
reference by making them again from the same seed after the program is
gone.  Every leaf has its own ``torch.Generator`` on the device, seeded
from (seed, leaf index), and is drawn in one call in the dtype it is
served in, so a leaf can be made again alone and the whole set takes a
few large calls.

The tree has the program's layout (every layer leaf stacked on a leading
L axis; dense weights (K, N); the vocabulary padded to a multiple of 256,
the program's choice, so the padded rows exist and get logits on both
sides).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

VOCAB_PAD_MULTIPLE = 256
_MIX = 1_000_003


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def leaf_specs(model: dict) -> List[Tuple[str, tuple, torch.dtype, str,
                                          float]]:
    """(path, shape, dtype, kind, std) of every leaf, in a fixed order.
    ``model`` is a configuration file's ``model`` object (the published
    keys).  kinds: ``normal`` (N(0, std)), ``scale`` (1 + N(0, std))."""
    d = model["hidden_size"]
    L = model["num_hidden_layers"]
    H = model["num_attention_heads"]
    KH = model["num_key_value_heads"]
    hd = model.get("head_dim", d // H)
    ff = model["intermediate_size"]
    V = padded_vocab(model["vocab_size"])
    bf, f32 = torch.bfloat16, torch.float32
    specs = [("embed.table", (V, d), bf, "normal", d ** -0.5)]
    specs += [
        ("layers.attn_norm.scale", (L, d), f32, "scale", 0.1),
        ("layers.attn.wq.w", (L, d, H * hd), bf, "normal", d ** -0.5),
        ("layers.attn.wq.b", (L, H * hd), f32, "normal", 0.05),
        ("layers.attn.wk.w", (L, d, KH * hd), bf, "normal", d ** -0.5),
        ("layers.attn.wk.b", (L, KH * hd), f32, "normal", 0.05),
        ("layers.attn.wv.w", (L, d, KH * hd), bf, "normal", d ** -0.5),
        ("layers.attn.wv.b", (L, KH * hd), f32, "normal", 0.05),
        ("layers.attn.wo.w", (L, H * hd, d), bf, "normal", (H * hd) ** -0.5),
        ("layers.ffn_norm.scale", (L, d), f32, "scale", 0.1),
        ("layers.ffn.w_gate.w", (L, d, ff), bf, "normal", d ** -0.5),
        ("layers.ffn.w_up.w", (L, d, ff), bf, "normal", d ** -0.5),
        ("layers.ffn.w_down.w", (L, ff, d), bf, "normal", ff ** -0.5),
        ("final_norm.scale", (d,), f32, "scale", 0.1),
    ]
    if not model["tie_word_embeddings"]:
        specs.append(("lm_head.w", (d, V), bf, "normal", d ** -0.5))
    return specs


def make_leaf(seed: int, index: int, shape, dtype, kind: str, std: float,
              device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * _MIX + index) % (2 ** 63))
    t = torch.randn(shape, generator=g, dtype=dtype, device=device)
    t.mul_(std)
    if kind == "scale":
        t.add_(1.0)
    return t


def make_flat(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{path: tensor} of every leaf."""
    return {path: make_leaf(seed, i, shape, dtype, kind, std, device)
            for i, (path, shape, dtype, kind, std)
            in enumerate(leaf_specs(model))}


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"a.b.c": t} -> {"a": {"b": {"c": t}}} (the program's tree)."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = t
    return tree
