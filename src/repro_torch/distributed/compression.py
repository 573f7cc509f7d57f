"""Gradient compression for the cross-pod all-reduce: blockwise int8 with
error feedback (port of ``repro/distributed/compression.py``).

Each leaf is flattened, zero-padded to a multiple of :data:`BLOCK` and
quantized per 128-element block to int8 with one float32 scale
(``max |block| / 127``, at least 1e-12): the wire carries int8 codes plus
one scale per block, 4x fewer bytes than float32 gradients.  Error
feedback (Seide et al., 2014; Karimireddy et al., 2019) carries each
step's quantization residual into the next, so the compression bias
vanishes over steps.  Trees are nested dicts of tensors; a tree function
returns new tensors and leaves its inputs untouched.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import leaves, tree_map

BLOCK = 128
QMAX = 127.0


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """g (any shape, float) -> (int8 codes (blocks, 128), float32 per-block
    scales (blocks, 1), meta)."""
    n = g.numel()
    flat = F.pad(g.to(torch.float32).reshape(-1), (0, (-n) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / QMAX
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale, (tuple(g.shape), n)


def decompress(q: torch.Tensor, scale: torch.Tensor, meta) -> torch.Tensor:
    shape, n = meta
    return (q.to(torch.float32) * scale).reshape(-1)[:n].reshape(shape)


def compress_with_feedback(g: torch.Tensor, e: torch.Tensor):
    """One leaf: (sent in g's dtype, new residual float32) from gradient
    ``g`` and carried residual ``e``."""
    corrected = g.to(torch.float32) + e
    sent = decompress(*compress(corrected))
    return sent.to(g.dtype), corrected - sent


def compress_tree_with_feedback(grads, error_state):
    """(grads + carried error) -> (compressed grads, new error state).
    The compressed grads are the dequantized values the all-reduce would
    carry; the residual stays in the new error state."""
    out = tree_map(compress_with_feedback, grads, error_state)
    return (tree_map(lambda t: t[0], out),
            tree_map(lambda t: t[1], out))


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def compressed_bytes(tree) -> int:
    """Wire bytes if every leaf were int8 plus one float32 scale per
    block (for the roofline model)."""
    total = 0
    for leaf in leaves(tree):
        n = leaf.numel()
        total += n + 4 * -(-n // BLOCK)
    return total
