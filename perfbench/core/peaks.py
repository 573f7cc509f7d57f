"""Peaks of the card and the bounds of the port's kernels.

Copied from the smoke script's ``matmul_bound`` / ``attention_bound`` and
its peak constants, so that no later change to the program can move the
yardstick.  Published peaks of one NVIDIA H100 SXM (data sheet, dense
rates, at the 700 W limit): a roofline share is stated against them, with
the card's power limit written beside it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12


def matmul_bound_s(m: int, k: int, n: int, contractions: int = 1) -> float:
    """Least seconds of one quantized matmul (M, K) x (K, N): the larger of
    bytes over the HBM rate (A, W and both scale vectors read once, the
    float32 output written once) and int8 operations over the tensor-core
    rate.  ``contractions`` counts the products the work needs: one for an
    exact product, and one for the approximate one too, since the
    approximate method's correction products are the kernel's way of
    computing it and not work the result needs."""
    nbytes = m * k + k * n + 4 * m + 4 * n + 4 * m * n
    ops = 2 * m * n * k * contractions
    return max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)


def attention_bound_s(lengths, n_heads: int, kv_heads: int, head_dim: int,
                      block_size: int, pages_per_seq: int,
                      esize: int = 2) -> float:
    """Least seconds of one paged decode attention call: the larger of
    bytes over the HBM rate (the valid K and V rows of every sequence, q,
    the output, the tables and lengths, each once) and its flops (q.k and
    p.v, two per multiply-add) over the bf16 tensor-core rate.  A
    sequence of length ``n`` attends to ``n + 1`` positions (its own row
    included); an idle slot (length 0) still reads one."""
    B = len(lengths)
    tokens = sum(min(max(int(n) + 1, 0), pages_per_seq * block_size)
                 for n in lengths)
    nbytes = (2 * tokens * kv_heads * head_dim * esize
              + 2 * B * n_heads * head_dim * esize
              + 4 * B * pages_per_seq + 4 * B)
    ops = 4 * tokens * n_heads * head_dim
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
