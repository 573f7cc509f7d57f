"""Value- and bit-level sparsity statistics (port of
``repro/core/sparsity.py``; paper Fig. 1 and Section IV-B3).

Bit-level sparsity is measured on 8-bit quantized tensors in sign-magnitude
representation (7 magnitude bits per element), and contrasted with 2's
complement, which shows lower sparsity for negative values.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bitparticle import _popcount7, to_sign_magnitude


def value_sparsity(q):
    """Fraction of exactly-zero elements."""
    q = torch.as_tensor(q)
    return (q == 0).to(torch.float32).mean()


def bit_sparsity_sign_magnitude(q, nonzero_only: bool = False):
    """Mean fraction of zero bits among the 7 magnitude bits.

    ``nonzero_only`` restricts the average to nonzero elements (the paper's
    "bit-level sparsity of non-zero elements", Section IV-B3)."""
    _, mag = to_sign_magnitude(q)
    frac = (7 - _popcount7(mag)).to(torch.float32) / 7.0
    if nonzero_only:
        m = (mag != 0).to(torch.float32)
        return (frac * m).sum() / torch.clamp_min(m.sum(), 1.0)
    return frac.mean()


def popcount8(u):
    """Set-bit count of the low 8 bits, via a broadcast bit expansion."""
    u = torch.as_tensor(u).to(torch.int32)
    bits = torch.arange(8, dtype=torch.int32, device=u.device)
    return ((u[..., None] >> bits) & 1).sum(dim=-1)


def bit_sparsity_twos_complement(q):
    """Mean fraction of zero bits among all 8 bits of the 2's-complement
    form."""
    q = torch.as_tensor(q).to(torch.int32)
    u = torch.where(q < 0, q + 256, q)   # the 8-bit two's complement pattern
    return ((8 - popcount8(u)).to(torch.float32) / 8.0).mean()


# Per-tensor stat rows used by the serving probe: a fixed-width float32
# vector whose entries are pure sums, so rows from different tensors add
# together before being turned into rates.
N_STATS = 3  # [sum of zero magnitude bits, n elements, n zero values]


def zero_bit_table(device=None) -> torch.Tensor:
    """(256,) int64: the zero bits among the 7 magnitude bits of each
    magnitude 0..255 (128, the magnitude of -128, has none set)."""
    return 7 - _popcount7(torch.arange(256, device=device))


def sm_bit_counts(q, table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(N_STATS,)`` int64 sums of one int8-valued tensor, on its device:
    zero magnitude bits, elements, zero values.  The sums are exact
    integers; :func:`sm_bit_stats` is their float32 form.  ``table``: a
    :func:`zero_bit_table` on the tensor's device (built here when not
    given), so a caller that counts many tensors builds it once."""
    mag = torch.as_tensor(q).to(torch.int64).abs()
    if table is None:
        table = zero_bit_table(mag.device)
    zero_bits = table[mag].sum()
    zeros = (mag == 0).sum()
    return torch.stack([zero_bits, torch.full_like(zeros, mag.numel()),
                        zeros])


def sm_bit_stats(q) -> torch.Tensor:
    """``(N_STATS,)`` float32 sum-form sparsity stats of one int8 tensor.

    ``stats_to_rates`` recovers ``bit_sparsity_sign_magnitude`` /
    ``value_sparsity``: the bit sparsity here is the element-weighted mean
    of ``(7 - popcount7(mag)) / 7``.  The sums are taken in integers and
    rounded to float32 once, so they are exact below 2^24 (the reference
    sums in float32)."""
    return sm_bit_counts(q).to(torch.float32)


def per_layer_counts(q) -> torch.Tensor:
    """``(L, N_STATS)`` int64 counts of a layer-stacked int8 tensor
    (leading axis L), one layer at a time so a large weight needs no
    full-size temporary."""
    q = torch.as_tensor(q)
    table = zero_bit_table(q.device)
    return torch.stack([sm_bit_counts(q[l], table)
                        for l in range(q.shape[0])])


def per_layer_stats(q) -> torch.Tensor:
    """``(L, N_STATS)`` float32 stats of a layer-stacked int8 tensor."""
    return per_layer_counts(q).to(torch.float32)


def stats_to_rates(stats):
    """(bit_sparsity, value_sparsity) from summed ``sm_bit_stats`` rows.

    Works on a single ``(N_STATS,)`` row or a stacked ``(..., N_STATS)``
    array; zero-element rows yield 0.0 rather than NaN."""
    stats = torch.as_tensor(stats).to(torch.float32)
    n = torch.clamp_min(stats[..., 1], 1.0)
    return stats[..., 0] / (7.0 * n), stats[..., 2] / n


def sample_with_bit_sparsity(gen: torch.Generator, shape, bit_sparsity: float,
                             value_sparsity_p: float = 0.0) -> torch.Tensor:
    """Sign-magnitude int32 operands from the paper's generator, drawn from
    ``gen`` (on the generator's device).

    Each of the 7 magnitude bits is independently 0 with probability
    ``bit_sparsity``; the sign is uniform; optionally a fraction
    ``value_sparsity_p`` of elements is forced to exact zero (Section
    IV-B3: "assigns each bit a probability of bs to be 0").  The draws
    cannot reproduce the reference's ``jax.random`` streams; the costing
    functions take the operands as tensors, so a test can feed them the
    reference's."""
    shape = tuple(shape)
    dev = gen.device
    bits = (torch.rand(shape + (7,), generator=gen, device=dev)
            < 1.0 - bit_sparsity).to(torch.int32)
    weights = torch.arange(7, dtype=torch.int32, device=dev)
    mag = (bits << weights).sum(dim=-1).to(torch.int32)
    sign = torch.rand(shape, generator=gen, device=dev) < 0.5
    val = torch.where(sign, -mag, mag)
    if value_sparsity_p > 0.0:
        zero = torch.rand(shape, generator=gen, device=dev) < value_sparsity_p
        val = torch.where(zero, torch.zeros_like(val), val)
    return val
