"""BitParticle core numerics: particlization-based dual-factor bit-sparse MAC
(port of ``repro/core/bitparticle.py``).

Bit-exact emulation of the MAC unit of the paper's Section III.  Operands
are 8-bit **sign-magnitude**: 1 sign bit + 7 magnitude bits, range
[-127, 127].  Each 7-bit magnitude is split into four *particles* with bit
widths (2, 2, 2, 1) and LSB weights (0, 2, 4, 6):

    p0 = m[1:0]   p1 = m[3:2]   p2 = m[5:4]   p3 = m[6]

Cross-multiplying the particles of the two operands yields a 4x4 matrix of
*intermediate results* (IRs); IR(i, j) = pa_i * pw_j has LSB weight 2*(i+j)
and position ID 4*i + j.  IRs on the same anti-diagonal (i + j = k) form the
seven *groups* (k = 0..6), split into

    Group Set 0:  k in {0, 2, 4, 6}   -> IDs {0}, {2,5,8}, {7,10,13}, {15}
    Group Set 1:  k in {1, 3, 5}      -> IDs {1,4}, {3,6,9,12}, {11,14}

One IR per group is consumed per cycle, so

    cycles(a, w) = max(1, max_k #nonzero IRs in group k)  in  [1, 4]

The *approximate* variant drops group {0} (k=0) and group {1,4} (k=1):

    approx(|a|, |w|) = |a|*|w| - a0*w0 - 4*(a0*w1 + a1*w0)

with a0 = |a| & 3, a1 = (|a| >> 2) & 3 (same for w), sign applied after.

Every function takes integer tensors (or anything ``torch.as_tensor``
accepts) of any shape and works elementwise in int32, on the tensors'
device.  They are the oracle of the cost models, not of the CUDA kernel,
whose plain version is ``kernels/bitparticle_matmul/ref.py``.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Static structure of the particlization (Section III-A, Fig. 4).
# ---------------------------------------------------------------------------

PARTICLE_WIDTHS = (2, 2, 2, 1)          # widths of p0..p3 (LSB..MSB order)
PARTICLE_LSB_WEIGHTS = (0, 2, 4, 6)     # LSB weight of p0..p3
NUM_PARTICLES = 4
NUM_GROUPS = 7                           # anti-diagonals k = i + j in 0..6

#: group k -> tuple of position IDs (ID = 4*i + j) lying on anti-diagonal k.
GROUP_IDS = tuple(
    tuple(4 * i + j for i in range(4) for j in range(4) if i + j == k)
    for k in range(NUM_GROUPS)
)

#: the paper's two group sets (by anti-diagonal index k).
GROUP_SET0 = (0, 2, 4, 6)   # LSB weights 0, 4, 8, 12  -> one 13-bit PP
GROUP_SET1 = (1, 3, 5)      # LSB weights 2, 6, 10     -> one 13-bit PP

#: groups discarded by the approximate variant: group "0" and group "1-4".
APPROX_DROPPED_GROUPS = (0, 1)

#: the seven representable IR values (2-bit x 2-bit products).
IR_VALUE_SET = (0, 1, 2, 3, 4, 6, 9)

MAX_MAGNITUDE = 127          # sign-magnitude 8-bit range is [-127, 127]
MAX_CYCLES = 4               # largest group has 4 IRs
MAX_PARTIAL_PRODUCTS = 7     # 3 from set 0 + 4 from set 1

# i + j for the (4, 4) IR matrix: the anti-diagonal (= group) of a position.
_DIAG_INDEX = np.add.outer(np.arange(4), np.arange(4))


def _int32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


# ---------------------------------------------------------------------------
# Sign-magnitude helpers.
# ---------------------------------------------------------------------------

def to_sign_magnitude(x):
    """Split signed ints in [-127, 127] into (sign, magnitude), both int32;
    sign is 1 for negative, 0 otherwise."""
    x = _int32(x)
    return (x < 0).to(torch.int32), x.abs()


def from_sign_magnitude(sign, mag):
    sign, mag = _int32(sign), _int32(mag)
    return torch.where(sign != 0, -mag, mag)


# ---------------------------------------------------------------------------
# Step 1-2: particlization and the IR matrix.
# ---------------------------------------------------------------------------

def particlize(mag):
    """Split 7-bit magnitudes into particles, LSB first:
    [m&3, (m>>2)&3, (m>>4)&3, (m>>6)&1].  Returns (..., 4) int32."""
    mag = _int32(mag)
    return torch.stack([mag & 3, (mag >> 2) & 3, (mag >> 4) & 3,
                        (mag >> 6) & 1], dim=-1)


def unparticlize(particles):
    """Inverse of :func:`particlize`."""
    p = _int32(particles)
    return p[..., 0] + (p[..., 1] << 2) + (p[..., 2] << 4) + (p[..., 3] << 6)


def ir_matrix(mag_a, mag_w):
    """IR[..., i, j] = particle_i(|a|) * particle_j(|w|), LSB weight
    2*(i+j).  Returns (..., 4, 4) int32."""
    return particlize(mag_a)[..., :, None] * particlize(mag_w)[..., None, :]


def _diag_mask(k: int, device) -> torch.Tensor:
    return torch.as_tensor(_DIAG_INDEX == k, device=device).to(torch.int32)


# ---------------------------------------------------------------------------
# Step 3-5: grouping, selection, concatenation, accumulation.
# ---------------------------------------------------------------------------

def group_nonzero_counts(mag_a, mag_w):
    """#nonzero IRs per anti-diagonal group.  Returns (..., 7) int32."""
    nz = (ir_matrix(mag_a, mag_w) != 0).to(torch.int32)
    return torch.stack([(nz * _diag_mask(k, nz.device)).sum(dim=(-2, -1))
                        for k in range(NUM_GROUPS)],
                       dim=-1).to(torch.int32)


def mac_cycles(a, w, approx: bool = False):
    """Initiation interval (cycles) of one BitParticle MAC, elementwise:
    max(1, max_k nnz_k) over the groups the variant evaluates.  A zero
    product still costs one cycle here; zero-value filtering (cost 0) is an
    array-level mechanism of the simulator."""
    _, mag_a = to_sign_magnitude(a)
    _, mag_w = to_sign_magnitude(w)
    counts = group_nonzero_counts(mag_a, mag_w)
    if approx:
        keep = torch.tensor([k not in APPROX_DROPPED_GROUPS
                             for k in range(NUM_GROUPS)],
                            dtype=torch.int32, device=counts.device)
        counts = counts * keep
    return torch.clamp_min(counts.amax(dim=-1), 1)


def magnitude_product_from_irs(mag_a, mag_w, dropped_groups=()):
    """|a|*|w| as the weighted IR sum (the hardware's math), with the IRs
    of the anti-diagonals in ``dropped_groups`` discarded."""
    irs = ir_matrix(mag_a, mag_w)
    weights = np.left_shift(1, 2 * _DIAG_INDEX).astype(np.int64)
    for k in dropped_groups:
        weights = np.where(_DIAG_INDEX == k, 0, weights)
    wt = torch.as_tensor(weights, device=irs.device).to(torch.int32)
    return (irs * wt).sum(dim=(-2, -1)).to(torch.int32)


def multiply_exact(a, w):
    """Signed exact BitParticle product (== a * w)."""
    sa, ma = to_sign_magnitude(a)
    sw, mw = to_sign_magnitude(w)
    return from_sign_magnitude(sa ^ sw, magnitude_product_from_irs(ma, mw))


def multiply_approx(a, w):
    """Signed approximate BitParticle product (groups {0}, {1,4} dropped)."""
    sa, ma = to_sign_magnitude(a)
    sw, mw = to_sign_magnitude(w)
    return from_sign_magnitude(
        sa ^ sw, magnitude_product_from_irs(ma, mw, APPROX_DROPPED_GROUPS))


def approx_correction(a, w):
    """The signed term the approximate variant subtracts:
    ``multiply_approx(a, w) == a*w - approx_correction(a, w)`` with
    correction = s * (a0*w0 + 4*(a0*w1 + a1*w0)), s = sign(a)*sign(w)."""
    sa, ma = to_sign_magnitude(a)
    sw, mw = to_sign_magnitude(w)
    a0, a1 = ma & 3, (ma >> 2) & 3
    w0, w1 = mw & 3, (mw >> 2) & 3
    return from_sign_magnitude(sa ^ sw, a0 * w0 + 4 * (a0 * w1 + a1 * w0))


# ---------------------------------------------------------------------------
# Cycle-by-cycle partial-product assembly (Section III-B1): one nonzero IR
# per group per cycle by priority (lowest position ID first), the set-0 and
# set-1 selections concatenated into two partial products, added and
# accumulated.  Scalar Python, for the tests of the <= 7-PP and
# overlap-freedom claims.
# ---------------------------------------------------------------------------

def assemble_partial_products(a: int, w: int):
    """Returns (product, pps, cycles); ``pps`` lists the (set0_pp, set1_pp)
    pair produced per cycle, before the sign is applied."""
    a, w = int(a), int(w)
    if abs(a) > MAX_MAGNITUDE or abs(w) > MAX_MAGNITUDE:
        raise ValueError(f"operands must lie in [-127, 127]: {a}, {w}")
    sign = (a < 0) != (w < 0)
    ma, mw = abs(a), abs(w)
    pa = [(ma >> s) & (2 ** wd - 1)
          for s, wd in zip(PARTICLE_LSB_WEIGHTS, PARTICLE_WIDTHS)]
    pw = [(mw >> s) & (2 ** wd - 1)
          for s, wd in zip(PARTICLE_LSB_WEIGHTS, PARTICLE_WIDTHS)]
    pending = {4 * i + j: pa[i] * pw[j]
               for i in range(4) for j in range(4) if pa[i] * pw[j]}
    pps = []
    acc = 0
    cycles = 0
    while True:
        cycles += 1
        set_pps = []
        for group_set in (GROUP_SET0, GROUP_SET1):
            pp = 0
            for k in group_set:
                for pos in GROUP_IDS[k]:          # priority: lowest ID first
                    if pos in pending:
                        field = pending.pop(pos) << (2 * k)
                        if pp & field:
                            raise AssertionError(
                                "concatenation fields overlap")
                        pp |= field               # concatenation
                        break
            set_pps.append(pp)
        pps.append(tuple(set_pps))
        acc += set_pps[0] + set_pps[1]            # the 13-bit adder
        if not pending:
            break
        if cycles >= MAX_CYCLES:
            raise AssertionError("more cycles than the largest group")
    return (-acc if sign else acc), pps, max(1, cycles)


# ---------------------------------------------------------------------------
# 3-bit IR encoding (Section III-B3): values {0,1,2,3,4,6,9}, 9 -> 0b111.
# ---------------------------------------------------------------------------

def ir_encode3(ir):
    """Encode an IR value in {0,1,2,3,4,6,9} into 3 bits (9 -> 7)."""
    ir = _int32(ir)
    return torch.where(ir == 9, 7, ir).to(torch.int32)


def ir_decode3(code):
    """Inverse of :func:`ir_encode3` (7 -> 9)."""
    code = _int32(code)
    return torch.where(code == 7, 9, code).to(torch.int32)


# ---------------------------------------------------------------------------
# Skipped-calculations metric (Section V-C, Fig. 11): a 7x7 grid of
# single-bit products per MAC; a product with a zero operand bit is
# skippable.  Metric = skipped / 49.
# ---------------------------------------------------------------------------

def _popcount7(mag):
    """Set bits among bits 0..6 of each int (the reference's bit loop, as a
    SWAR sum in the input's integer dtype)."""
    m = torch.as_tensor(mag)
    m = m & 127
    m = m - ((m >> 1) & 0x55)
    m = (m & 0x33) + ((m >> 2) & 0x33)
    return (m + (m >> 4)) & 0x0F


def skipped_calculations(a, w, method: str):
    """Fraction of the 49 single-bit products skipped, elementwise:
    ``ideal`` (a zero bit on either side), ``bit_serial`` (zero bits of
    ``a`` only), ``bp_exact`` (products inside all-zero 2-bit particles,
    both sides), ``bp_approx`` (bp_exact plus the dropped groups k in
    {0, 1})."""
    _, ma = to_sign_magnitude(a)
    _, mw = to_sign_magnitude(w)
    if method == "ideal":
        computed = _popcount7(ma) * _popcount7(mw)
    elif method == "bit_serial":
        computed = _popcount7(ma) * 7
    elif method in ("bp_exact", "bp_approx"):
        widths = torch.tensor(PARTICLE_WIDTHS, dtype=torch.int32,
                              device=ma.device)
        wa = (particlize(ma) != 0).to(torch.int32) * widths
        ww = (particlize(mw) != 0).to(torch.int32) * widths
        pair = wa[..., :, None] * ww[..., None, :]   # (..., 4, 4) products
        if method == "bp_approx":
            keep = torch.as_tensor(_DIAG_INDEX >= 2,
                                   device=ma.device).to(torch.int32)
            pair = pair * keep
        computed = pair.sum(dim=(-2, -1))
    else:
        raise ValueError(f"unknown method: {method}")
    return 1.0 - computed.to(torch.float32) / 49.0
