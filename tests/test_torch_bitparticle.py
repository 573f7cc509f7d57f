"""The BitParticle MAC emulation and the sparsity statistics of the PyTorch
port (``repro_torch.core.bitparticle``, ``repro_torch.core.sparsity``)
against the JAX package's, on the same numpy operands.

Integer results must be equal.  The MAC's functions are held on all 255 x
255 pairs of sign-magnitude int8 operands; the sparsity sums on seeded
tensors with -128 and zeros among their values.  Float rates (means of the
same integers in float32) must agree within 1e-6.  The port's operand
generator cannot reproduce ``jax.random``: it is held to its distribution
(each rate within 5 binomial standard errors of the one asked for) and to
being a function of its seed.
"""

import numpy as np
import pytest
import torch

from repro.core import bitparticle as jbp
from repro.core import sparsity as jsp
from repro_torch.core import bitparticle as tbp
from repro_torch.core import sparsity as tsp

VALS = np.arange(-127, 128, dtype=np.int32)
A_ALL, W_ALL = (g.reshape(-1) for g in np.meshgrid(VALS, VALS,
                                                   indexing="ij"))
RNG_INTS = np.random.default_rng(0).integers(-128, 128, (3, 5, 33),
                                             dtype=np.int64)


def _np(x):
    return np.array(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


PAIR_FNS = {
    "mac_cycles": lambda m, a, w: m.mac_cycles(a, w),
    "mac_cycles_approx": lambda m, a, w: m.mac_cycles(a, w, approx=True),
    "multiply_exact": lambda m, a, w: m.multiply_exact(a, w),
    "multiply_approx": lambda m, a, w: m.multiply_approx(a, w),
    "approx_correction": lambda m, a, w: m.approx_correction(a, w),
    "group_nonzero_counts": lambda m, a, w: m.group_nonzero_counts(
        np.abs(a), np.abs(w)),
    "ir_matrix": lambda m, a, w: m.ir_matrix(np.abs(a), np.abs(w)),
    "magnitude_product_from_irs": lambda m, a, w:
        m.magnitude_product_from_irs(np.abs(a), np.abs(w)),
    "magnitude_product_approx": lambda m, a, w:
        m.magnitude_product_from_irs(np.abs(a), np.abs(w),
                                     m.APPROX_DROPPED_GROUPS),
}


@pytest.mark.parametrize("name", list(PAIR_FNS))
def test_all_int8_pairs_equal_reference(name):
    fn = PAIR_FNS[name]
    got = _np(fn(tbp, A_ALL, W_ALL))
    want = _np(fn(jbp, A_ALL, W_ALL))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_exact_multiply_is_the_integer_product():
    np.testing.assert_array_equal(_np(tbp.multiply_exact(A_ALL, W_ALL)),
                                  A_ALL * W_ALL)
    np.testing.assert_array_equal(
        _np(tbp.multiply_approx(A_ALL, W_ALL)),
        A_ALL * W_ALL - _np(tbp.approx_correction(A_ALL, W_ALL)))


@pytest.mark.parametrize("method", ["ideal", "bit_serial", "bp_exact",
                                    "bp_approx"])
def test_skipped_calculations_equal_reference(method):
    got = _np(tbp.skipped_calculations(A_ALL, W_ALL, method))
    want = _np(jbp.skipped_calculations(A_ALL, W_ALL, method))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_skipped_calculations_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown method"):
        tbp.skipped_calculations(A_ALL[:4], W_ALL[:4], "bogus")


@pytest.mark.parametrize("case", ["sign_magnitude", "particlize",
                                  "unparticlize", "popcount7", "ir_codes"])
def test_elementwise_helpers_equal_reference(case):
    ints = np.arange(-300, 301, dtype=np.int32)   # beyond int8 too
    if case == "sign_magnitude":
        for got, want in zip(tbp.to_sign_magnitude(VALS),
                             jbp.to_sign_magnitude(VALS)):
            np.testing.assert_array_equal(_np(got), _np(want))
        sign, mag = jbp.to_sign_magnitude(VALS)
        np.testing.assert_array_equal(
            _np(tbp.from_sign_magnitude(_np(sign), _np(mag))), VALS)
    elif case == "particlize":
        np.testing.assert_array_equal(_np(tbp.particlize(np.abs(VALS))),
                                      _np(jbp.particlize(np.abs(VALS))))
    elif case == "unparticlize":
        parts = _np(jbp.particlize(np.abs(VALS)))
        np.testing.assert_array_equal(_np(tbp.unparticlize(parts)),
                                      np.abs(VALS))
    elif case == "popcount7":
        np.testing.assert_array_equal(_np(tbp._popcount7(ints)),
                                      _np(jbp._popcount7(ints)))
    else:
        irs = np.array(jbp.IR_VALUE_SET, np.int32)
        codes = _np(tbp.ir_encode3(irs))
        np.testing.assert_array_equal(codes, _np(jbp.ir_encode3(irs)))
        assert codes.max() < 8
        np.testing.assert_array_equal(_np(tbp.ir_decode3(codes)), irs)


def test_static_structure_equals_reference():
    for name in ("PARTICLE_WIDTHS", "PARTICLE_LSB_WEIGHTS", "GROUP_IDS",
                 "GROUP_SET0", "GROUP_SET1", "APPROX_DROPPED_GROUPS",
                 "IR_VALUE_SET", "MAX_CYCLES", "MAX_PARTIAL_PRODUCTS"):
        assert getattr(tbp, name) == getattr(jbp, name), name


def test_partial_product_assembly_equals_reference():
    rng = np.random.default_rng(1)
    pairs = [(0, 0), (127, 127), (-127, 127), (85, -42)] + [
        tuple(int(v) for v in rng.integers(-127, 128, 2)) for _ in range(200)]
    for a, w in pairs:
        got = tbp.assemble_partial_products(a, w)
        assert got == jbp.assemble_partial_products(a, w)
        assert got[0] == a * w
        assert len(got[1]) <= tbp.MAX_CYCLES
    with pytest.raises(ValueError):
        tbp.assemble_partial_products(128, 1)


# --- sparsity ----------------------------------------------------------------

SPARSITY_INPUTS = {
    "ints": RNG_INTS.astype(np.int8),
    "sparse": np.where(np.random.default_rng(2).random((4, 7, 9)) < 0.4, 0,
                       RNG_INTS[0, 0, :9]).astype(np.int8),
    "zeros": np.zeros((2, 3), np.int8),
}


@pytest.mark.parametrize("name", list(SPARSITY_INPUTS))
def test_sm_bit_stats_equal_reference(name):
    q = SPARSITY_INPUTS[name]
    got = _np(tsp.sm_bit_stats(torch.from_numpy(q)))
    want = _np(jsp.sm_bit_stats(q))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_np(tsp.per_layer_stats(q)),
                                  _np(jsp.per_layer_stats(q)))
    for g, w in zip(tsp.stats_to_rates(got), jsp.stats_to_rates(want)):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-6)


@pytest.mark.parametrize("name", list(SPARSITY_INPUTS))
def test_sparsity_rates_equal_reference(name):
    q = SPARSITY_INPUTS[name]
    pairs = [
        (tsp.value_sparsity(q), jsp.value_sparsity(q)),
        (tsp.bit_sparsity_sign_magnitude(q),
         jsp.bit_sparsity_sign_magnitude(q)),
        (tsp.bit_sparsity_sign_magnitude(q, nonzero_only=True),
         jsp.bit_sparsity_sign_magnitude(q, nonzero_only=True)),
        (tsp.bit_sparsity_twos_complement(q),
         jsp.bit_sparsity_twos_complement(q)),
    ]
    for got, want in pairs:
        assert abs(float(got) - float(want)) < 1e-6
    np.testing.assert_array_equal(_np(tsp.popcount8(q)),
                                  _np(jsp.popcount8(q)))


def test_stats_rows_add_and_empty_rows_give_zero():
    rows = np.stack([_np(tsp.sm_bit_stats(q))
                     for q in SPARSITY_INPUTS.values()])
    bs, vs = tsp.stats_to_rates(torch.from_numpy(rows.sum(axis=0)))
    allq = np.concatenate([q.reshape(-1) for q in SPARSITY_INPUTS.values()])
    assert abs(float(bs) - float(jsp.bit_sparsity_sign_magnitude(allq))) \
        < 1e-6
    assert abs(float(vs) - float(jsp.value_sparsity(allq))) < 1e-6
    bs, vs = tsp.stats_to_rates(torch.zeros(2, tsp.N_STATS))
    assert float(bs[0]) == 0.0 and float(vs[1]) == 0.0


@pytest.mark.parametrize("bs,vs", [(0.5, 0.0), (0.8, 0.3), (0.2, 0.0)])
def test_operand_generator_distribution(bs, vs):
    n = 20_000
    draw = tsp.sample_with_bit_sparsity(torch.Generator().manual_seed(3),
                                        (n,), bs, vs)
    again = tsp.sample_with_bit_sparsity(torch.Generator().manual_seed(3),
                                         (n,), bs, vs)
    assert torch.equal(draw, again)
    assert draw.dtype == torch.int32 and int(draw.abs().max()) <= 127
    zero = float((draw == 0).float().mean())
    p_zero = vs + (1 - vs) * bs ** 7
    assert abs(zero - p_zero) < 5 * np.sqrt(p_zero * (1 - p_zero) / n) + 1e-9
    # bit sparsity among elements not forced to zero, as the generator
    # drew it: measured over all of them, forced zeros excluded in mean
    nz = draw[draw != 0]
    got_bs = float(tsp.bit_sparsity_sign_magnitude(nz))
    # conditioned on a nonzero magnitude (at least one set bit)
    p_bit0 = (bs - bs ** 7) / (1 - bs ** 7)
    se = np.sqrt(bs * (1 - bs) / (7 * nz.numel()))
    assert abs(got_bs - p_bit0) < 5 * se * 2
    neg = float((nz < 0).float().mean())
    assert abs(neg - 0.5) < 5 * np.sqrt(0.25 / nz.numel())
