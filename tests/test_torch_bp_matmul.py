"""BitParticle matmul in the PyTorch port against the JAX reference.

The port's plain version (what its wrapper runs for CPU tensors) must match
the reference bit for bit: the int32 accumulators against the algebraic
reference and the Pallas kernel in interpret mode, on the shapes of
``test_kernel_bitparticle_matmul.py``, in exact and approximate modes; the
elementwise 4x4-IR hardware oracle; and ``quantized_matmul`` end to end in
bf16 against the reference's plain (``xla``) path.  Inputs are made with
numpy from fixed seeds and handed to both packages.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import bp_matmul as jbp
from repro.core import quant as jquant
from repro.kernels.bitparticle_matmul import bp_matmul as jax_bp_matmul
from repro.kernels.bitparticle_matmul import ref as jref
from repro_torch.core import bp_matmul as tbp
from repro_torch.core import quant as tquant
from repro_torch.kernels.bitparticle_matmul import ops, ref as tref

SHAPES = [
    (8, 128, 128),      # single block
    (16, 256, 384),     # multi-block in N/K
    (256, 256, 256),    # exact default blocks
    (5, 33, 17),        # ragged everything
    (1, 128, 1),        # degenerate edges
    (300, 520, 260),    # multi-block with padding
]
MODES = [("bp_exact", False), ("bp_approx", True)]


def _rand_q(rng, shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bf16_pair(x):
    """The same bf16 values for both packages (rounded once, by JAX)."""
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    return xj, xt


@pytest.mark.parametrize("mode,approx", MODES, ids=["exact", "approx"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_int32_matches_reference_and_interpret_kernel(m, k, n, mode,
                                                            approx):
    rng = np.random.default_rng(m * 1000003 + k * 101 + n)
    a, w = _rand_q(rng, (m, k)), _rand_q(rng, (k, n))
    got = ops.bp_matmul(_t(a), ops.kmajor(_t(w)), approx=approx)
    assert got.dtype == torch.int32
    want_ref = np.asarray(jref.bp_matmul_ref(jnp.asarray(a), jnp.asarray(w),
                                             mode))
    want_kernel = np.asarray(jax_bp_matmul(
        jnp.asarray(a), jnp.asarray(w), approx=approx, interpret=True,
        block_m=128, block_n=128, block_k=128))
    np.testing.assert_array_equal(got.numpy(), want_ref)
    np.testing.assert_array_equal(got.numpy(), want_kernel)
    np.testing.assert_array_equal(
        tref.bp_matmul_ref(_t(a), _t(w), mode).numpy(), want_ref)


@pytest.mark.parametrize("mode,approx", MODES, ids=["exact", "approx"])
def test_plain_matches_elementwise_hardware_oracle(mode, approx):
    rng = np.random.default_rng(7)
    a, w = _rand_q(rng, (6, 40)), _rand_q(rng, (40, 9))
    want = np.asarray(jref.bp_matmul_elementwise_oracle(
        jnp.asarray(a, jnp.int32), jnp.asarray(w, jnp.int32), mode))
    got = ops.bp_matmul(_t(a), _t(w), approx=approx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_signed_low_particles_match_on_every_int8_value():
    q = np.arange(-127, 128, dtype=np.int32)
    for got, want in zip(tbp.signed_low_particles(_t(q)),
                         jbp.signed_low_particles(jnp.asarray(q))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode,approx", MODES, ids=["exact", "approx"])
def test_fused_dequant_epilogue(mode, approx):
    # the port multiplies the scales first, float(acc) * (sa * sw): bit for
    # bit the reference's plain path; the reference's Pallas kernel rounds
    # in the other order, (acc * sa) * sw, so it agrees to its own 1e-6
    rng = np.random.default_rng(11)
    m, k, n = 24, 96, 48
    a, w = _rand_q(rng, (m, k)), _rand_q(rng, (k, n))
    sa = rng.uniform(0.01, 0.1, m).astype(np.float32)
    sw = rng.uniform(0.001, 0.01, n).astype(np.float32)
    got = ops.bp_matmul(_t(a), _t(w), _t(sa), _t(sw), approx=approx)
    assert got.dtype == torch.float32
    acc = jbp.bp_matmul_int(jnp.asarray(a), jnp.asarray(w), mode)
    want_plain = np.asarray(acc.astype(jnp.float32)
                            * (jnp.asarray(sa)[:, None]
                               * jnp.asarray(sw)[None, :]))
    np.testing.assert_array_equal(got.numpy(), want_plain)
    want_kernel = np.asarray(jax_bp_matmul(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(sa), jnp.asarray(sw),
        approx=approx, interpret=True, block_m=8, block_n=128, block_k=128))
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=1e-6)


def test_leading_batch_dims():
    rng = np.random.default_rng(5)
    a, w = _rand_q(rng, (2, 3, 64)), _rand_q(rng, (64, 32))
    got = ops.bp_matmul(_t(a), _t(w))
    want = np.asarray(jref.bp_matmul_ref(jnp.asarray(a.reshape(6, 64)),
                                         jnp.asarray(w))).reshape(2, 3, 32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["bp_exact", "bp_approx"])
@pytest.mark.parametrize("lead", [(64,), (3, 5)], ids=["rows", "batched"])
def test_quantized_matmul_bf16_bit_exact(mode, lead):
    rng = np.random.default_rng(len(lead) * 7 + (mode == "bp_approx"))
    k, n = 96, 40
    x = (rng.standard_normal((*lead, k)) * 3).astype(np.float32)
    x.reshape(-1, k)[0] *= 1e3          # one large-magnitude row
    x.reshape(-1, k)[1] = 0.0           # one all-zero row (eps scale)
    w = rng.standard_normal((k, n)).astype(np.float32)
    wq, ws = jquant.quantize_per_channel(jnp.asarray(w), -1)
    xj, xt = _bf16_pair(x)
    with jbp.use_matmul_backend("xla"):
        want = jbp.quantized_matmul(xj, wq, ws.reshape(-1), mode)
    got = tbp.quantized_matmul(xt, ops.kmajor(_t(np.asarray(wq))),
                               _t(np.asarray(ws).reshape(-1)), mode)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (*lead, n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_activation_quantization_divides_in_bf16():
    # the scale is computed in bf16 and x / scale is a bf16 division, as in
    # the reference; dividing in float32 would move ~8% of the int8 values
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((512, 1536)) * 2).astype(np.float32)
    xj, xt = _bf16_pair(x)
    sj = jquant.compute_scale(xj, axis=(-1,))
    qj = jquant.quantize(xj, sj)
    st = tquant.compute_scale(xt, axis=(-1,))
    qt = tquant.quantize(xt, st)
    assert st.dtype == torch.bfloat16
    np.testing.assert_array_equal(st.float().numpy(),
                                  np.asarray(sj.astype(jnp.float32)))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    q_f32 = tquant.quantize(xt.float(), st.float())
    assert (q_f32 != qt).any()


def test_quantize_per_channel_matches_reference():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 64, 48)).astype(np.float32)
    qj, sj = jquant.quantize_per_channel(jnp.asarray(w), -1)
    qt, st = tquant.quantize_per_channel(_t(w), -1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_backend_choice_follows_the_tensor_device():
    rng = np.random.default_rng(9)
    a, w = _t(_rand_q(rng, (4, 32))), _t(_rand_q(rng, (32, 8)))
    ops.reset_launches()
    auto = ops.bp_matmul(a, w)
    plain = ops.bp_matmul(a, w, backend="plain")
    assert torch.equal(auto, plain)
    assert ops.LAUNCHES["bp_matmul"] == 0   # plain calls are not launches
    with pytest.raises(ValueError, match="CUDA"):
        ops.bp_matmul(a, w, backend="kernel")
    with pytest.raises(ValueError, match="unknown matmul backend"):
        ops.bp_matmul(a, w, backend="xla")
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.bp_matmul(a, w[:16])
    with pytest.raises(ValueError, match="both scales"):
        ops.bp_matmul(a, w, torch.ones(4))


def test_kmajor_keeps_values_and_logical_shape():
    w = _t(_rand_q(np.random.default_rng(1), (2, 40, 24)))
    km = ops.kmajor(w)
    assert km.shape == w.shape and torch.equal(km, w)
    assert ops.is_kmajor(km[1]) and not ops.is_kmajor(w[1])
    assert km[1].stride() == (1, 40)
