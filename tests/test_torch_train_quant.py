"""Training numerics of the PyTorch port against the JAX reference:
``fake_quant`` and ``dense_apply`` in every matmul mode, forward and
gradients, the STE matmul and ``quantized_gather`` as autograd Functions,
and the WKV6 wrapper's refusal of inputs that need a gradient.

The reference's gradients come from ``jax.vjp`` of the same function on
the same float32 inputs (made with numpy from fixed seeds).  float32
results agree within 1e-6; in the bp_* modes both packages give the float
weight an exactly-zero gradient (the reference's STE returns zeros for
the int8 weight, and the weight is quantized with ``round`` on every
call), which ROADMAP Queue 3 records as a reference caveat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bp_matmul as jbp
from repro.core import quant as jquant
from repro_torch.configs.base import get_arch
from repro_torch.core import bp_matmul as tbp
from repro_torch.core import quant as tquant
from repro_torch.kernels.build import KernelInputError
from repro_torch.kernels.wkv6 import ops as wkv_ops

TOL = dict(rtol=1e-6, atol=1e-6)
MODES = ["bf16", "qat", "bp_exact", "bp_approx", "bf16+q8gather",
         "qat+q8gather", "bp_exact+q8gather", "bp_approx+q8gather"]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, what, **tol):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what,
                               **(tol or TOL))


def _inputs(seed, m=6, k=48, n=40, wscale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * wscale).astype(np.float32)
    g = rng.standard_normal((2, m, n)).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
def test_fake_quant_forward_and_ste_backward(per_channel):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((16, 24)) * 2).astype(np.float32)
    g = rng.standard_normal((16, 24)).astype(np.float32)
    axis = (0,) if per_channel else None
    # a scale below max|x| / 127 puts some values outside the clip range,
    # where the straight-through gradient is zero
    scale = np.array(jquant.compute_scale(jnp.asarray(x), axis) * 0.7,
                     dtype=np.float32, ndmin=0)
    y_j, vjp = jax.vjp(jquant.fake_quant, jnp.asarray(x), jnp.asarray(scale))
    gx_j, gs_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.tensor(scale).requires_grad_(True)
    y_t = tquant.fake_quant(xt, st)
    gx_t, gs_t = torch.autograd.grad(y_t, (xt, st), torch.from_numpy(g))
    np.testing.assert_array_equal(_np(y_t), np.asarray(y_j))
    np.testing.assert_array_equal(_np(gx_t), np.asarray(gx_j))
    assert 0 < float((np.asarray(gx_j) == 0).mean()) < 1   # the mask bites
    assert not np.any(_np(gs_t)) and not np.any(np.asarray(gs_j))
    # the other helpers the reference has
    q_j, s_j = jquant.quantize_per_tensor(jnp.asarray(x))
    q_t, s_t = tquant.quantize_per_tensor(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(q_t), np.asarray(q_j))
    np.testing.assert_array_equal(_np(tquant.dequantize(q_t, s_t)),
                                  np.asarray(jquant.dequantize(q_j, s_j)))


@pytest.mark.parametrize("mode", MODES)
def test_dense_apply_forward_and_grads_match_reference(mode):
    x, w, g = _inputs(MODES.index(mode))
    y_j, vjp = jax.vjp(lambda a, b: jbp.dense_apply(a, b, mode),
                       jnp.asarray(x), jnp.asarray(w))
    gx_j, gw_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y_t = tbp.dense_apply(xt, wt, mode)
    gx_t, gw_t = torch.autograd.grad(y_t, (xt, wt), torch.from_numpy(g),
                                     allow_unused=True, materialize_grads=True)
    _close(y_t, y_j, f"{mode} forward")
    _close(gx_t, gx_j, f"{mode} gx")
    _close(gw_t, gw_j, f"{mode} gw")
    quantized = tbp.base_mode(mode).startswith("bp_")
    # the bp_* weights learn nothing, in both packages; the others do
    assert (not np.any(np.asarray(gw_j))) == quantized
    assert (not np.any(_np(gw_t))) == quantized


@pytest.mark.parametrize("mode", ["bp_exact", "bp_approx"])
def test_quantized_matmul_is_an_autograd_function_with_the_reference_ste(
        mode):
    x, w, g = _inputs(11)
    w_q, w_s = jquant.quantize_per_channel(jnp.asarray(w), channel_axis=-1)
    w_s = w_s.reshape(-1)
    y_j, vjp = jax.vjp(lambda a, s: jbp.quantized_matmul(a, w_q, s, mode),
                       jnp.asarray(x), w_s)
    gx_j, gs_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.tensor(np.asarray(w_s)).requires_grad_(True)
    wq_t = torch.tensor(np.asarray(w_q))
    y_t = tbp.quantized_matmul(xt, wq_t, st, mode)
    assert y_t.grad_fn is not None and \
        type(y_t.grad_fn).__name__ == "QuantizedMatmulBackward"
    gx_t, gs_t = torch.autograd.grad(y_t, (xt, st), torch.from_numpy(g))
    _close(y_t, y_j, "forward")
    _close(gx_t, gx_j, "gx")
    assert not np.any(_np(gs_t)) and not np.any(np.asarray(gs_j))


def test_quantized_gather_quantizes_forward_and_passes_grads_through():
    _, w, _ = _inputs(5)
    g = np.random.default_rng(6).standard_normal(w.shape).astype(np.float32)
    y_j, vjp = jax.vjp(jbp.quantized_gather, jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    y_t = tbp.quantized_gather(wt)
    (gw_t,) = torch.autograd.grad(y_t, wt, torch.from_numpy(g))
    np.testing.assert_array_equal(_np(y_t), np.asarray(y_j))
    np.testing.assert_array_equal(_np(gw_t), np.asarray(vjp(
        jnp.asarray(g))[0]))
    assert np.any(_np(y_t) != w)     # it did quantize


def test_modes_are_accepted_by_the_config():
    cfg = get_arch("qwen2-1.5b")
    for mode in MODES:
        assert cfg.replace(matmul_mode=mode).matmul_mode == mode
    assert set(tbp.MODES) == set(jbp.MODES)
    with pytest.raises(NotImplementedError, match="not ported"):
        cfg.replace(matmul_mode="fp8")
    with pytest.raises(ValueError, match="int8 weights"):
        tbp.dense_apply(torch.zeros(2, 4), torch.zeros(4, 3,
                                                       dtype=torch.int8),
                        "bp_exact")


@pytest.mark.parametrize("backend", ["auto", "kernel"])
def test_wkv6_wrapper_refuses_inputs_that_need_a_gradient(backend):
    rng = np.random.default_rng(2)
    R, T, N = 2, 16, 8
    r, k, v = (torch.from_numpy(rng.standard_normal((R, T, N)).astype(
        np.float32)) for _ in range(3))
    log_w = -torch.rand(R, T, N)
    u = torch.zeros(R, N)
    state = torch.zeros(R, N, N)
    r.requires_grad_(True)
    with pytest.raises(KernelInputError, match="no backward"):
        wkv_ops.wkv6_rows(r, k, v, log_w, u, state, chunk=16,
                          backend=backend)
    # the plain version, named, is differentiable; without grad the
    # wrapper runs as before
    out, s = wkv_ops.wkv6_rows(r, k, v, log_w, u, state, chunk=16,
                               backend="plain")
    (gr,) = torch.autograd.grad(out.sum() + s.sum(), r)
    assert torch.isfinite(gr).all() and gr.abs().sum() > 0
    with torch.no_grad():
        out2, _ = wkv_ops.wkv6_rows(r, k, v, log_w, u, state, chunk=16,
                                    backend="auto")
    torch.testing.assert_close(out2, out.detach(), rtol=0, atol=0)
