"""The plain version of the WKV6 kernel in the PyTorch port against the JAX
package.

``wkv6_chunked_plain`` (what the port runs on the CPU, and what the CUDA
kernel is held against on the card) and the step oracle ``wkv6_step_ref``
against the reference's Pallas kernel in interpret mode and its step
oracle ``ref.wkv6_ref``, on the shapes of ``test_kernel_wkv6.py``, and the
model-layout wrapper with a zero-padded tail against the reference's
``wkv6``.  Inputs are made with numpy from a seed and handed to both
packages.  Tolerances are that test's own: float32 inputs within 2e-4
(absolute and relative: the two packages sum in other orders), bf16 r/k/v
within 3e-2 (both upcast the same bf16 values; the looser bound is the
reference's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import ref as jref
from repro.kernels.wkv6 import wkv6 as jwkv6
from repro.kernels.wkv6.kernel import wkv6_kernel
from repro.models import rwkv6 as jrwkv6
from repro_torch.kernels.wkv6 import ops, ref
from repro_torch.models import rwkv6

SHAPES = [
    # R, T, N, chunk
    (2, 64, 16, 16),     # multi-chunk
    (1, 32, 32, 32),     # single chunk
    (4, 128, 64, 64),    # production head-dim tile
    (3, 96, 8, 32),      # ragged-ish dims
]
DTYPES = {"f32": (torch.float32, jnp.float32, 2e-4),
          "bf16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _inputs(seed, R, T, N):
    """The reference tests' distributions, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((R, T, N)).astype(np.float32)
               for _ in range(3))
    log_w = -np.exp(rng.standard_normal((R, T, N)) - 1.0).astype(np.float32)
    u = rng.standard_normal((R, N)).astype(np.float32)
    s = (rng.standard_normal((R, N, N)) * 0.2).astype(np.float32)
    return r, k, v, log_w, u, s


def _both(arrays, tdt, jdt):
    """(torch args, jax args): r/k/v in the given dtype, the rest float32."""
    t = [torch.from_numpy(a) for a in arrays]
    j = [jnp.asarray(a) for a in arrays]
    for i in range(3):
        t[i], j[i] = t[i].to(tdt), j[i].astype(jdt)
    return t, j


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("R,T,N,chunk", SHAPES)
def test_plain_matches_pallas_interpret_and_step_oracle(R, T, N, chunk,
                                                        dtype):
    tdt, jdt, tol = DTYPES[dtype]
    targs, jargs = _both(_inputs(R * 1000 + T + N, R, T, N), tdt, jdt)
    out, s = ops.wkv6_rows(*targs, chunk=chunk)
    assert out.dtype == s.dtype == torch.float32
    k_out, k_s = wkv6_kernel(*jargs, chunk=chunk, interpret=True)
    _close(out, k_out, tol)
    _close(s, k_s, tol)
    o_out, o_s = jref.wkv6_ref(*jargs)
    _close(out, o_out, tol)
    _close(s, o_s, tol)


@pytest.mark.parametrize("R,T,N,chunk", SHAPES)
def test_step_oracle_matches_reference_step_oracle(R, T, N, chunk):
    targs, jargs = _both(_inputs(R + T + N, R, T, N), torch.float32,
                         jnp.float32)
    out, s = ref.wkv6_step_ref(*targs)
    o_out, o_s = jref.wkv6_ref(*jargs)
    _close(out, o_out, 2e-4)
    _close(s, o_s, 2e-4)
    # and the chunked plain version agrees with it at another chunk length
    c_out, c_s = ref.wkv6_chunked_plain(*targs, chunk=T // 2)
    np.testing.assert_allclose(c_out.numpy(), out.numpy(), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(c_s.numpy(), s.numpy(), atol=2e-4, rtol=2e-4)


def _model_layout(seed, B, S, H, N):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    log_w = -np.exp(rng.standard_normal((B, S, H, N))).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, log_w, u, s0


def test_model_layout_wrapper_with_padding():
    """(B, S, H, N) entry point, S not a chunk multiple (the zero-padded
    tail), against the reference's wrapper and its step recurrence."""
    arrays = _model_layout(3, 2, 50, 3, 16)
    targs = [torch.from_numpy(a) for a in arrays]
    jargs = [jnp.asarray(a) for a in arrays]
    out, s = ops.wkv6(*targs, chunk=32)
    assert tuple(out.shape) == (2, 50, 3, 16)
    want_out, want_s = jwkv6(*jargs, chunk=32, interpret=True)
    _close(out, want_out, 2e-4)
    _close(s, want_s, 2e-4)
    seq_out, seq_s = jrwkv6.wkv_sequential(*jargs)
    _close(out, seq_out, 2e-4)
    _close(s, seq_s, 2e-4)


@pytest.mark.parametrize("S,chunk", [(64, 16), (64, 64), (7, 64)])
def test_model_recurrences_match_reference(S, chunk):
    """The model module's step loop and chunked form against the
    reference's (the chunked one only where S is a chunk multiple)."""
    arrays = _model_layout(S + chunk, 2, S, 2, 8)
    targs = [torch.from_numpy(a) for a in arrays]
    jargs = [jnp.asarray(a) for a in arrays]
    out, s = rwkv6.wkv_sequential(*targs)
    want_out, want_s = jrwkv6.wkv_sequential(*jargs)
    _close(out, want_out, 2e-4)
    _close(s, want_s, 2e-4)
    if S % chunk == 0:
        out, s = rwkv6.wkv_chunked(*targs, chunk=chunk)
        want_out, want_s = jrwkv6.wkv_chunked(*jargs, chunk=chunk)
        _close(out, want_out, 2e-4)
        _close(s, want_s, 2e-4)
    else:
        with pytest.raises(ValueError, match="multiple of the chunk"):
            rwkv6.wkv_chunked(*targs, chunk=chunk)


def test_plain_leaves_the_input_state_alone():
    targs, _ = _both(_inputs(5, 2, 64, 16), torch.float32, jnp.float32)
    before = targs[-1].clone()
    ops.wkv6_rows(*targs, chunk=16)
    assert torch.equal(targs[-1], before)


def test_kernel_backend_refuses_cpu_tensors_and_unknown_backends():
    targs, _ = _both(_inputs(6, 1, 32, 8), torch.float32, jnp.float32)
    ops.reset_launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.wkv6_rows(*targs, chunk=32, backend="kernel")
    with pytest.raises(ValueError, match="unknown wkv6 backend"):
        ops.wkv6_rows(*targs, chunk=32, backend="interpret")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.wkv6_rows(*targs, chunk=64)
    # CPU tensors under "auto" run the plain version, and count nothing
    ops.wkv6_rows(*targs, chunk=32)
    assert ops.LAUNCHES["wkv6"] == 0


def _kernel_algebra(r, k, v, log_w, u, s0, chunk):
    """The CUDA kernels' decomposition (``csrc/wkv6.cu``) written out in
    float32 torch: the plain version's prefix sums (cs in step order, lc =
    cs - w, lcs = lc + w); the state chain S_{c+1} = e^{lc_end} S_c + dS_c
    with dS_c = (k e^{lc_end - lcs})^T v; the pair matrix A cut into
    16-step sub-chunks, the diagonal blocks with one exponential per pair
    j < i, the off-diagonal ones factored at the row sub-chunk's first step
    i0 as (r e^{lc - lc_i0}) (k e^{lc_i0 - lcs})^T; and out = (r e^{lc})
    S_c + A v + (r . u k) v.  Every exponent is clamped at 0, as the
    kernels clamp it: its exact value is <= 0, and the float32 prefix sums
    leave those that are exactly 0 (lc_i - lcs_{i-1}) within a few units
    in the last place of |lc| either side.  Returns (out, state, the
    largest exponent formed before the clamp, in units of float32
    rounding of its chunk's largest |lc|)."""
    R, T, N = r.shape
    L = chunk
    tri = torch.tril(torch.ones((16, 16), dtype=torch.bool), diagonal=-1)
    s, outs, top = s0.clone(), [], -float("inf")
    ulp = float(np.finfo(np.float32).eps)

    def ex(x):
        nonlocal top
        top = max(top, float(x.max()) / (ulp * scale))
        return torch.exp(x.clamp(max=0.0))

    for c in range(T // L):
        rc, kc, vc, wc = (t[:, c * L:(c + 1) * L].float()
                          for t in (r, k, v, log_w))
        lc = torch.cumsum(wc, dim=1) - wc
        lcs = lc + wc
        scale = 1.0 + float(lcs.abs().max())
        lce = lcs[:, -1:]                                  # (R, 1, N)
        # the state kernel: S_c goes to the workspace, then the chain
        s_c = s
        kd = kc * ex(lce - lcs)
        s = ex(lce[:, 0])[..., None] * s + kd.transpose(1, 2) @ vc
        # the chunk kernel: A by 16-step sub-chunks
        a_mat = torch.zeros((R, L, L))
        for ti in range(L // 16):
            i0 = 16 * ti
            rows = slice(i0, i0 + 16)
            pair = ex(torch.where(
                tri[None, :, :, None],
                lc[:, rows, None, :] - lcs[:, None, rows, :], -1.0))
            a_mat[:, rows, rows] = torch.where(
                tri, (rc[:, rows, None, :] * kc[:, None, rows, :]
                      * pair).sum(-1), 0.0)
            for tj in range(ti):
                cols = slice(16 * tj, 16 * tj + 16)
                r_e = rc[:, rows] * ex(lc[:, rows] - lc[:, i0:i0 + 1])
                k_i = kc[:, cols] * ex(lc[:, i0:i0 + 1] - lcs[:, cols])
                a_mat[:, rows, cols] = r_e @ k_i.transpose(1, 2)
        bonus = (rc * u[:, None, :] * kc).sum(-1, keepdim=True)
        outs.append((rc * ex(lc)) @ s_c + a_mat @ vc + bonus * vc)
    return torch.cat(outs, dim=1), s, top


def _model_decay_inputs(seed, R, T, N):
    """The reference tests' r/k/v/u/state, with log_w over the model's
    whole decay range -exp([-8, 2])."""
    r, k, v, _, u, s = _inputs(seed, R, T, N)
    rng = np.random.default_rng(seed + 1)
    log_w = -np.exp(rng.uniform(-8.0, 2.0, (R, T, N))).astype(np.float32)
    return r, k, v, log_w, u, s


@pytest.mark.parametrize("R,T,N,chunk,decay", [
    *[(R, T, N, chunk, "reference") for R, T, N, chunk in SHAPES],
    (4, 256, 64, 64, "model")])
def test_kernel_decomposition_matches_pallas_interpret(R, T, N, chunk,
                                                        decay):
    """The decomposition the CUDA kernels compute, against the Pallas
    kernel in interpret mode, within the float32 gate (2e-4).  Every
    exponent it forms is <= 0 but for float32 rounding of the prefix sums
    (at most 4 units in the last place of the chunk's largest |lc|; the
    kernels clamp those at 0), so no factor can overflow."""
    make = _inputs if decay == "reference" else _model_decay_inputs
    arrays = make(R * 7 + T + N, R, T, N)
    out, s, top = _kernel_algebra(*map(torch.from_numpy, arrays), chunk)
    assert top <= 4.0
    want_out, want_s = wkv6_kernel(*map(jnp.asarray, arrays), chunk=chunk,
                                   interpret=True)
    _close(out, want_out, 2e-4)
    _close(s, want_s, 2e-4)
