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
