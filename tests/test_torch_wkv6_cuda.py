"""The chunked WKV6 CUDA kernel against its plain version, on the card.

A CUDA kernel has no CPU or interpret mode, so these tests carry the
``cuda`` marker and skip where no GPU is present.  This file imports no JAX,
so that it also runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_wkv6_cuda.py

Tolerances are the reference's own kernel tests' (``test_kernel_wkv6.py``):
float32 inputs within 2e-4 (absolute and relative), bf16 r/k/v within
3e-2, outputs and states alike.  The kernels and the plain version compute
in float32 from the same upcast inputs; they differ in summation order, in
the exponential's rounding (the kernels factor off-diagonal pair terms into
two exponentials, each <= 1) and in the split-TF32 products of the tensor
cores (three passes, ~2^-21 relative per product).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.wkv6 import ops, ref

SHAPES = [
    # R, T, N, chunk: the reference's kernel-test shapes
    (2, 64, 16, 16),
    (1, 32, 32, 32),
    (4, 128, 64, 64),
    (3, 96, 8, 32),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, R, T, N, dtype, device):
    """The reference tests' distributions: unit normal r/k/v/u, log_w =
    -exp(normal - 1), state normal * 0.2."""
    rng = np.random.default_rng(seed)

    def t(x, dt=torch.float32):
        return torch.from_numpy(x.astype(np.float32)).to(device=device,
                                                         dtype=dt)

    r, k, v = (t(rng.standard_normal((R, T, N)), dtype) for _ in range(3))
    log_w = t(-np.exp(rng.standard_normal((R, T, N)) - 1.0))
    u = t(rng.standard_normal((R, N)))
    s = t(rng.standard_normal((R, N, N)) * 0.2)
    return r, k, v, log_w, u, s


def _tol(dtype):
    return 3e-2 if dtype == torch.bfloat16 else 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("R,T,N,chunk", SHAPES)
def test_kernel_matches_plain(cuda_device, R, T, N, chunk, dtype):
    args = _inputs(R + T + N, R, T, N, dtype, cuda_device)
    ops.reset_launches()
    out, s = ops.wkv6_rows(*args, chunk=chunk)
    assert ops.LAUNCHES["wkv6"] == 1
    want_out, want_s = ops.wkv6_rows(*args, chunk=chunk, backend="plain")
    torch.cuda.synchronize()
    tol = _tol(dtype)
    torch.testing.assert_close(out, want_out, atol=tol, rtol=tol)
    torch.testing.assert_close(s, want_s, atol=tol, rtol=tol)


def _model_decay_case(device, R, T, N, chunk, dtype):
    """rwkv6-7b's prefill rows: log_w inside the model's clipped range
    [-e^2, -e^-8]; the kernel against the plain version."""
    r, k, v, _, u, s0 = _inputs(R, R, T, N, dtype, device)
    rng = np.random.default_rng(R + 1)
    log_w = torch.from_numpy(-np.exp(rng.uniform(-8.0, 2.0, (R, T, N)))
                             .astype(np.float32)).to(device)
    ops.reset_launches()
    out, s = ops.wkv6_rows(r, k, v, log_w, u, s0, chunk=chunk,
                           backend="kernel")
    assert ops.LAUNCHES["wkv6"] == 1
    want_out, want_s = ops.wkv6_rows(r, k, v, log_w, u, s0, chunk=chunk,
                                     backend="plain")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(s).all())
    tol = _tol(dtype)
    torch.testing.assert_close(out, want_out, atol=tol, rtol=tol)
    torch.testing.assert_close(s, want_s, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("R,T", [(64, 256), (256, 256)])
def test_kernel_matches_plain_at_serve_shapes_bf16(cuda_device, R, T):
    # rwkv6-7b prefill: 64 heads of 64 per request, chunk 64, bf16 r/k/v
    _model_decay_case(cuda_device, R, T, 64, 64, torch.bfloat16)


@pytest.mark.cuda
def test_kernel_matches_plain_at_serve_shape_float32(cuda_device):
    # the same rows in float32, held to the float32 gate
    _model_decay_case(cuda_device, 64, 256, 64, 64, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("R,N,chunk", [(64, 64, 64), (5, 16, 16),
                                       (3, 8, 32)])
def test_kernel_one_chunk_rows(cuda_device, R, N, chunk, dtype):
    # T = chunk: the state kernel takes one step, the chunk kernel one
    # chunk per row
    _model_decay_case(cuda_device, R, chunk, N, chunk, dtype)


@pytest.mark.cuda
def test_kernel_one_long_row(cuda_device):
    # R 1 x T 4096: the fewest blocks, one row's state chain (its column
    # blocks) walking 64 chunks
    _model_decay_case(cuda_device, 1, 4096, 64, 64, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_at_the_plans_largest_split(cuda_device, dtype):
    # R 64 x T 128, the rwkv serve's most frequent call: the plan splits
    # each chunk's rows over two blocks
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    R = min(64, sms // 2)
    assert ops.wkv6_plan(sms, R, 128, 64, 64).row_split == 2
    _model_decay_case(cuda_device, R, 128, 64, 64, dtype)


@pytest.mark.cuda
def test_kernel_matches_step_recurrence(cuda_device):
    args = _inputs(7, 2, 64, 16, torch.float32, cuda_device)
    out, s = ops.wkv6_rows(*args, chunk=32, backend="kernel")
    want_out, want_s = ref.wkv6_step_ref(*args)
    torch.testing.assert_close(out, want_out, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s, want_s, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_model_layout_wrapper_with_padding(cuda_device):
    rng = np.random.default_rng(3)
    B, S, H, N = 2, 50, 3, 16

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(cuda_device)

    r, k, v = (t(rng.standard_normal((B, S, H, N))) for _ in range(3))
    log_w = t(-np.exp(rng.standard_normal((B, S, H, N))))
    u = t(rng.standard_normal((H, N)))
    s0 = t(rng.standard_normal((B, H, N, N)) * 0.1)
    ops.reset_launches()
    out, s = ops.wkv6(r, k, v, log_w, u, s0, chunk=32)
    assert ops.LAUNCHES["wkv6"] == 1
    want_out, want_s = ops.wkv6(r, k, v, log_w, u, s0, chunk=32,
                                backend="plain")
    torch.testing.assert_close(out, want_out, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s, want_s, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    args = _inputs(1, 2, 96, 16, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="chunk in"):
        ops.wkv6_rows(*args, chunk=48, backend="kernel")
    big = _inputs(1, 1, 64, 128, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head size"):
        ops.wkv6_rows(*big, chunk=64, backend="kernel")
    r, k, v, log_w, u, s = args
    with pytest.raises(TypeError, match="log_w must be float32"):
        ops.wkv6_rows(r, k, v, log_w.to(torch.bfloat16), u, s, chunk=32,
                      backend="kernel")
