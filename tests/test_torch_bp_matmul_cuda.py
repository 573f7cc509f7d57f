"""The BitParticle matmul CUDA kernel against its plain version, on the card.

A CUDA kernel has no CPU or interpret mode, so these tests carry the
``cuda`` marker and skip where no GPU is present.  This file imports no JAX,
so that it also runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_bp_matmul_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.bitparticle_matmul import ops

SHAPES = [(8, 128, 128), (16, 256, 384), (256, 256, 256), (5, 33, 17),
          (1, 128, 1), (300, 520, 260)]


def _rand_q(rng, shape):
    return torch.from_numpy(
        rng.integers(-127, 128, size=shape).astype(np.int8))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# decode shapes (M up to the GEMV's 8 rows): qwen2-1.5b's FFN (K 8960),
# rwkv6-7b's projections and its lm_head
DECODE = [(m, k, n) for m in (1, 4, 8)
          for k, n in ((1536, 8960), (8960, 1536), (4096, 4096),
                       (4096, 14336), (14336, 4096), (4096, 65536))]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHAPES + DECODE)
def test_kernel_matches_plain_on_card(cuda_device, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = _rand_q(rng, (m, k)).to(cuda_device)
    w = ops.kmajor(_rand_q(rng, (k, n)).to(cuda_device))
    sa = torch.from_numpy(rng.uniform(0.01, 0.1, m).astype(
        np.float32)).to(cuda_device)
    sw = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(
        np.float32)).to(cuda_device)
    for approx in (False, True):
        ops.reset_launches()
        got_i = ops.bp_matmul(a, w, approx=approx)
        got_f = ops.bp_matmul(a, w, sa, sw, approx=approx)
        assert ops.LAUNCHES["bp_matmul"] == 2
        torch.cuda.synchronize()
        assert torch.equal(got_i, ops.bp_matmul(a, w, approx=approx,
                                                backend="plain"))
        assert torch.equal(got_f, ops.bp_matmul(a, w, sa, sw, approx=approx,
                                                backend="plain"))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 8960, 256), (8, 4096, 128)])
def test_misaligned_activations_take_unvectorised_loads(cuda_device, m, k,
                                                        n):
    # K a multiple of 16 but A one byte off 16-byte alignment: the kernel's
    # byte loads, raw and fused, exact and approx
    rng = np.random.default_rng(k + n)
    buf = torch.empty(m * k + 1, dtype=torch.int8, device=cuda_device)
    a = buf[1:].view(m, k).copy_(_rand_q(rng, (m, k)).to(cuda_device))
    assert a.data_ptr() % 16 != 0 and a.is_contiguous()
    w = ops.kmajor(_rand_q(rng, (k, n)).to(cuda_device))
    sa = torch.rand(m, device=cuda_device) + 0.01
    sw = torch.rand(n, device=cuda_device) * 0.01 + 1e-4
    for approx in (False, True):
        got_i = ops.bp_matmul(a, w, approx=approx, backend="kernel")
        got_f = ops.bp_matmul(a, w, sa, sw, approx=approx, backend="kernel")
        torch.cuda.synchronize()
        assert torch.equal(got_i, ops.bp_matmul(a, w, approx=approx,
                                                backend="plain"))
        assert torch.equal(got_f, ops.bp_matmul(a, w, sa, sw, approx=approx,
                                                backend="plain"))


@pytest.mark.cuda
def test_split_workspace_is_left_zero(cuda_device):
    # a plan that splits K across blocks (approx, 8 rows, K 14336) sums
    # through the workspace; the kernel must leave it zero, so a second
    # call and a call of another shape stay exact
    rng = np.random.default_rng(3)
    a = _rand_q(rng, (8, 14336)).to(cuda_device)
    w = ops.kmajor(_rand_q(rng, (14336, 512)).to(cuda_device))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert ops.gemv_plan(sms, 8, 512, 14336, True)[1] > 1
    want = ops.bp_matmul(a, w, approx=True, backend="plain")
    for _ in range(2):
        assert torch.equal(ops.bp_matmul(a, w, approx=True), want)
    ws, cnt = ops._WORKSPACE[a.device]
    torch.cuda.synchronize()
    assert int(ws.abs().sum()) == 0 and int(cnt.abs().sum()) == 0
