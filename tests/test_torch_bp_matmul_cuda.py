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


# prefill shapes (M > 8: the tensor-core tile kernel): every row count the
# serves give it, from a 9-row group to a 2048-row paged prefill, on
# qwen2-1.5b's and rwkv6-7b's projections
PREFILL_KN = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536),
              (4096, 4096), (4096, 14336), (14336, 4096))
PREFILL = [(m, k, n) for m in (9, 16, 17, 64, 100, 256, 512, 2048)
           for k, n in PREFILL_KN]
# ragged prefill shapes: K not a multiple of 16 (byte loads; the last on
# the wgmma route), N 17 and 260
RAGGED_PREFILL = [(17, 520, 17), (100, 1000, 260), (64, 1536, 17),
                  (9, 4096, 260), (300, 8960, 260), (2048, 520, 17),
                  (512, 1000, 8960)]


def _dev_q(gen, shape, device, low=-127):
    return torch.randint(low, 128, shape, generator=gen, device=device,
                         dtype=torch.int32).to(torch.int8)


def _check_on_card(a, w, device, gen):
    m, n = a.shape[0], w.shape[1]
    sa = torch.rand(m, generator=gen, device=device) * 0.1 + 1e-3
    sw = torch.rand(n, generator=gen, device=device) * 0.01 + 1e-4
    for approx in (False, True):
        ops.reset_launches()
        got_i = ops.bp_matmul(a, w, approx=approx)
        got_f = ops.bp_matmul(a, w, sa, sw, approx=approx)
        assert ops.LAUNCHES["bp_matmul"] == 2
        assert ops.LAUNCHES["tile" if m > ops.GEMV_MAX_M else "gemv"] == 2
        torch.cuda.synchronize()
        assert torch.equal(got_i, ops.bp_matmul(a, w, approx=approx,
                                                backend="plain"))
        assert torch.equal(got_f, ops.bp_matmul(a, w, sa, sw, approx=approx,
                                                backend="plain"))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", PREFILL + RAGGED_PREFILL)
def test_prefill_tile_matches_plain_on_card(cuda_device, m, k, n):
    gen = torch.Generator(device=cuda_device).manual_seed(m * 7 + k + n)
    a = _dev_q(gen, (m, k), cuda_device)
    w = ops.kmajor(_dev_q(gen, (k, n), cuda_device))
    _check_on_card(a, w, cuda_device, gen)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(64, 1536, 256), (300, 520, 260),
                                   (5, 4096, 512)])
def test_full_int8_range_including_minus_128(cuda_device, m, k, n):
    # the raw API takes any int8: -128 has no particles (rem4 = rem16 = 0,
    # as the plain version's |v| & 15 of 128)
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    a = _dev_q(gen, (m, k), cuda_device, low=-128)
    w = _dev_q(gen, (k, n), cuda_device, low=-128)
    a[0] = -128
    w[:, 0] = -128
    assert int((a == -128).sum()) > k and int((w == -128).sum()) > k
    _check_on_card(a, ops.kmajor(w), cuda_device, gen)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 8960, 256), (8, 4096, 128),
                                   (64, 4096, 512), (300, 1536, 264),
                                   (256, 4096, 4096)])
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


# (approx, M, K, N) whose tile plans split K across a cluster of blocks:
# qwen2-1.5b's down projection at 64 rows (mma.sync tiles), rwkv6-7b's
# value projection at 256 rows (wgmma tiles, K longer than a slice may
# be), and a narrow approx case whose tiles leave most SMs idle
TILE_SPLITS = [(False, 64, 8960, 1536), (True, 64, 8960, 1536),
               (False, 256, 14336, 4096), (True, 128, 8960, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("approx,m,k,n", TILE_SPLITS)
def test_tile_split_k_sums_exactly_across_the_cluster(cuda_device, approx, m,
                                                      k, n):
    # the slices' partial tiles meet in the cluster's shared memory: the
    # sums are exact, again on a second call and on a ragged neighbour
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert ops.tile_plan(sms, m, n, k, approx)[2] > 1
    for mm, kk, nn in ((m, k, n), (m + 1, k - 16, n - 3)):
        a = _dev_q(gen, (mm, kk), cuda_device)
        w = ops.kmajor(_dev_q(gen, (kk, nn), cuda_device))
        sa = torch.rand(mm, generator=gen, device=cuda_device) + 0.01
        sw = torch.rand(nn, generator=gen, device=cuda_device) * 0.01
        want_i = ops.bp_matmul(a, w, approx=approx, backend="plain")
        want_f = ops.bp_matmul(a, w, sa, sw, approx=approx, backend="plain")
        for _ in range(2):
            assert torch.equal(ops.bp_matmul(a, w, approx=approx), want_i)
            assert torch.equal(ops.bp_matmul(a, w, sa, sw, approx=approx),
                               want_f)
