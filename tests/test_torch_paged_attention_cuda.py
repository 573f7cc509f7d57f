"""The paged-attention CUDA kernel against its plain version, on the card.

A CUDA kernel has no CPU or interpret mode, so these tests carry the
``cuda`` marker and skip where no GPU is present.  This file imports no JAX,
so that it also runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_attention_cuda.py

Tolerances: float32 pages within 1e-5 (the reference's own kernel test);
bfloat16 pages within one bf16 unit in the last place of each element (the
kernel and the plain version both compute in float32 and round once, in
another summation order).  The unit is taken at the element's magnitude,
but no smaller than at 2^-8: an output near zero is an average of O(1)
values that cancel, and there float32 summation order alone moves it by
more than a bf16 unit of its own tiny magnitude.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import ops

RAGGED = [
    # B, H, KH, D, n_blocks, bs, pages_per_seq, T_hi
    (1, 2, 1, 8, 6, 4, 4, 16),
    (3, 4, 2, 16, 12, 4, 5, 20),
    (5, 6, 3, 32, 20, 8, 3, 24),
    (2, 8, 8, 16, 10, 2, 7, 14),
    (4, 4, 1, 64, 16, 16, 2, 32),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, B, H, KH, D, n_blocks, bs, pps, T_hi, dtype, device):
    rng = np.random.default_rng(seed)
    q, kp, vp = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(device=device, dtype=dtype)
                 for s in ((B, H, D), (n_blocks, bs, KH, D),
                           (n_blocks, bs, KH, D)))
    bt = np.zeros((B, pps), np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        lengths[b] = rng.integers(0, T_hi)
        n_used = lengths[b] // bs + 1
        bt[b, :n_used] = rng.choice(np.arange(1, n_blocks), size=n_used,
                                    replace=False)
    return (q, kp, vp, torch.from_numpy(bt).to(device),
            torch.from_numpy(lengths).to(device))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at each element's magnitude (not
    below the unit at 2^-8)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -8)))
    return torch.pow(2.0, e - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,D,n_blocks,bs,pps,T_hi", RAGGED)
def test_kernel_matches_plain_float32(cuda_device, B, H, KH, D, n_blocks, bs,
                                      pps, T_hi):
    args = _case(B + H + D, B, H, KH, D, n_blocks, bs, pps, T_hi,
                 torch.float32, cuda_device)
    ops.reset_launches()
    got = ops.paged_attention(*args)
    assert ops.LAUNCHES["paged_attention"] == 1
    want = ops.paged_attention(*args, backend="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4, 32])
def test_kernel_matches_plain_qwen2_shape_bf16(cuda_device, B):
    # qwen2-1.5b: 12 query heads on 2 kv heads (G = 6), head dim 128
    H, KH, D, bs, pps = 12, 2, 128, 16, 20
    args = _case(B, B, H, KH, D, 4 * B * pps + 1, bs, pps, bs * pps,
                 torch.bfloat16, cuda_device)
    # every sequence on its own pages: a valid pool as the engine keeps it
    tables = torch.arange(1, B * pps + 1, device=cuda_device,
                          dtype=torch.int32).reshape(B, pps)
    args = args[:3] + (tables,) + args[4:]
    got = ops.paged_attention(*args, backend="kernel")
    want = ops.paged_attention(*args, backend="plain")
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert bool((err <= _bf16_ulp(want)).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("pps", [3, 80])   # 80 x 4 rows: split over blocks
def test_length_zero_all_trash_rows_are_finite(cuda_device, pps):
    q, kp, vp, _, _ = _case(31, 2, 2, 1, 8, 6, 4, 3, 10, torch.float32,
                            cuda_device)
    bt = torch.zeros(2, pps, dtype=torch.int32, device=cuda_device)
    lens = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    got = ops.paged_attention(q, kp, vp, bt, lens, backend="kernel")
    want = ops.paged_attention(q, kp, vp, bt, lens, backend="plain")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_int8_scale_pages_route_to_plain_and_are_counted(cuda_device):
    q, kp, vp, bt, lens = _case(5, 2, 4, 2, 16, 10, 4, 4, 14, torch.float32,
                                cuda_device)
    kq = (kp * 20).round().clamp(-127, 127).to(torch.int8)
    vq = (vp * 20).round().clamp(-127, 127).to(torch.int8)
    ks = torch.rand(10, 4, 2, device=cuda_device) + 0.01
    vs = torch.rand(10, 4, 2, device=cuda_device) + 0.01
    ops.reset_launches()
    got = ops.paged_attention(q, kq, vq, bt, lens, k_scale_pages=ks,
                              v_scale_pages=vs)
    assert ops.LAUNCHES["paged_attention"] == 0
    assert ops.ROUTED_PLAIN["int8_kv"] == 1
    want = ops.paged_attention(q, kq, vq, bt, lens, k_scale_pages=ks,
                               v_scale_pages=vs, backend="plain")
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="float pages only"):
        ops.paged_attention(q, kq, vq, bt, lens, k_scale_pages=ks,
                            v_scale_pages=vs, backend="kernel")


def _qwen_case(seed, B, G, lengths, dtype, device, pps, shared=False):
    """qwen2-1.5b's head dim and block size (D 128, bs 16) with G query
    rows per kv head on 2 kv heads; each sequence on its own pages, or all
    on the same pages (a shared prompt)."""
    rng = np.random.default_rng(seed)
    H, KH, D, bs = 2 * G, 2, 128, 16
    n_blocks = (1 if shared else B) * pps + 1
    q, kp, vp = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(device=device, dtype=dtype)
                 for s in ((B, H, D), (n_blocks, bs, KH, D),
                           (n_blocks, bs, KH, D)))
    ids = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
    tables = (np.tile(ids[:pps], (B, 1)) if shared
              else ids[:B * pps].reshape(B, pps))
    return (q, kp, vp, torch.from_numpy(np.ascontiguousarray(tables)).to(
        device), torch.tensor(lengths, dtype=torch.int32, device=device))


def _check(args, dtype):
    got = ops.paged_attention(*args, backend="kernel")
    want = ops.paged_attention(*args, backend="plain")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        err = (got.float() - want.float()).abs()
        assert bool((err <= _bf16_ulp(want)).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 6, 8, 12])
def test_query_rows_per_kv_head(cuda_device, G, dtype):
    # G > 8 is taken in two groups of G / 2 query rows
    pps = 24
    lengths = [383, 0, 200, 64]
    _check(_qwen_case(G, 4, G, lengths, dtype, cuda_device, pps), dtype)


@pytest.mark.cuda
def test_thirty_two_sequences_of_8192(cuda_device):
    args = _qwen_case(7, 32, 6, [8191] * 32, torch.bfloat16, cuda_device,
                      512)
    _check(args, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_lengths_either_side_of_a_stage_and_a_split(cuda_device, dtype):
    # a 512-page table: its split and the ring's stages both end inside
    # it; lengths just before, at and after those ends
    pps = 512
    n_split, rps = ops.split_plan(
        torch.cuda.get_device_properties(cuda_device).multi_processor_count,
        8 * 2, pps * 16, 16)
    stage = ops.STAGE_ROWS
    edges = [stage - 2, stage - 1, stage, stage + 1, rps - 2, rps - 1, rps,
             rps + 1]
    _check(_qwen_case(11, len(edges), 6, edges, dtype, cuda_device, pps),
           dtype)


@pytest.mark.cuda
def test_pages_shared_across_sequences(cuda_device):
    # one page run in every table, as the paged serve's shared prompt
    args = _qwen_case(13, 6, 6, [0, 5, 100, 256, 300, 383], torch.bfloat16,
                      cuda_device, 24, shared=True)
    _check(args, torch.bfloat16)


@pytest.mark.cuda
def test_split_counters_are_left_zero(cuda_device):
    args = _qwen_case(17, 4, 6, [8191] * 4, torch.bfloat16, cuda_device, 512)
    for _ in range(2):
        _check(args, torch.bfloat16)
    cnt = ops._COUNTERS[args[0].device]
    assert int(cnt.abs().sum()) == 0
