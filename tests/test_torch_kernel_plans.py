"""The host-side plans of the port's CUDA kernels, checked on the CPU.

The kernels run only on the card, but how their work is cut is decided in
Python from shapes alone: the paged-attention kernel's split of each
sequence's positions over blocks (``paged_attention.ops.split_plan``) and
the BitParticle decode GEMV's cut of K and of the columns
(``bitparticle_matmul.ops.gemv_plan``).  These tests hold each plan to what
the kernel assumes: every position (page) or K byte is covered exactly
once, slices start 16-byte aligned, no grid is empty, and the shared
memory the plan implies fits.
"""

import pytest

from repro_torch.kernels.bitparticle_matmul import ops as bp_ops
from repro_torch.kernels.paged_attention import ops as pa_ops

# (SMs, walks = B x KH x query groups, table rows = pages x block size, block
# size): the H100's 132 SMs at the serves' and the sweep's shapes, the
# reference tests' ragged tables, and a card with fewer SMs
SPLIT_CASES = [
    (132, 64, 8192, 16), (132, 8, 8192, 16), (132, 8, 384, 16),
    (132, 8, 128, 16), (132, 64, 128, 16), (132, 8, 512, 16),
    (132, 64, 2048, 16), (132, 1, 131072, 16), (132, 1, 32768, 1),
    (132, 1, 16, 4), (132, 3, 20, 4), (132, 5, 24, 8), (132, 16, 14, 2),
    (132, 4, 32, 16), (8, 2, 1000, 3), (1, 1, 4096, 16),
]


@pytest.mark.parametrize("sms,walks,rows,bs", SPLIT_CASES)
def test_split_plan_covers_every_page_once(sms, walks, rows, bs):
    n_split, rps = pa_ops.split_plan(sms, walks, rows, bs)
    assert 1 <= n_split <= pa_ops.MAX_SPLITS
    assert rps % pa_ops.STAGE_ROWS == 0
    # the splits' position runs tile [0, rows) with none empty
    runs = [(z * rps, min((z + 1) * rps, rows)) for z in range(n_split)]
    assert all(lo < hi for lo, hi in runs)
    covered = [0] * rows
    for lo, hi in runs:
        for t in range(lo, hi):
            covered[t] += 1
    assert covered == [1] * rows
    # so every page of a full table is read by exactly one split (a page
    # can straddle two splits only where rps is not a multiple of bs, and
    # then each split reads its own rows of it)
    pages = -(-rows // bs)
    owners = [set() for _ in range(pages)]
    for z, (lo, hi) in enumerate(runs):
        for t in range(lo, hi):
            owners[t // bs].add(z)
    assert all(owners)
    if rps % bs == 0:
        assert all(len(o) == 1 for o in owners)
    # the table entries a split copies to shared memory fit its budget
    assert -(-rps // bs) + 1 <= pa_ops.MAX_SPLIT_PAGES


def test_split_plan_prefers_one_block_for_short_tables():
    # a serve's short tables: one split when it is as fast, so no merge
    assert pa_ops.split_plan(132, 8, 128, 16) == (1, 128)


@pytest.mark.parametrize("args", [(132, 0, 64, 16), (132, 4, 0, 16),
                                  (132, 4, 64, 0)])
def test_split_plan_refuses_empty_shapes(args):
    with pytest.raises(ValueError, match="no split plan"):
        pa_ops.split_plan(*args)


# (M, K, N): qwen2-1.5b's and rwkv6-7b's decode projections, the lm_head,
# and ragged and tiny shapes; M up to the GEMV's 8 rows
GEMV_SHAPES = [(m, k, n) for m in (1, 4, 8)
               for k, n in ((1536, 1536), (1536, 256), (1536, 8960),
                            (8960, 1536), (4096, 4096), (4096, 14336),
                            (14336, 4096), (4096, 65536))]
GEMV_SHAPES += [(5, 33, 17), (1, 128, 1), (3, 40, 9), (8, 128, 128),
                (2, 8960, 33), (7, 100000, 64)]


def _kernel_parts(length: int, wk: int):
    """The kernel's cut of a slice of ``length`` bytes into wk parts
    (bp_matmul.cu: kw = roundup16(ceil(length / wk)))."""
    kw = (-(-length // wk) + 15) // 16 * 16
    return [(p * kw, min(length, (p + 1) * kw)) for p in range(wk)]


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("m,k,n", GEMV_SHAPES)
def test_gemv_plan_tiles_k_exactly_and_aligned(m, k, n, approx):
    wk, split, kslice, n_blocks = bp_ops.gemv_plan(132, m, n, k, approx)
    assert wk in (1, 2, 4, 8)
    assert kslice % 16 == 0
    # the slices tile K exactly: split * kslice >= k > (split - 1) * kslice
    assert split * kslice >= k > (split - 1) * kslice
    starts = [y * kslice for y in range(split)]
    assert all(s % 16 == 0 for s in starts)   # 16-byte aligned when vec
    for y in range(split):
        length = min(k, (y + 1) * kslice) - y * kslice
        parts = _kernel_parts(length, wk)
        # the warps' parts of a slice start 16-byte aligned and cover it
        covered = 0
        for lo, hi in parts:
            assert lo % 16 == 0
            covered += max(0, hi - lo)
        assert covered == length
    # the staged slice of A (three copies in approx mode) fits its budget
    mp = 4 if m <= 4 else 8     # the kernel's row counts
    assert mp * kslice * (3 if approx else 1) <= bp_ops.GEMV_SMEM_A
    # a non-empty grid of at most the resident blocks, each with a tile
    tiles = -(-n // (bp_ops.GEMV_WARP_COLS * (bp_ops.GEMV_WARPS // wk)))
    assert 1 <= n_blocks <= tiles
    assert n_blocks * split <= max(split, bp_ops.GEMV_BLOCKS_PER_SM * 132)


def test_gemv_plan_splits_k_only_for_shared_memory():
    # rwkv6-7b's value projection in approx mode at 8 rows: three copies of
    # 8 x 14336 bytes of A outgrow a block's budget, so K is split
    wk, split, kslice, _ = bp_ops.gemv_plan(132, 8, 4096, 14336, True)
    assert split > 1
    # the same shape in exact mode at 4 rows keeps K whole
    assert bp_ops.gemv_plan(132, 4, 4096, 14336, False)[1] == 1


@pytest.mark.parametrize("m", [0, 9])
def test_gemv_plan_refuses_rows_outside_the_gemv(m):
    with pytest.raises(ValueError, match="no GEMV plan"):
        bp_ops.gemv_plan(132, m, 64, 64, False)
