"""The host-side plans of the port's CUDA kernels, checked on the CPU.

The kernels run only on the card, but how their work is cut is decided in
Python from shapes alone: the paged-attention kernel's split of each
sequence's positions over blocks (``paged_attention.ops.split_plan``), the
BitParticle decode GEMV's cut of K and of the columns
(``bitparticle_matmul.ops.gemv_plan``), its prefill tile kernel's tiles,
K split and ring (``bitparticle_matmul.ops.tile_plan``), and the chunked
WKV6 kernels' blocks, row split, shared memory and state workspace
(``wkv6.ops.wkv6_plan``).  These tests hold
each plan to what the kernel assumes: every position (page), output or K
byte is covered exactly once, slices start aligned, no grid is empty, and
the shared memory the plan implies fits.  The last test checks, in numpy,
the word-wise particle identities the kernel applies to its fragment
registers in approx mode.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.bp_matmul import signed_low_particles

from repro_torch.kernels.bitparticle_matmul import ops as bp_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops

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


# (M, K, N): the serves' prefill shapes (qwen2-1.5b at M 16-2048 including
# the paged serve's buckets, rwkv6-7b at its exact prompt lengths), the
# reference's ragged shapes and a few more ragged ones; M past the GEMV
TILE_SHAPES = [(m, k, n) for m in (9, 16, 17, 32, 64, 128, 256, 512, 1024,
                                   2048)
               for k, n in ((1536, 1536), (1536, 256), (1536, 8960),
                            (8960, 1536))]
TILE_SHAPES += [(m, k, n) for m in (64, 100, 128, 192, 256)
                for k, n in ((4096, 4096), (4096, 14336), (14336, 4096))]
TILE_SHAPES += [(16, 256, 384), (256, 256, 256), (300, 520, 260),
                (17, 520, 17), (100, 1000, 260), (2048, 520, 17),
                (9, 33, 17), (9, 1, 1), (257, 64, 8), (4096, 64, 65536),
                (33, 100000, 64)]


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("m,k,n", TILE_SHAPES)
def test_tile_plan_covers_the_product_once_within_its_ring(m, k, n, sms,
                                                           approx):
    bm, bn, split, kslice, stages = bp_ops.tile_plan(sms, m, n, k, approx)
    # a tile the plan's route is built for, no taller than M needs
    if approx:
        assert (bm, bn) in bp_ops.TILE_SHAPES_APPROX
    else:
        assert (bm, bn) in (bp_ops.TILE_SHAPES_MMA
                            + bp_ops.TILE_SHAPES_WGMMA)
    assert bm <= max(32, 1 << (m - 1).bit_length())
    # the output tiles cover M x N once: the grid's last tiles are the only
    # ragged ones
    m_tiles, n_tiles = -(-m // bm), -(-n // bn)
    assert (m_tiles - 1) * bm < m <= m_tiles * bm
    assert (n_tiles - 1) * bn < n <= n_tiles * bn
    # the K slices start on a ring stage and tile K exactly, none empty
    assert kslice % bp_ops.TILE_K == 0
    assert split * kslice >= k > (split - 1) * kslice
    covered = np.zeros(k, np.int32)
    for z in range(split):
        covered[z * kslice:min(k, (z + 1) * kslice)] += 1
    assert (covered == 1).all()
    # at most one cluster of slices per tile, and where the tiles leave SMs
    # idle no slice longer than the maximum, unless the cluster's limit
    # forces it
    assert 1 <= split <= bp_ops.TILE_MAX_SPLIT
    steps = -(-k // bp_ops.TILE_K)
    fill = bp_ops.TILE_SPLIT_FILL * sms
    if m_tiles * n_tiles < fill:
        assert kslice <= bp_ops.TILE_K * max(
            bp_ops.TILE_MAX_SLICE, -(-steps // bp_ops.TILE_MAX_SPLIT))
    # the ring fits the block's shared memory budget and keeps 3-6 stages
    assert bp_ops.TILE_MIN_STAGES <= stages <= bp_ops.TILE_MAX_STAGES
    assert stages * (bm + bn) * bp_ops.TILE_K <= bp_ops.TILE_SMEM
    # where the tiles leave SMs idle, a split brings the grid to within a
    # quarter of the planned blocks, as far as K's stages and one cluster
    # allow (the plan rounds to a power of two of slices, down)
    grid = m_tiles * n_tiles * split
    if m_tiles * n_tiles < fill:
        assert 4 * grid >= min(
            fill, m_tiles * n_tiles * min(steps, bp_ops.TILE_MAX_SPLIT))
    # and no split where the tiles alone fill it and K is not long
    if m_tiles * n_tiles >= fill:
        assert split == 1


@pytest.mark.parametrize("args", [(132, 8, 64, 64), (132, 1, 64, 64),
                                  (132, 0, 64, 64), (132, 64, 0, 64),
                                  (132, 64, 64, 0)])
def test_tile_plan_refuses_gemv_rows_and_empty_shapes(args):
    with pytest.raises(ValueError, match="no tile plan"):
        bp_ops.tile_plan(*args, False)


def test_tile_plan_splits_k_only_where_tiles_leave_sms_idle():
    # qwen2-1.5b's down projection (K 8960) at 256 rows: large tiles, K
    # split across a cluster, a power of two of slices
    bm, bn, split, _, _ = bp_ops.tile_plan(132, 256, 1536, 8960, False)
    assert split > 1 and split & (split - 1) == 0
    assert bp_ops.tile_uses_wgmma(bm, bn, False)
    # its gate/up at 2048 rows: 1120 wgmma tiles of 128 x 128, one slice
    bm, bn, split, _, _ = bp_ops.tile_plan(132, 2048, 8960, 1536, False)
    assert (bm, bn, split) == (128, 128, 1)


def test_tile_plan_routes_exact_and_approx():
    # exact mode: wgmma where its tiles fill the card, the small mma.sync
    # tiles for small shapes; approx mode always mma.sync
    big = bp_ops.tile_plan(132, 2048, 8960, 1536, False)
    small = bp_ops.tile_plan(132, 64, 1536, 1536, False)
    assert bp_ops.tile_uses_wgmma(big[0], big[1], False)
    assert not bp_ops.tile_uses_wgmma(small[0], small[1], False)
    for m, k, n in TILE_SHAPES:
        bm, bn = bp_ops.tile_plan(132, m, n, k, True)[:2]
        assert not bp_ops.tile_uses_wgmma(bm, bn, True)


# (R, T, N, chunk): the reference's kernel-test shapes, rwkv6-7b's serve
# prefills (64 heads x requests rows, N 64, chunk 64: one request of 64,
# 128, 256 and 4096 tokens, four of 256, one row alone) and the other chunk
# lengths at the model's head size
WKV_SHAPES = [(2, 64, 16, 16), (1, 32, 32, 32), (4, 128, 64, 64),
              (3, 96, 8, 32), (64, 64, 64, 64), (64, 128, 64, 64),
              (64, 256, 64, 64), (256, 256, 64, 64), (64, 4096, 64, 64),
              (1, 4096, 64, 64), (128, 128, 64, 64), (5, 48, 64, 16),
              (7, 64, 4, 32), (2, 16, 60, 16)]


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("R,T,N,chunk", WKV_SHAPES)
def test_wkv6_plan_covers_every_output_once_within_shared_memory(
        R, T, N, chunk, sms, esize):
    plan = wkv_ops.wkv6_plan(sms, R, T, N, chunk, esize)
    nc = T // chunk
    NP = -(-N // 16) * 16
    # the state kernel: grid (column blocks, rows), every block walking all
    # of its row's chunks; each (row, state column) carried by exactly one
    # block, none of them empty, within one block per SM where it splits
    cb = plan.col_blocks
    assert plan.state_grid == (cb, R) and plan.state_chunks_per_block == nc
    cols = NP // cb
    assert cb in (1, 2, 4) and cols * cb == NP and cols % 8 == 0
    owners = np.zeros((R, NP), np.int32)
    for x in range(cb):
        assert x * cols < N
        owners[:, x * cols:(x + 1) * cols] += 1
    assert (owners == 1).all()
    if cb > 1:
        assert R * cb <= sms
    # the chunk kernel: grid (chunks x split, rows), every block all N
    # value columns; its parts' 16-step row sub-chunks tile the chunk once
    x, y = plan.chunk_grid
    assert (x, y) == (nc * plan.row_split, R)
    assert plan.chunks_per_block == 1
    assert len(plan.sub_chunks) == plan.row_split
    covered = np.zeros((R, T, N), np.int32)
    for bx in range(x):
        ch, part = divmod(bx, plan.row_split)
        for ti in plan.sub_chunks[part]:
            lo = ch * chunk + 16 * ti
            covered[:, lo:lo + 16, :] += 1
    assert (covered == 1).all()
    # a split's halves do equal work: as many off-diagonal 16 x 16 pair
    # blocks (sum of ti) and A v steps (sum of ti + 1) each
    if plan.row_split == 2:
        assert chunk == 64 and R * nc <= sms
        assert {sum(p) for p in plan.sub_chunks} == {3}
    else:
        assert plan.sub_chunks == (tuple(range(chunk // 16)),)
    # both kernels' shared memory fits a block's 227 KB; at the serves'
    # shape (bf16, N 64, chunk 64) two chunk blocks share an SM, and where
    # the state chain is split over column blocks one chunk block fits
    # beside each of its blocks (the chunk kernel starts while it runs)
    assert 0 < plan.smem_state <= wkv_ops.SMEM_MAX
    assert 0 < plan.smem_chunk <= wkv_ops.SMEM_MAX
    if esize == 2 and N == chunk == 64:
        assert 2 * (plan.smem_chunk + 1024) <= 233472
        if cb > 1:
            assert plan.smem_state + plan.smem_chunk + 2048 <= 233472
    # the workspace is the float32 state in front of every chunk
    assert plan.workspace_bytes == R * nc * N * N * 4


def test_wkv6_plan_splits_only_where_chunks_leave_sms_idle():
    # the rwkv serve's most frequent call: 128 chunks on 132 SMs, split
    assert wkv_ops.wkv6_plan(132, 64, 128, 64, 64).row_split == 2
    # 256 and more chunks: one block per chunk
    assert wkv_ops.wkv6_plan(132, 64, 256, 64, 64).row_split == 1
    assert wkv_ops.wkv6_plan(132, 256, 256, 64, 64).row_split == 1
    # shorter chunks never split
    assert wkv_ops.wkv6_plan(132, 1, 32, 32, 32).row_split == 1


def test_wkv6_plan_splits_the_state_chain_over_idle_sms():
    # one 4096-step row: its chain over four blocks of 16 columns; the
    # serve's 64 rows over two; 256 rows fill the card unsplit
    assert wkv_ops.wkv6_plan(132, 1, 4096, 64, 64).col_blocks == 4
    assert wkv_ops.wkv6_plan(132, 64, 4096, 64, 64).col_blocks == 2
    assert wkv_ops.wkv6_plan(132, 256, 256, 64, 64).col_blocks == 1
    # no block without a column: N 8 pads to 16, whose second half is empty
    assert wkv_ops.wkv6_plan(132, 1, 64, 8, 64).col_blocks == 1


@pytest.mark.parametrize("args", [(132, 0, 64, 64, 64), (132, 4, 0, 64, 64),
                                  (132, 4, 64, 0, 64), (132, 4, 64, 68, 64),
                                  (132, 4, 64, 10, 64), (132, 4, 96, 64, 64),
                                  (132, 4, 64, 64, 48), (132, 4, 64, 64, 128),
                                  (132, 4, 64, 64, 8)])
def test_wkv6_plan_refuses_empty_shapes_and_unsupported_chunks(args):
    with pytest.raises(ValueError, match="no wkv6 plan"):
        wkv_ops.wkv6_plan(*args)


def _words(b):
    """Little-endian 32-bit words of 4 bytes each (as the kernel's
    fragment registers hold them)."""
    return b.astype(np.uint8).view(np.uint32)


def _bytes(w):
    return w.view(np.uint8).view(np.int8)


def _neg_lsb(w):
    return (w >> 7) & np.uint32(0x01010101)


def _rem(w, n1, mask):
    """bp_matmul.cu's rem16 (mask 15) and rem4 (mask 3): the truncated
    remainder sign(v) * (|v| & mask) of each byte lane."""
    m = np.uint32(mask * 0x01010101)
    r = w & m
    nz = ((r + m) >> (4 if mask == 15 else 2)) & n1
    return r + nz * np.uint32(0x100 - mask - 1)


def _vsub4(x, y):
    """__vsub4: per-byte x - y, modulo 256 in each lane."""
    d = x.view(np.uint8).astype(np.int16) - y.view(np.uint8).astype(np.int16)
    return (d & 0xFF).astype(np.uint8).view(np.uint32)


def test_fragment_particle_identities_match_the_plain_version():
    # every int8 value, -128 included, packed four to a word
    v = np.arange(-128, 128, dtype=np.int8)
    w = _words(v)
    n1 = _neg_lsb(w)
    r4, r16 = _rem(w, n1, 3), _rem(w, n1, 15)
    q0, q1, qlow4 = (t.numpy() for t in signed_low_particles(
        torch.from_numpy(v)))
    # W's particles: Wlow4 = rem16(w), W0 = rem4(w)
    np.testing.assert_array_equal(_bytes(r16).astype(np.int32), qlow4)
    np.testing.assert_array_equal(_bytes(r4).astype(np.int32), q0)
    # A's negated particles: -A0 = 0 - rem4(a), -4 A1 = rem4(a) - rem16(a)
    zero = np.zeros_like(w)
    np.testing.assert_array_equal(_bytes(_vsub4(zero, r4)).astype(np.int32),
                                  -q0)
    np.testing.assert_array_equal(_bytes(_vsub4(r4, r16)).astype(np.int32),
                                  -4 * q1)
    # so the kernel's three contractions sum to the plain version's approx
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, size=(8, 64)).astype(np.int8)
    b = rng.integers(-128, 128, size=(64, 8)).astype(np.int8)
    aw, bw = _words(a), _words(np.ascontiguousarray(b.T))
    an1, bn1 = _neg_lsb(aw), _neg_lsb(bw)
    ar4 = _rem(aw, an1, 3)
    p0 = _bytes(_vsub4(np.zeros_like(aw), ar4)).astype(np.int64)
    p1 = _bytes(_vsub4(ar4, _rem(aw, an1, 15))).astype(np.int64)
    wl = _bytes(_rem(bw, bn1, 15)).astype(np.int64)
    w0 = _bytes(_rem(bw, bn1, 3)).astype(np.int64)
    got = (a.astype(np.int64) @ b.astype(np.int64) + p0.reshape(8, 64)
           @ wl.reshape(8, 64).T + p1.reshape(8, 64) @ w0.reshape(8, 64).T)
    from repro_torch.kernels.bitparticle_matmul import ref
    want = ref.bp_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                             "bp_approx").numpy()
    np.testing.assert_array_equal(got, want)
