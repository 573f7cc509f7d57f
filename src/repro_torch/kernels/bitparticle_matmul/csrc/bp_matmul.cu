// BitParticle W8A8 matmul for Hopper (sm_90a): int8 x int8 -> int32, exact
// or approximate, with the dequant epilogue fused.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/bitparticle_matmul/kernel.py::bp_matmul_kernel
// (body ``_kernel``, particles ``_signed_particles`` /
// ``_signed_particles_shift2``).  What it computes:
//
//   exact:  acc = A @ W
//   approx: acc = A @ W - A0 @ Wlow4 - 4 * (A1 @ W0)
//           A0 = s(|A| & 3), A1 = s((|A| >> 2) & 3),
//           W0 = s(|W| & 3), Wlow4 = s(|W| & 15)      (s = sign)
//   fused epilogue: out = float(acc) * (sa[m] * sw[n])   (float32)
//   raw:            out = acc                            (int32)
//
// The epilogue multiplies the two scales first and the accumulator second,
// the order of the reference's plain path (core/bp_matmul.py), so the kernel
// and the plain PyTorch version agree bit for bit.
//
// Layout.  A is (M, K) row-major.  The weight is passed K-major: ``wt`` is
// (N, K) row-major, i.e. the (K, N) weight stored column by column.  The
// serving engine makes that copy once, when it quantizes the weights, so
// four consecutive K values of one output column are one aligned 32-bit
// word and both operands pack straight into ``__dp4a``.  (The TPU kernel
// keeps W as (K, N) because its MXU takes either layout.)
//
// Decode (M = number of slots, at most 8): ``bp_gemv_kernel``.
//   * What bounds it: every weight byte is read once and used M times, so a
//     call is bound by the weight bytes over HBM (14 MB, ~4.1 us, for
//     qwen2-1.5b's 1536 x 8960 FFN weights; 59 MB, ~17.5 us, for rwkv6-7b's
//     4096 x 14336; 268 MB, ~80 us, for its lm_head).  The work is to keep
//     enough weight bytes in flight on every SM, with the int8 dot products
//     (three per word in approx mode) hidden under the loads.
//   * Work layout.  A warp owns 4 output columns; the 8 warps of a block
//     are 8 / wk column groups x wk parts of K (wk = 1, 2, 4 or 8), so a
//     column tile is 32 / wk columns.  The host plans it (``ops.gemv_plan``)
//     from the shapes: the fewest K parts that still give most of the
//     resident warps work, because every part costs a reduction.  The
//     wk parts of a column group meet in shared memory.
//   * Persistent blocks.  At most the resident number of blocks (two per
//     SM) is launched; each stages A once and walks column tiles x, x +
//     n_blocks, ..., so no second wave of short blocks pays the launch and
//     the staging again, and the next tile's weight loads are in flight
//     while the last tile's sums are reduced.
//   * Split K across blocks only where the staged slice of A (three copies
//     in approx mode) outgrows shared memory: the slices' sums meet by
//     int32 ``atomicAdd`` in a zeroed workspace, and the last slice to
//     arrive at a tile (an int32 arrival counter) takes them with
//     ``atomicExch(.., 0)``, runs the epilogue once and resets the counter,
//     so the workspace is zero again for the next call and no memset is
//     launched.  int32 sums are exact in any order: the result is bit-exact
//     whatever the plan.
//   * Loads in flight: each lane loads one iteration ahead: two 512-byte
//     warp steps of its 4 columns (8 independent 16-byte loads) in exact
//     mode, one step (4 loads) in approx mode, whose particles take the
//     registers of the second.
//   * A is staged once per block with 16-byte loads: only its live rows and
//     only the block's K slice; rows up to 4 or 8 are zero, so the row
//     count is a compile-time constant of the kernel.
//   * The within-warp sum of the 4 x M accumulators is a reduce-scatter
//     (31 shuffles for 32 sums, not 5 per sum).
//   * Approx mode forms particles four lanes at a time, in 32-bit words
//     (``rem4``/``rem16``: the truncated remainders w % 4 = s(|w| & 3) and
//     w % 16 = s(|w| & 15), with masks and one multiply, no per-byte loop).
//     A's particles are staged negated (-A0, -4 A1, both fit int8), so the
//     three contractions share one int32 accumulator; each weight word's
//     particles are formed once and used by all M rows.
//
// Prefill (M > 8: batch x padded prompt, up to thousands of rows): two
// tile kernels on the int8 tensor cores, one ring.
//   * What bounds it: at the serves' shapes (M 16-2048, K and N 256-14336)
//     the call is bound by the weight bytes (and the float32 output) over
//     HBM up to M ~ 256-512, and beyond it, or in approx mode (three
//     contractions), by the int8 MMA rate.  The work: stream the operands
//     with the whole card busy, the int8 products on the tensor cores under
//     the loads.
//   * The ring: a BM x BN output tile per block of 8 warps, K in 128-byte
//     stages through a ring of 3-6 stages filled by 16-byte ``cp.async.cg``
//     copies (zero-filled past M, N and K), one commit and one block
//     barrier per stage.  Each thread's source rows and ring offsets are
//     fixed for the whole K slice.  Rows are 128 bytes with their 16-byte
//     chunks XOR (row % 8): the hardware's 128-byte swizzle, which ``wgmma``
//     descriptors read as it is, and in which the 8 rows one ``ldmatrix``
//     phase reads at one chunk lie in 8 distinct bank groups.  A is
//     row-major and the weight K-major, so both are "K contiguous", as
//     both MMAs want.
//   * ``bp_wgmma_kernel`` (exact mode, tiles 64 x 64 up to 128 x 128): each
//     of the two warpgroups issues ``wgmma.mma_async m64nNk32.s32.s8.s8``
//     on its half of the tile straight from the ring (no ldmatrix, the
//     accumulators in registers), four per stage.
//   * ``bp_tile_kernel`` (``mma.sync.m16n8k32.s32.s8.s8``, fragments by
//     ``ldmatrix``): exact mode's 32-row tiles, which give small shapes
//     more blocks, and approx mode on every tile.  Approx
//     particles come from the fragment registers: ``rem4``/``rem16`` on each
//     32-bit word gives -A0 and -4 A1 from A's fragment and Wlow4 and W0
//     from W's, so approx is the same pipeline with three MMAs per step
//     into one int32 accumulator.
//   * The host plans both (``ops.tile_plan``): the tile from the shape (the
//     largest whose grid still reaches most SMs), and a split of K across
//     blocks where the tiles leave SMs idle or K is long.  The K slices of
//     one output tile run as a thread block cluster (at most 8 blocks):
//     each block leaves its int32 partial tile in its own shared memory,
//     and each sums a share of the tile's rows over the cluster through
//     distributed shared memory and stores them, 16 bytes per thread.  No
//     atomics, no workspace; bit-exact under any plan.
//   * Where 16-byte copies cannot serve (K % 16 != 0 or an operand off
//     16-byte alignment: ``vec`` == 0) the same ring is filled by byte loads
//     (zero past K), a route chosen by shape, not a fallback.
//
// All sums are exact int32 (|acc| <= 127^2 * K < 2^31 for K < 133,000).
// Ragged M, N and K are masked inside the kernels (no host padding).
//
// Interface: plain C, loaded with ctypes: ``bp_matmul_launch`` (the GEMV)
// and ``bp_tile_launch`` (the tiles) return cudaGetLastError() after the
// launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// particles of 4 packed signed int8 lanes
// ---------------------------------------------------------------------------

// SIMD-in-a-word particles.  For a signed byte v, s(|v| & 15) is the
// truncated remainder v % 16: the floored remainder v & 15, less 16 where v
// is negative and v & 15 is not 0 (and s(|v| & 3) likewise with 4).  v =
// -128 gives 0, as the plain version's |v| & 15 = 128 & 15 does.  No step
// carries across a byte: r + 15 <= 30, and the masked products are 0 or
// 0xf0 / 0xfc added to r <= 15.

// 0x01 in each byte whose sign bit is set
__device__ __forceinline__ unsigned neg_lsb(unsigned w) {
  return (w >> 7) & 0x01010101u;
}

// s(|v| & 15) per byte; ``n1`` = neg_lsb(w)
__device__ __forceinline__ unsigned rem16(unsigned w, unsigned n1) {
  const unsigned r = w & 0x0f0f0f0fu;
  const unsigned nz = ((r + 0x0f0f0f0fu) >> 4) & n1;
  return r + nz * 0xf0u;
}

// s(|v| & 3) per byte; ``n1`` = neg_lsb(w)
__device__ __forceinline__ unsigned rem4(unsigned w, unsigned n1) {
  const unsigned r = w & 0x03030303u;
  const unsigned nz = ((r + 0x03030303u) >> 2) & n1;
  return r + nz * 0xfcu;
}

// Four bytes of a row starting at byte ``k`` (zero past ``K``).  VEC: the row
// start and k are 4-byte aligned and K % 4 == 0, so one 32-bit load suffices.
template <bool VEC>
__device__ __forceinline__ int load_word(const int8_t* __restrict__ row, int k,
                                         int K) {
  if (VEC) {
    return k < K ? *reinterpret_cast<const int*>(row + k) : 0;
  }
  unsigned r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (k + i < K) r |= ((unsigned)(uint8_t)row[k + i]) << (8 * i);
  }
  return (int)r;
}

template <bool FUSE>
__device__ __forceinline__ void store_out(void* out, long idx, int acc,
                                          float sa, float sw) {
  if (FUSE) {
    float s = __fmul_rn(sa, sw);
    reinterpret_cast<float*>(out)[idx] = __fmul_rn(__int2float_rn(acc), s);
  } else {
    reinterpret_cast<int*>(out)[idx] = acc;
  }
}

// ---------------------------------------------------------------------------
// decode: M <= 8 rows, split-K GEMV
// ---------------------------------------------------------------------------

constexpr int kGemvMaxM = 8;
constexpr int kGemvWarps = kThreads / 32;
constexpr int kGemvCols = 4;         // columns per warp
constexpr int kGemvStep = 32 * 16;   // K bytes a warp reads per column per step
// shared memory for a block's slice of A (and its particles); the host's
// plan keeps the slice within it
constexpr int kGemvSmemA = 108 * 1024;

// Sixteen bytes of a K-major weight row from byte ``k`` (zero past ``len``).
template <bool VEC>
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ row, int k,
                                       int len) {
  if (VEC) return __ldg(reinterpret_cast<const int4*>(row + k));
  return make_int4(load_word<false>(row, k, len),
                   load_word<false>(row, k + 4, len),
                   load_word<false>(row, k + 8, len),
                   load_word<false>(row, k + 12, len));
}

// Reduce-scatter of NV per-lane int32 values over the 32 lanes: each round
// (lane offset O, 16 down to 1) a lane keeps one half of its values and
// sends the other half to its partner, while more than one value is left;
// then the last value is summed over the remaining offsets.  On return v[0]
// holds, for value index ``idx``, the sum over all 32 lanes; lanes that
// differ only in the bits of the plain rounds hold the same value.
template <int NV, int O>
struct LaneReduce {
  __device__ __forceinline__ static void run(int* v, int lane, int& idx) {
    if constexpr (O == 0) {
      return;
    } else if constexpr (NV > 1) {
      constexpr int H = NV / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const int send = up ? v[i] : v[i + H];
        const int keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (up) idx += H;
      LaneReduce<H, O / 2>::run(v, lane, idx);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      LaneReduce<1, O / 2>::run(v, lane, idx);
    }
  }
};

__device__ __forceinline__ void store_any(void* out, int m, int n, int N,
                                          int acc, int fuse,
                                          const float* __restrict__ sa,
                                          const float* __restrict__ sw) {
  if (fuse)
    store_out<true>(out, (long)m * N + n, acc, sa[m], sw[n]);
  else
    store_out<false>(out, (long)m * N + n, acc, 1.f, 1.f);
}

// grid (n_blocks, split); kThreads threads; dynamic shared memory MP x
// roundup(kslice, 16) bytes (three times that in approx mode).  Block (x, y)
// stages A's slice y (K bytes [y kslice, (y + 1) kslice)) once.  The
// slice's work is cut into units: column group g (4 columns) x part p < wk
// of the slice (kw bytes, a multiple of 16).  The n_blocks x 8 warps of a
// slice take units round robin and walk them back to back, the next
// weight words in flight across units; no block barrier follows the
// staging.  Where a column group has more than one part (wk x split > 1),
// the parts meet in ``ws`` by int32 atomicAdd and the last part to arrive
// (per-group counter ``cnt``) takes the sum with atomicExch(.., 0), runs
// the epilogue and resets the counter: ``ws`` (M x N int32) and ``cnt``
// (ceil(N / 4) int32) are zero on entry and zero again on exit.
// grid (n_blocks, split); kThreads threads; dynamic shared memory MP x
// roundup(kslice, 16) bytes (three times that in approx mode).  The 8 warps
// are 8 / wk column groups of 4 columns x wk parts of the K slice, so a
// column tile is 4 * 8 / wk columns.  Block (x, y) stages A's slice y (K
// bytes [y kslice, (y + 1) kslice)) once, then walks column tiles x, x +
// n_blocks, ..., keeping the next weight words in flight across tiles.
// With split > 1, ``ws`` (M x N int32) and ``cnt`` (one int32 per column
// tile) must be zero on entry; they are zero again on exit.
template <int MP, bool APPROX, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
bp_gemv_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ wt,
               const float* __restrict__ sa, const float* __restrict__ sw,
               void* __restrict__ out, int* __restrict__ ws,
               int* __restrict__ cnt, int M, int N, int K, int kslice, int wk,
               int fuse) {
  // steps of kGemvStep bytes per loop iteration: two in exact mode; one in
  // approx mode, whose particles take the registers of the second
  constexpr int kSteps = APPROX ? 1 : 2;
  constexpr int kIter = kSteps * kGemvStep;
  extern __shared__ __align__(16) int8_t gemv_smem[];
  __shared__ int red[kGemvWarps][kGemvCols * kGemvMaxM];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = gridDim.y;
  const int k_lo = blockIdx.y * kslice;
  const int len = min(K, k_lo + kslice) - k_lo;
  const int ls = (kslice + 15) & ~15;   // row stride of the staged slice
  int8_t* a_s = gemv_smem;              // (MP, ls) A
  int8_t* a0_s = a_s + MP * ls;         // (MP, ls) -A0     (approx)
  int8_t* a1_s = a0_s + MP * ls;        // (MP, ls) -4 A1   (approx)

  // this warp's 4 columns of a tile and its part [kb, ke) of the slice
  const int n_tile = kGemvCols * (kGemvWarps / wk);
  const int n_tiles = (N + n_tile - 1) / n_tile;
  const int col0 = (warp / wk) * kGemvCols;
  const int kw = ((len + wk - 1) / wk + 15) & ~15;
  const int kb = (warp % wk) * kw, ke = min(len, kb + kw);
  // iterations per tile, the same for every warp of the block
  const int iters = max(1, (kw + kIter - 1) / kIter);
  const int bx = blockIdx.x;
  const int my_tiles =
      bx < n_tiles ? (n_tiles - bx + gridDim.x - 1) / gridDim.x : 0;
  const int total = my_tiles * iters;

  // kSteps steps of this lane's weight words for flat iteration ``it``
  // (tile it / iters, K offset kb + (it % iters) * kIter)
  auto load_iter = [&](int4 (&wv)[kSteps][kGemvCols], int it) {
    const int tile = blockIdx.x + (it / iters) * gridDim.x;
    const int k = kb + lane * 16 + (it % iters) * kIter;
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) {
      const int n = tile * n_tile + col0 + c;
      const int8_t* row = wt + (long)(n < N ? n : 0) * K + k_lo;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int ku = k + u * kGemvStep;
        wv[u][c] = (it < total && n < N && ku < ke)
                       ? load16<VEC>(row, ku, ke)
                       : make_int4(0, 0, 0, 0);
      }
    }
  };
  // the first weight words are in flight while A is staged
  int4 cur[kSteps][kGemvCols];
  load_iter(cur, 0);

  // stage A's live rows over this slice (zero past K and in rows >= M)
  const int cw = ls / 16;
  for (int i = tid; i < MP * cw; i += kThreads) {
    const int m = i / cw, k = (i - m * cw) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (m < M && k < len) v = load16<VEC>(a + (long)m * K + k_lo, k, len);
    *reinterpret_cast<int4*>(a_s + m * ls + k) = v;
    if (APPROX) {
      const unsigned w[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z,
                             (unsigned)v.w};
      unsigned p0[4], p1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned n1 = neg_lsb(w[j]);
        const unsigned r4 = rem4(w[j], n1);
        p0[j] = __vsub4(0u, r4);               // -A0
        p1[j] = __vsub4(r4, rem16(w[j], n1));  // A0 - Alow4 = -4 A1
      }
      *reinterpret_cast<int4*>(a0_s + m * ls + k) =
          make_int4(p0[0], p0[1], p0[2], p0[3]);
      *reinterpret_cast<int4*>(a1_s + m * ls + k) =
          make_int4(p1[0], p1[1], p1[2], p1[3]);
    }
  }
  __syncthreads();

  // the epilogue needs the block when warps share a column group or K is
  // split across blocks; otherwise each warp stores its own columns
  const bool block_epilogue = wk > 1 || split > 1;
  int acc[kGemvCols][MP];
#pragma unroll
  for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
    for (int m = 0; m < MP; ++m) acc[c][m] = 0;

  for (int it = 0; it < total; ++it) {
    // the next iteration's weight words load while this one computes
    int4 nxt[kSteps][kGemvCols];
    load_iter(nxt, it + 1);
    const int k = kb + lane * 16 + (it % iters) * kIter;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int ku = k + u * kGemvStep;
      if (ku >= ke) continue;
      int w[kGemvCols][4], wl[kGemvCols][4], w0[kGemvCols][4];
#pragma unroll
      for (int c = 0; c < kGemvCols; ++c) {
        w[c][0] = cur[u][c].x; w[c][1] = cur[u][c].y;
        w[c][2] = cur[u][c].z; w[c][3] = cur[u][c].w;
        if (APPROX) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const unsigned n1 = neg_lsb((unsigned)w[c][j]);
            wl[c][j] = (int)rem16((unsigned)w[c][j], n1);   // Wlow4
            w0[c][j] = (int)rem4((unsigned)w[c][j], n1);    // W0
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MP; ++m) {
        const int4 av = *reinterpret_cast<const int4*>(a_s + m * ls + ku);
        const int aw[4] = {av.x, av.y, av.z, av.w};
        int a0w[4], a1w[4];
        if (APPROX) {
          const int4 p0 = *reinterpret_cast<const int4*>(a0_s + m * ls + ku);
          const int4 p1 = *reinterpret_cast<const int4*>(a1_s + m * ls + ku);
          a0w[0] = p0.x; a0w[1] = p0.y; a0w[2] = p0.z; a0w[3] = p0.w;
          a1w[0] = p1.x; a1w[1] = p1.y; a1w[2] = p1.z; a1w[3] = p1.w;
        }
#pragma unroll
        for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[c][m] = __dp4a(aw[j], w[c][j], acc[c][m]);
            if (APPROX) {
              acc[c][m] = __dp4a(a0w[j], wl[c][j], acc[c][m]);
              acc[c][m] = __dp4a(a1w[j], w0[c][j], acc[c][m]);
            }
          }
      }
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
#pragma unroll
      for (int c = 0; c < kGemvCols; ++c) cur[u][c] = nxt[u][c];
    if (it % iters != iters - 1) continue;

    // the tile is done: sum the lanes (lane l ends with value index c * MP
    // + m), then, where warps share a column group, their parts through
    // shared memory
    const int tile = blockIdx.x + (it / iters) * gridDim.x;
    const int n0 = tile * n_tile;
    constexpr int NV = kGemvCols * MP;
    int v[NV];
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
      for (int m = 0; m < MP; ++m) {
        v[c * MP + m] = acc[c][m];
        acc[c][m] = 0;
      }
    int idx = 0;
    LaneReduce<NV, 16>::run(v, lane, idx);
    const bool writer = (lane & (32 / NV - 1)) == 0;
    if (!block_epilogue) {
      const int m = idx % MP, n = n0 + col0 + idx / MP;
      if (writer && m < M && n < N) store_any(out, m, n, N, v[0], fuse, sa, sw);
      continue;
    }
    if (writer) red[warp][idx] = v[0];
    __syncthreads();
    for (int i = tid; i < n_tile * M; i += kThreads) {
      const int m = i / n_tile, j = i - m * n_tile, n = n0 + j;
      if (n >= N) continue;
      const int g = j / kGemvCols, c = j - g * kGemvCols;
      int sum = 0;
      for (int w = 0; w < wk; ++w) sum += red[g * wk + w][c * MP + m];
      if (split == 1)
        store_any(out, m, n, N, sum, fuse, sa, sw);
      else
        atomicAdd(&ws[(long)m * N + n], sum);
    }
    if (split > 1) {
      // the last slice to finish this tile takes the sums and resets them
      __threadfence();
      __syncthreads();
      if (tid == 0) is_last = atomicAdd(&cnt[tile], 1) == split - 1;
      __syncthreads();
      if (is_last) {
        __threadfence();
        for (int i = tid; i < n_tile * M; i += kThreads) {
          const int m = i / n_tile, n = n0 + i - m * n_tile;
          if (n < N)
            store_any(out, m, n, N, atomicExch(&ws[(long)m * N + n], 0),
                      fuse, sa, sw);
        }
        if (tid == 0) cnt[tile] = 0;
      }
    }
    __syncthreads();   // red is rewritten by the next tile
  }
}

// ---------------------------------------------------------------------------
// prefill: M > 8 rows, int8 tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int kTileK = 128;               // K bytes per ring stage
constexpr int kTileChunks = kTileK / 16;  // 16-byte chunks per tile row
constexpr int kTileMaxStages = 6;
// dynamic shared memory a tile block may take (the card's 227 KB)
constexpr int kTileSmemMax = 227 * 1024;

// byte offset of 16-byte chunk ``c`` of tile row ``r`` within a stage: the
// chunk index XOR (r % 8), so the 8 rows one ``ldmatrix`` phase reads at
// one chunk lie in 8 distinct 16-byte bank groups
__device__ __forceinline__ int swz(int r, int c) {
  return r * kTileK + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled where !valid
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wait until at most ``n`` (0 .. kTileMaxStages - 2) groups are pending
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One thread's share of copying ROWS x kTileK bytes of a K-major operand
// (row stride K) into a ring stage: chunk ``tid % 8`` of rows tid / 8 + 32
// j.  The row offsets and the stage offsets are fixed for the whole K
// slice; only the K position moves.  Rows past ``n_rows`` and bytes past
// ``k_hi`` are zero.  VEC: 16-byte asynchronous copies (K % 16 == 0 and a
// 16-byte aligned base); otherwise byte loads stored straight to the ring.
template <int ROWS>
struct StageLoader {
  static constexpr int kJ = ROWS * kTileChunks / kThreads;
  static_assert(ROWS * kTileChunks % kThreads == 0, "ROWS % 32 != 0");
  const int8_t* base;
  int row_off[kJ];     // g * K + 16 c, or -1 past the last row
  unsigned smem[kJ];   // byte offset in the stage
  int c16;

  __device__ __forceinline__ StageLoader(const int8_t* src, int g0,
                                         int n_rows, int K) {
    const int tid = threadIdx.x, c = tid % kTileChunks;
    base = src;
    c16 = 16 * c;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int r = tid / kTileChunks + j * (kThreads / kTileChunks);
      const int g = g0 + r;
      row_off[j] = g < n_rows ? g * K + c16 : -1;
      smem[j] = swz(r, c);
    }
  }

  // the stage at K byte ``k0`` (every byte of it below k_hi valid)
  __device__ __forceinline__ void load(unsigned stage, int k0, int k_hi,
                                       int vec) const {
    const bool k_ok = k0 + c16 < k_hi;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const bool ok = k_ok && row_off[j] >= 0;
      const int8_t* p = base + (ok ? row_off[j] + k0 : 0);
      if (vec) {
        cp_async16(stage + smem[j], p, ok);
      } else {
        int4 v = make_int4(0, 0, 0, 0);
        if (ok) {
          // bytes [k, k + 16) of the row, zero past k_hi
          const int k = k0 + c16;
          const int8_t* row = p - k;
          v = make_int4(load_word<false>(row, k, k_hi),
                        load_word<false>(row, k + 4, k_hi),
                        load_word<false>(row, k + 8, k_hi),
                        load_word<false>(row, k + 12, k_hi));
        }
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         stage + smem[j]),
                     "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                     : "memory");
      }
    }
  }
};

// slices of a split K: a thread block cluster of at most 8 blocks
constexpr int kTileMaxSplit = 8;

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// four int32 at shared address ``addr`` of the cluster's block ``rank``
__device__ __forceinline__ int4 ld_cluster4(unsigned addr, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote) : "memory");
  return v;
}

// The end of a BM x BN tile block: NF accumulator fragments in the MMA's C
// layout, fragment f holding rows rf and rf + 8 and columns cf and cf + 1
// (absolute indices) as v[0..1] and v[2..3] (``frag(f, rf, cf, v)`` gives
// them).  The fused epilogue float(acc) * (sa[m] * sw[n]) (or the raw
// int32) is stored straight from the fragments when K is not split.  With
// split > 1 the block is one of a cluster of ``split`` blocks (one K
// slice each): every block puts its partial tile in its own shared memory
// at ``ring`` (the ring is done with), and block z of the cluster sums
// rows [z rows, (z + 1) rows) of all ``split`` partials through
// distributed shared memory and stores them, four columns per thread.
// int32 sums are exact in any order.  Every thread of the block calls it.
template <int BM, int BN, int NF, typename Frag>
__device__ __forceinline__ void finish_tile(Frag frag, unsigned ring,
                                            void* __restrict__ out,
                                            const float* __restrict__ sa,
                                            const float* __restrict__ sw,
                                            int M, int N, int fuse) {
  auto store = [&](int m, int c, int v) {
    if (m >= M || c >= N) return;
    const long idx = (long)m * N + c;
    if (fuse)
      reinterpret_cast<float*>(out)[idx] =
          __fmul_rn(__int2float_rn(v), __fmul_rn(sa[m], sw[c]));
    else
      reinterpret_cast<int*>(out)[idx] = v;
  };
  const int split = gridDim.z;
  if (split == 1) {
    // (m, c) and (m, c + 1) are 8-byte aligned where N is even
    const bool pairs = (N % 2) == 0;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      int rf, cf, v[4];
      frag(f, rf, cf, v);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = rf + 8 * h;
        if (pairs && m < M && cf + 1 < N) {
          const long idx = (long)m * N + cf;
          if (fuse) {
            const float s = sa[m];
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + idx) =
                make_float2(
                    __fmul_rn(__int2float_rn(v[2 * h]), __fmul_rn(s, sw[cf])),
                    __fmul_rn(__int2float_rn(v[2 * h + 1]),
                              __fmul_rn(s, sw[cf + 1])));
          } else {
            *reinterpret_cast<int2*>(reinterpret_cast<int*>(out) + idx) =
                make_int2(v[2 * h], v[2 * h + 1]);
          }
        } else {
          store(m, cf, v[2 * h]);
          store(m, cf + 1, v[2 * h + 1]);
        }
      }
    }
    return;
  }
  // the partial tile's int32 row stride (the pad spreads the fragment
  // stores over the banks; the launcher sizes shared memory for it)
  constexpr int LD = BN + 8;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  cp_async_wait<0>();   // the ring's last (empty) copy groups
  __syncthreads();      // every warp is done reading the ring
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    int rf, cf, v[4];
    frag(f, rf, cf, v);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned at = ring + ((rf - m0 + 8 * h) * LD + (cf - n0)) * 4;
      asm volatile("st.shared.v2.s32 [%0], {%1, %2};\n" ::"r"(at),
                   "r"(v[2 * h]), "r"(v[2 * h + 1])
                   : "memory");
    }
  }
  cluster_sync();   // every slice's partial is in place
  const int rows = (BM + split - 1) / split;
  const int r0 = blockIdx.z * rows, r1 = min(BM, r0 + rows);
  const bool quads = (N % 4) == 0;   // 16-byte aligned rows of out
  for (int i = threadIdx.x; i < (r1 - r0) * (BN / 4); i += kThreads) {
    const int lr = r0 + i / (BN / 4), lc = 4 * (i % (BN / 4));
    const int m = m0 + lr, n = n0 + lc;
    if (m >= M || n >= N) continue;
    const unsigned at = ring + (lr * LD + lc) * 4;
    int4 sum = make_int4(0, 0, 0, 0);
    for (int q = 0; q < split; ++q) {
      const int4 v = ld_cluster4(at, q);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    const long idx = (long)m * N + n;
    if (quads && n + 3 < N) {
      if (fuse) {
        const float s = sa[m];
        const float4 w4 = *reinterpret_cast<const float4*>(sw + n);
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + idx) =
            make_float4(__fmul_rn(__int2float_rn(sum.x), __fmul_rn(s, w4.x)),
                        __fmul_rn(__int2float_rn(sum.y), __fmul_rn(s, w4.y)),
                        __fmul_rn(__int2float_rn(sum.z), __fmul_rn(s, w4.z)),
                        __fmul_rn(__int2float_rn(sum.w), __fmul_rn(s, w4.w)));
      } else {
        *reinterpret_cast<int4*>(reinterpret_cast<int*>(out) + idx) = sum;
      }
    } else {
      store(m, n, sum.x);
      store(m, n + 1, sum.y);
      store(m, n + 2, sum.z);
      store(m, n + 3, sum.w);
    }
  }
  cluster_sync();   // no block leaves while another reads its partial
}

// grid (ceil(M / BM), ceil(N / BN), split), with split > 1 in clusters of
// (1, 1, split); kThreads threads; dynamic shared memory stages x (BM + BN)
// x kTileK bytes, or the partial tile if larger.  Block (x, y, z) computes
// output tile (x, y) over K bytes [z kslice, (z + 1) kslice).  The 8 warps
// are WM x WN, each owning a (BM / WM) x (BN / WN) part of the tile as
// MI x NI fragments of 16 x 8.
template <int BM, int BN, bool APPROX>
__global__ void __launch_bounds__(kThreads, APPROX ? 1 : 2)
bp_tile_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ wt,
               const float* __restrict__ sa, const float* __restrict__ sw,
               void* __restrict__ out, int M, int N, int K, int kslice,
               int stages, int fuse, int vec) {
  constexpr int WM = BM / 16 < 4 ? BM / 16 : 4;   // warps along M
  constexpr int WN = kThreads / 32 / WM;          // warps along N
  constexpr int TM = BM / WM, TN = BN / WN;       // a warp's part
  constexpr int MI = TM / 16, NI = TN / 8;
  static_assert(MI >= 1 && NI >= 2 && NI % 2 == 0, "unsupported tile");
  constexpr int kStage = (BM + BN) * kTileK;
  extern __shared__ __align__(128) int8_t tile_smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_lo = blockIdx.z * kslice;
  const int k_hi = min(K, k_lo + kslice);
  const int steps = (k_hi - k_lo + kTileK - 1) / kTileK;
  const unsigned ring = smem_addr(tile_smem);

  const StageLoader<BM> load_a(a, m0, M, K);
  const StageLoader<BN> load_w(wt, n0, N, K);
  auto load_stage = [&](int step, int slot) {
    const unsigned st = ring + slot * kStage;
    const int k0 = k_lo + step * kTileK;
    load_a.load(st, k0, k_hi, vec);
    load_w.load(st + BM * kTileK, k0, k_hi, vec);
  };

  // this lane's ldmatrix rows: A's fragment rows wm TM + 16 i + lane % 16,
  // at chunk 2 ks + lane / 16; W's pair rows wn TN + 8 j + 8 (lane / 16) +
  // lane % 8, at chunk 2 ks + (lane / 8) % 2.  Every row base is a multiple
  // of 8, so the swizzle's row term is lane % 8 for both.
  const int x = lane & 7;
  const unsigned a_row = (wm * TM + (lane & 15)) * kTileK;
  const unsigned b_row =
      BM * kTileK + (wn * TN + ((lane >> 4) << 3) + x) * kTileK;
  const int a_hi = lane >> 4, b_hi = (lane >> 3) & 1;

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // the ring: stages - 1 stages in flight ahead of the one computed; one
  // commit per stage (empty past the slice) keeps the group count aligned
  for (int s = 0; s < stages - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }
  int slot = 0, fill = stages - 1;
  for (int it = 0; it < steps; ++it) {
    cp_async_wait_upto(stages - 2);   // this thread's copies of step it
    __syncthreads();   // everyone's copies landed; slot ``fill`` is free
    if (it + stages - 1 < steps) load_stage(it + stages - 1, fill);
    cp_async_commit();
    fill = fill + 1 == stages ? 0 : fill + 1;

    const unsigned st = ring + slot * kStage;
    slot = slot + 1 == stages ? 0 : slot + 1;
#pragma unroll
    for (int ks = 0; ks < kTileK / 32; ++ks) {
      unsigned af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(af[i], st + a_row + i * 16 * kTileK +
                           (((2 * ks + a_hi) ^ x) << 4));
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        unsigned r[4];
        ldsm_x4(r, st + b_row + j * 8 * kTileK + (((2 * ks + b_hi) ^ x) << 4));
        bf[j][0] = r[0]; bf[j][1] = r[1];
        bf[j + 1][0] = r[2]; bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
      if (APPROX) {
        // -A0 and -4 A1 from A's fragments, Wlow4 and W0 from W's: the
        // corrections go into the same accumulator
        unsigned p0[MI][4], p1[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned n1 = neg_lsb(af[i][e]);
            const unsigned r4 = rem4(af[i][e], n1);
            p0[i][e] = __vsub4(0u, r4);                   // -A0
            p1[i][e] = __vsub4(r4, rem16(af[i][e], n1));  // -4 A1
          }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const unsigned n0w = neg_lsb(bf[j][0]), n1w = neg_lsb(bf[j][1]);
          const unsigned l0 = rem16(bf[j][0], n0w), l1 = rem16(bf[j][1], n1w);
          const unsigned z0 = rem4(bf[j][0], n0w), z1 = rem4(bf[j][1], n1w);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_s8(acc[i][j], p0[i], l0, l1);   // - A0 Wlow4
            mma_s8(acc[i][j], p1[i], z0, z1);   // - 4 A1 W0
          }
        }
      }
    }
  }

  // fragment (i, j): rows wm TM + 16 i + lane / 4 (+ 8), columns wn TN +
  // 8 j + 2 (lane % 4) (+ 1)
  const int r_base = m0 + wm * TM + (lane >> 2);
  const int c_base = n0 + wn * TN + 2 * (lane & 3);
  finish_tile<BM, BN, MI * NI>(
      [&](int f, int& rf, int& cf, int (&v)[4]) {
        const int i = f / NI, j = f % NI;
        rf = r_base + 16 * i;
        cf = c_base + 8 * j;
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[i][j][e];
      },
      ring, out, sa, sw, M, N, fuse);
}

// ---------------------------------------------------------------------------
// prefill, exact mode: warpgroup MMAs (wgmma) straight from the ring
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand in the ring's layout,
// which is the hardware's 128-byte swizzle: rows of 128 bytes, 8-row groups
// of 1024 bytes (the stride byte offset), 16-byte chunks XOR (row % 8).  The
// stage must start on 1024 bytes; moving ``k`` bytes along K adds k to the
// start address, as within one swizzle atom the hardware applies the XOR to
// the address it forms.
__device__ __forceinline__ uint64_t gmma_desc(unsigned saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3ffff) >> 4);   // start address
  d |= (uint64_t)1 << 16;                             // leading offset (unused)
  d |= (uint64_t)(1024 >> 4) << 32;                   // stride byte offset
  d |= (uint64_t)1 << 62;                             // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the registers a wgmma writes must not be touched while it is in flight
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N, N / 2 int32 per thread) += A (64 x 32 bytes, K-major) x
// W (N x 32 bytes, K-major), both from shared memory
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// grid and clusters as the mma.sync kernel's; kThreads threads = two
// warpgroups; its shared memory plus 1024 bytes for alignment.  BM 128:
// warpgroup g takes rows 64 g .. 64 g + 63 of the tile and all BN
// columns; BM 64: all rows and columns g BN / 2 .. (g + 1) BN / 2 - 1.
// The ring and the split are the mma.sync kernel's.
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
bp_wgmma_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ wt,
                const float* __restrict__ sa, const float* __restrict__ sw,
                void* __restrict__ out, int M, int N, int K, int kslice,
                int stages, int fuse, int vec) {
  static_assert(BM == 64 || BM == 128, "a warpgroup takes 64 rows");
  constexpr int GN = BM == 128 ? BN : BN / 2;   // a warpgroup's columns
  constexpr int R = GN / 2;                     // its int32 per thread
  constexpr int kStage = (BM + BN) * kTileK;
  extern __shared__ __align__(1024) int8_t wg_smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid >> 7;                       // warpgroup
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_lo = blockIdx.z * kslice;
  const int k_hi = min(K, k_lo + kslice);
  const int steps = (k_hi - k_lo + kTileK - 1) / kTileK;
  const unsigned ring = (smem_addr(wg_smem) + 1023u) & ~1023u;

  const StageLoader<BM> load_a(a, m0, M, K);
  const StageLoader<BN> load_w(wt, n0, N, K);
  auto load_stage = [&](int step, int slot) {
    const unsigned st = ring + slot * kStage;
    const int k0 = k_lo + step * kTileK;
    load_a.load(st, k0, k_hi, vec);
    load_w.load(st + BM * kTileK, k0, k_hi, vec);
  };
  // this warpgroup's operands within a stage (1024-byte aligned)
  const unsigned a_off = BM == 128 ? g * 64 * kTileK : 0;
  const unsigned w_off = BM * kTileK + (BM == 128 ? 0 : g * GN * kTileK);

  int acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0;

  // the ring: stages - 1 stages in flight ahead of the one computed; a
  // stage's MMAs finish before the barrier that lets its slot be refilled
  // (keeping them running over the next barrier costs a stage of loads in
  // flight, which the large tiles, two blocks per SM, cannot spare)
  for (int s = 0; s < stages - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }
  int slot = 0, fill = stages - 1;
  for (int it = 0; it < steps; ++it) {
    cp_async_wait_upto(stages - 2);   // this thread's copies of step it
    fence_proxy_async();              // visible to the tensor cores' reads
    __syncthreads();   // everyone's copies landed; slot ``fill`` is free
    if (it + stages - 1 < steps) load_stage(it + stages - 1, fill);
    cp_async_commit();
    fill = fill + 1 == stages ? 0 : fill + 1;

    const unsigned st = ring + slot * kStage;
    slot = slot + 1 == stages ? 0 : slot + 1;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < kTileK / 32; ++ks)
      wgmma_s8<GN>(acc, gmma_desc(st + a_off + 32 * ks),
                   gmma_desc(st + w_off + 32 * ks));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // fragment j (registers 4 j .. 4 j + 3): rows 16 (warp % 4) + lane / 4
  // (+ 8) and columns 8 j + 2 (lane % 4) (+ 1) of the warpgroup's part
  const int r_base = m0 + (BM == 128 ? 64 * g : 0) + 16 * (warp & 3) +
                     (lane >> 2);
  const int c_base = n0 + (BM == 128 ? 0 : g * GN) + 2 * (lane & 3);
  finish_tile<BM, BN, GN / 8>(
      [&](int f, int& rf, int& cf, int (&v)[4]) {
        rf = r_base;
        cf = c_base + 8 * f;
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[4 * f + e];
      },
      ring, out, sa, sw, M, N, fuse);
}

using TileKernel = void (*)(const int8_t*, const int8_t*, const float*,
                            const float*, void*, int, int, int, int, int,
                            int, int);

// Launches a tile kernel on grid (ceil(M / bm), ceil(N / bn), split) with
// dynamic shared memory for its ring (``ring_bytes``) or, where K is split,
// its partial tile, whichever is larger, plus ``align``; a split K runs as
// clusters of ``split`` blocks along z.  ``configured`` is the instance's
// shared memory limit set so far.
int launch_tiles(TileKernel kern, size_t* configured, int bm, int bn,
                 size_t ring_bytes, size_t align, const int8_t* a,
                 const int8_t* wt, const float* sa, const float* sw,
                 void* out, int M, int N, int K, int split, int kslice,
                 int stages, int fuse, int vec, cudaStream_t stream) {
  const size_t partial = split > 1 ? (size_t)bm * (bn + 8) * 4 : 0;
  const size_t smem = (ring_bytes > partial ? ring_bytes : partial) + align;
  if (smem > (size_t)kTileSmemMax || split > kTileMaxSplit)
    return (int)cudaErrorInvalidValue;
  if (smem > *configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();   // not left pending for the next launch's check
      return (int)e;
    }
    *configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + bm - 1) / bm, (N + bn - 1) / bn, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = split;
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a, wt, sa, sw, out, M,
                                           N, K, kslice, stages, fuse, vec);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

template <int BM, int BN, bool APPROX>
int launch_tile(const int8_t* a, const int8_t* wt, const float* sa,
                const float* sw, void* out, int M, int N, int K, int split,
                int kslice, int stages, int fuse, int vec,
                cudaStream_t stream) {
  static size_t configured = 48 * 1024 - 1024;
  return launch_tiles(bp_tile_kernel<BM, BN, APPROX>, &configured, BM, BN,
                      (size_t)stages * (BM + BN) * kTileK, 0, a, wt, sa, sw,
                      out, M, N, K, split, kslice, stages, fuse, vec,
                      stream);
}

template <int BM, int BN>
int launch_wgmma(const int8_t* a, const int8_t* wt, const float* sa,
                 const float* sw, void* out, int M, int N, int K, int split,
                 int kslice, int stages, int fuse, int vec,
                 cudaStream_t stream) {
  // the ring's stages start on 1024 bytes (the swizzle atom)
  static size_t configured = 48 * 1024 - 1024;
  return launch_tiles(bp_wgmma_kernel<BM, BN>, &configured, BM, BN,
                      (size_t)stages * (BM + BN) * kTileK, 1024, a, wt, sa,
                      sw, out, M, N, K, split, kslice, stages, fuse, vec,
                      stream);
}

template <int MP, bool APPROX, bool VEC>
int launch_gemv(const int8_t* a, const int8_t* wt, const float* sa,
                const float* sw, void* out, int* ws, int* cnt, int M, int N,
                int K, int split, int kslice, int wk, int n_blocks, int fuse,
                cudaStream_t stream) {
  const size_t smem =
      (size_t)MP * ((kslice + 15) & ~15) * (APPROX ? 3 : 1);
  if (smem > (size_t)kGemvSmemA) return (int)cudaErrorInvalidValue;
  auto kern = bp_gemv_kernel<MP, APPROX, VEC>;
  // one per instance: the attribute is set on this instance only
  static size_t configured = 48 * 1024 - 1024;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemvSmemA);
    if (e != cudaSuccess) {
      cudaGetLastError();   // not left pending for the next launch's check
      return (int)e;
    }
    configured = kGemvSmemA;
  }
  dim3 grid(n_blocks, split);
  kern<<<grid, kThreads, smem, stream>>>(a, wt, sa, sw, out, ws, cnt, M, N,
                                         K, kslice, wk, fuse);
  return 0;
}

template <int MP>
int gemv_modes(const int8_t* a, const int8_t* wt, const float* sa,
               const float* sw, void* out, int* ws, int* cnt, int M, int N,
               int K, int split, int kslice, int wk, int n_blocks, int approx,
               int fuse, int vec, cudaStream_t s) {
  auto run = approx ? (vec ? launch_gemv<MP, true, true>
                           : launch_gemv<MP, true, false>)
                    : (vec ? launch_gemv<MP, false, true>
                           : launch_gemv<MP, false, false>);
  return run(a, wt, sa, sw, out, ws, cnt, M, N, K, split, kslice, wk,
             n_blocks, fuse, s);
}

}  // namespace

extern "C" {

// a: (M, K) int8 row-major; wt: (N, K) int8 row-major (the K-major weight);
// sa: (M,) f32 and sw: (N,) f32 when fuse != 0 (may be null otherwise);
// out: (M, N) f32 when fuse != 0, else int32.  vec != 0 promises K % 16 == 0
// and 16-byte aligned a and wt.
//
// ``bp_matmul_launch``: M <= 8, the GEMV with the host's plan: ``wk`` warps
// (1, 2, 4 or 8) share each group of 4 columns' K range, which is cut into
// ``split`` slices of ``kslice`` bytes (a multiple of 16; split * kslice >=
// K > (split - 1) * kslice); ``n_blocks`` blocks per slice walk the column
// tiles.  With split > 1, ``ws`` is int32 scratch of M * N elements and
// ``cnt`` int32 scratch of ceil(N / 4), both zero on entry and left zero;
// otherwise they may be null.  Returns cudaGetLastError() after the launch.
int bp_matmul_launch(const void* a, const void* wt, const void* sa,
                     const void* sw, void* out, int M, int N, int K,
                     int approx, int fuse, int vec, int split, int kslice,
                     int wk, int n_blocks, void* ws, void* cnt,
                     void* stream) {
  if (M <= 0 || M > kGemvMaxM || N <= 0 || K <= 0 || split <= 0 ||
      kslice <= 0 || kslice % 16 != 0 ||
      (wk != 1 && wk != 2 && wk != 4 && wk != 8) || n_blocks <= 0 ||
      (long)split * kslice < K || (long)(split - 1) * kslice >= K ||
      (split > 1 && (ws == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* W = static_cast<const int8_t*>(wt);
  const float* SA = static_cast<const float*>(sa);
  const float* SW = static_cast<const float*>(sw);
  int* WS = static_cast<int*>(ws);
  int* CNT = static_cast<int*>(cnt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // two instances of the row count: up to 4 rows (the serves' slots) and
  // up to 8; rows past M are zero
  const int rc =
      M <= 4 ? gemv_modes<4>(A, W, SA, SW, out, WS, CNT, M, N, K, split,
                             kslice, wk, n_blocks, approx, fuse, vec, s)
             : gemv_modes<8>(A, W, SA, SW, out, WS, CNT, M, N, K, split,
                             kslice, wk, n_blocks, approx, fuse, vec, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// ``bp_tile_launch``: M > 8, the tensor-core tile kernels with the host's
// plan: (bm, bn) one of the built tiles, K cut into ``split`` slices (1-8:
// the blocks of one output tile form a cluster) of ``kslice`` bytes (a
// multiple of 128; split * kslice >= K > (split - 1) * kslice), a ring of
// ``stages`` (2-6) stages.  Exact mode's tiles of 64 rows and up run
// ``bp_wgmma_kernel``, the others ``bp_tile_kernel``.  M * K and N * K
// must fit in 31 bits (the loaders' row offsets).  Returns the launch's
// error, or cudaGetLastError() after it.
int bp_tile_launch(const void* a, const void* wt, const void* sa,
                   const void* sw, void* out, int M, int N, int K, int approx,
                   int fuse, int vec, int bm, int bn, int split, int kslice,
                   int stages, void* stream) {
  if (M <= kGemvMaxM || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 ||
      split <= 0 || split > kTileMaxSplit || kslice <= 0 ||
      kslice % kTileK != 0 || stages < 2 || stages > kTileMaxStages ||
      (long)split * kslice < K || (long)(split - 1) * kslice >= K ||
      (N + bn - 1) / bn > 65535 ||
      (long)M * K > 0x7fffffffL || (long)N * K > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* W = static_cast<const int8_t*>(wt);
  const float* SA = static_cast<const float*>(sa);
  const float* SW = static_cast<const float*>(sw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaErrorInvalidValue;
  // exact mode's tiles of 64 rows and up take wgmma
#define BP_WG(BM_, BN_)                                                      \
  if (!approx && bm == BM_ && bn == BN_)                                     \
    rc = launch_wgmma<BM_, BN_>(A, W, SA, SW, out, M, N, K, split, kslice,   \
                                stages, fuse, vec, s);
  BP_WG(64, 64)
  BP_WG(64, 128)
  BP_WG(128, 64)
  BP_WG(128, 128)
#undef BP_WG
#define BP_TILE(BM_, BN_, APPROX_)                                           \
  if (bm == BM_ && bn == BN_ && (approx != 0) == APPROX_)                    \
    rc = launch_tile<BM_, BN_, APPROX_>(A, W, SA, SW, out, M, N, K, split,   \
                                        kslice, stages, fuse, vec, s);
  // exact mode: the 32-row tiles (the larger ones take wgmma); approx
  // mode: every tile, its particles formed in the fragment registers
  BP_TILE(32, 64, false)
  BP_TILE(32, 128, false)
  BP_TILE(32, 64, true)
  BP_TILE(32, 128, true)
  BP_TILE(64, 64, true)
  BP_TILE(64, 128, true)
  BP_TILE(128, 64, true)
  BP_TILE(128, 128, true)
#undef BP_TILE
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
