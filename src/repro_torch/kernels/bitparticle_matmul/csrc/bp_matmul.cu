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
// Prefill (M = batch x padded prompt, hundreds of rows): ``bp_tile_kernel``,
// bound by the int8 MAC rate.  A plain 64 x 64 output tile per block, K in
// 64-byte steps through shared memory, 4 x 4 outputs per thread with
// ``__dp4a``.  It does not reach the int8 tensor-core rate (that needs
// mma/wgmma and TMA pipelines, later work); it is the simple correct
// version.  It forms particles per byte (``particles_low`` /
// ``particles_shift2``) as it loads each tile.
//
// All sums are exact int32 (|acc| <= 127^2 * K < 2^31 for K < 133,000).
// Ragged M, N and K are masked inside the kernels (no host padding).
//
// Interface: plain C, loaded with ctypes.  ``bp_matmul_launch`` returns
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// particles of 4 packed signed int8 lanes
// ---------------------------------------------------------------------------

// sign(v) * (|v| & MASK) per byte lane (the prefill tile kernel's)
template <int MASK>
__device__ __forceinline__ int particles_low(int w) {
  unsigned r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int v = (int)(signed char)(w >> (8 * i));
    int m = (v < 0 ? -v : v) & MASK;
    int p = v < 0 ? -m : m;
    r |= ((unsigned)p & 0xffu) << (8 * i);
  }
  return (int)r;
}

// sign(v) * ((|v| >> 2) & 3) per byte lane (the prefill tile kernel's)
__device__ __forceinline__ int particles_shift2(int w) {
  unsigned r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int v = (int)(signed char)(w >> (8 * i));
    int m = ((v < 0 ? -v : v) >> 2) & 3;
    int p = v < 0 ? -m : m;
    r |= ((unsigned)p & 0xffu) << (8 * i);
  }
  return (int)r;
}

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
// prefill: 64 x 64 output tile per block, 4 x 4 outputs per thread
// ---------------------------------------------------------------------------

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 64;             // bytes of K per step
constexpr int kTileKW = kTileK / 4;    // 32-bit words of K per step
constexpr int kPad = kTileKW + 1;      // odd row stride: conflict-free reads

template <bool APPROX, bool VEC, bool FUSE>
__global__ void __launch_bounds__(kThreads)
bp_tile_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ wt,
               const float* __restrict__ sa, const float* __restrict__ sw,
               void* __restrict__ out, int M, int N, int K) {
  constexpr int PM = APPROX ? kTileM : 1;
  constexpr int PN = APPROX ? kTileN : 1;
  __shared__ int as[kTileM][kPad];
  __shared__ int ws[kTileN][kPad];
  __shared__ int as0[PM][kPad];   // A0
  __shared__ int as1[PM][kPad];   // A1
  __shared__ int ws0[PN][kPad];   // W0
  __shared__ int wsl[PN][kPad];   // Wlow4

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;

  int acc[4][4], c1[4][4], c2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = c1[i][j] = c2[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int i = tid; i < kTileM * kTileKW; i += kThreads) {
      const int r = i / kTileKW;
      const int kw = i % kTileKW;
      const int k = k0 + 4 * kw;
      const int gm = m0 + r;
      const int gn = n0 + r;
      const int av = gm < M ? load_word<VEC>(a + (long)gm * K, k, K) : 0;
      const int wv = gn < N ? load_word<VEC>(wt + (long)gn * K, k, K) : 0;
      as[r][kw] = av;
      ws[r][kw] = wv;
      if (APPROX) {
        as0[r][kw] = particles_low<3>(av);
        as1[r][kw] = particles_shift2(av);
        ws0[r][kw] = particles_low<3>(wv);
        wsl[r][kw] = particles_low<15>(wv);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kTileKW; ++kw) {
      int av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], wv[j], acc[i][j]);
      if (APPROX) {
        int a0[4], a1[4], w0[4], wl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a0[i] = as0[ty + 16 * i][kw];
          a1[i] = as1[ty + 16 * i][kw];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w0[j] = ws0[tx + 16 * j][kw];
          wl[j] = wsl[tx + 16 * j][kw];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            c1[i][j] = __dp4a(a0[i], wl[j], c1[i][j]);
            c2[i][j] = __dp4a(a1[i], w0[j], c2[i][j]);
          }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const int v = APPROX ? acc[i][j] - c1[i][j] - 4 * c2[i][j] : acc[i][j];
      store_out<FUSE>(out, (long)m * N + n, v, FUSE ? sa[m] : 1.f,
                      FUSE ? sw[n] : 1.f);
    }
  }
}

template <bool APPROX, bool VEC, bool FUSE>
void launch_tile(const int8_t* a, const int8_t* wt, const float* sa,
                 const float* sw, void* out, int M, int N, int K,
                 cudaStream_t stream) {
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  bp_tile_kernel<APPROX, VEC, FUSE>
      <<<grid, kThreads, 0, stream>>>(a, wt, sa, sw, out, M, N, K);
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
// M <= 8 takes the GEMV with the host's plan: ``wk`` warps (1, 2, 4 or 8)
// share each group of 4 columns' K range, which is cut into ``split``
// slices of ``kslice`` bytes (a multiple of 16; split * kslice >= K >
// (split - 1) * kslice); ``n_blocks`` blocks per slice walk the column
// tiles.  With split > 1, ``ws`` is int32 scratch of M * N elements and
// ``cnt`` int32 scratch of ceil(N / 4), both zero on entry and left zero;
// otherwise they may be null.  M > 8 ignores split, kslice, wk, n_blocks,
// ws and cnt.  Returns cudaGetLastError() after the launch.
int bp_matmul_launch(const void* a, const void* wt, const void* sa,
                     const void* sw, void* out, int M, int N, int K,
                     int approx, int fuse, int vec, int split, int kslice,
                     int wk, int n_blocks, void* ws, void* cnt,
                     void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* W = static_cast<const int8_t*>(wt);
  const float* SA = static_cast<const float*>(sa);
  const float* SW = static_cast<const float*>(sw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kGemvMaxM) {
    if (split <= 0 || kslice <= 0 || kslice % 16 != 0 ||
        (wk != 1 && wk != 2 && wk != 4 && wk != 8) || n_blocks <= 0 ||
        (long)split * kslice < K || (long)(split - 1) * kslice >= K ||
        (split > 1 && (ws == nullptr || cnt == nullptr)))
      return (int)cudaErrorInvalidValue;
    int* WS = static_cast<int*>(ws);
    int* CNT = static_cast<int*>(cnt);
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
  const int key = (approx ? 4 : 0) | (vec ? 2 : 0) | (fuse ? 1 : 0);
  switch (key) {
    case 0: launch_tile<false, false, false>(A, W, SA, SW, out, M, N, K, s); break;
    case 1: launch_tile<false, false, true>(A, W, SA, SW, out, M, N, K, s); break;
    case 2: launch_tile<false, true, false>(A, W, SA, SW, out, M, N, K, s); break;
    case 3: launch_tile<false, true, true>(A, W, SA, SW, out, M, N, K, s); break;
    case 4: launch_tile<true, false, false>(A, W, SA, SW, out, M, N, K, s); break;
    case 5: launch_tile<true, false, true>(A, W, SA, SW, out, M, N, K, s); break;
    case 6: launch_tile<true, true, false>(A, W, SA, SW, out, M, N, K, s); break;
    default: launch_tile<true, true, true>(A, W, SA, SW, out, M, N, K, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
