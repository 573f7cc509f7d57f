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
// What bounds it on the card, and what the design does about it:
//   * decode (M = number of slots, at most 8): every weight byte is read
//     once and used M times, so the call is bound by weight bytes from HBM
//     (about 14 MB for the 1536 x 8960 FFN weights, ~4 us at 3.35 TB/s).
//     ``bp_gemv_kernel`` gives each warp whole output columns, streams the
//     K-major weight rows with 16-byte loads (a warp reads 512 contiguous
//     bytes per step) and keeps the tiny A block in shared memory; no
//     shared-memory staging of the weight and no cross-block reduction.
//   * prefill (M = batch x padded prompt, hundreds of rows): bound by the
//     int8 MAC rate.  ``bp_tile_kernel`` is a plain 64 x 64 output tile per
//     block, K in 64-byte steps through shared memory, 4 x 4 outputs per
//     thread with ``__dp4a``.  It does not reach the int8 tensor-core rate
//     (that needs mma/wgmma and TMA pipelines, later work); it is the simple
//     correct version.
//   * approx mode forms the particles of each tile as it is loaded and runs
//     the two correction contractions in the same pass; all sums are exact
//     int32 (|acc| <= 127^2 * K < 2^31 for K < 133,000).
//   * ragged M, N and K are masked inside the kernels (no host padding).
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

// sign(v) * (|v| & MASK) per byte lane
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

// sign(v) * ((|v| >> 2) & 3) per byte lane
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
// decode: M <= 8 rows, one warp per pair of output columns
// ---------------------------------------------------------------------------

constexpr int kGemvMaxM = 8;
constexpr int kGemvWarps = kThreads / 32;
constexpr int kGemvCols = 2;          // output columns per warp
constexpr int kGemvChunk = 1024;      // K bytes of A staged per pass

template <bool APPROX, bool VEC, bool FUSE>
__global__ void __launch_bounds__(kThreads)
bp_gemv_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ wt,
               const float* __restrict__ sa, const float* __restrict__ sw,
               void* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t a_s[kGemvMaxM][kGemvChunk];
  __shared__ __align__(16) int8_t a0_s[APPROX ? kGemvMaxM : 1]
                                      [APPROX ? kGemvChunk : 16];
  __shared__ __align__(16) int8_t a1_s[APPROX ? kGemvMaxM : 1]
                                      [APPROX ? kGemvChunk : 16];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_base = (blockIdx.x * kGemvWarps + warp) * kGemvCols;

  int acc[kGemvCols][kGemvMaxM];
  int c1[kGemvCols][kGemvMaxM];   // A0 @ Wlow4 (approx)
  int c2[kGemvCols][kGemvMaxM];   // A1 @ W0    (approx)
#pragma unroll
  for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
    for (int m = 0; m < kGemvMaxM; ++m) acc[c][m] = c1[c][m] = c2[c][m] = 0;

  for (int k0 = 0; k0 < K; k0 += kGemvChunk) {
    const int len = min(kGemvChunk, K - k0);
    // stage A[:, k0:k0+chunk] (zero past K) as 32-bit words
    for (int i = tid; i < kGemvMaxM * (kGemvChunk / 4); i += kThreads) {
      const int m = i / (kGemvChunk / 4);
      const int kw = (i % (kGemvChunk / 4)) * 4;
      int v = 0;
      if (m < M) {
        const int8_t* row = a + (long)m * K + k0;
        unsigned r = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (kw + j < len) r |= ((unsigned)(uint8_t)row[kw + j]) << (8 * j);
        v = (int)r;
      }
      *reinterpret_cast<int*>(&a_s[m][kw]) = v;
      if (APPROX) {
        *reinterpret_cast<int*>(&a0_s[m][kw]) = particles_low<3>(v);
        *reinterpret_cast<int*>(&a1_s[m][kw]) = particles_shift2(v);
      }
    }
    __syncthreads();

    for (int k = lane * 16; k < len; k += 32 * 16) {
      int wv[kGemvCols][4];
#pragma unroll
      for (int c = 0; c < kGemvCols; ++c) {
        const int n = n_base + c;
        if (n < N) {
          const int8_t* row = wt + (long)n * K + k0;
          if (VEC) {
            int4 w4 = *reinterpret_cast<const int4*>(row + k);
            wv[c][0] = w4.x; wv[c][1] = w4.y; wv[c][2] = w4.z; wv[c][3] = w4.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              wv[c][j] = load_word<false>(row, k + 4 * j, len);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[c][j] = 0;
        }
      }
      // weight particles once per loaded word, reused by every row of A
      int wl4[kGemvCols][4], w0[kGemvCols][4];
      if (APPROX) {
#pragma unroll
        for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wl4[c][j] = particles_low<15>(wv[c][j]);
            w0[c][j] = particles_low<3>(wv[c][j]);
          }
      }
#pragma unroll
      for (int m = 0; m < kGemvMaxM; ++m) {
        if (m < M) {
          const int4 av = *reinterpret_cast<const int4*>(&a_s[m][k]);
          const int aw[4] = {av.x, av.y, av.z, av.w};
          int a0w[4], a1w[4];
          if (APPROX) {
            const int4 a0 = *reinterpret_cast<const int4*>(&a0_s[m][k]);
            const int4 a1 = *reinterpret_cast<const int4*>(&a1_s[m][k]);
            a0w[0] = a0.x; a0w[1] = a0.y; a0w[2] = a0.z; a0w[3] = a0.w;
            a1w[0] = a1.x; a1w[1] = a1.y; a1w[2] = a1.z; a1w[3] = a1.w;
          }
#pragma unroll
          for (int c = 0; c < kGemvCols; ++c) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[c][m] = __dp4a(aw[j], wv[c][j], acc[c][m]);
              if (APPROX) {
                c1[c][m] = __dp4a(a0w[j], wl4[c][j], c1[c][m]);
                c2[c][m] = __dp4a(a1w[j], w0[c][j], c2[c][m]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kGemvCols; ++c) {
#pragma unroll
    for (int m = 0; m < kGemvMaxM; ++m) {
      int v = APPROX ? acc[c][m] - c1[c][m] - 4 * c2[c][m] : acc[c][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[c][m] = v;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) {
      const int n = n_base + c;
      if (n >= N) continue;
#pragma unroll
      for (int m = 0; m < kGemvMaxM; ++m)
        if (m < M)
          store_out<FUSE>(out, (long)m * N + n, acc[c][m],
                          FUSE ? sa[m] : 1.f, FUSE ? sw[n] : 1.f);
    }
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
void launch(const int8_t* a, const int8_t* wt, const float* sa,
            const float* sw, void* out, int M, int N, int K,
            cudaStream_t stream) {
  if (M <= kGemvMaxM) {
    const int per_block = kGemvWarps * kGemvCols;
    dim3 grid((N + per_block - 1) / per_block);
    bp_gemv_kernel<APPROX, VEC, FUSE>
        <<<grid, kThreads, 0, stream>>>(a, wt, sa, sw, out, M, N, K);
  } else {
    dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
    bp_tile_kernel<APPROX, VEC, FUSE>
        <<<grid, kThreads, 0, stream>>>(a, wt, sa, sw, out, M, N, K);
  }
}

}  // namespace

extern "C" {

// a: (M, K) int8 row-major; wt: (N, K) int8 row-major (the K-major weight);
// sa: (M,) f32 and sw: (N,) f32 when fuse != 0 (may be null otherwise);
// out: (M, N) f32 when fuse != 0, else int32.  vec != 0 promises K % 16 == 0
// and 16-byte aligned a and wt.  Returns cudaGetLastError() after launch.
int bp_matmul_launch(const void* a, const void* wt, const void* sa,
                     const void* sw, void* out, int M, int N, int K,
                     int approx, int fuse, int vec, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* W = static_cast<const int8_t*>(wt);
  const float* SA = static_cast<const float*>(sa);
  const float* SW = static_cast<const float*>(sw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = (approx ? 4 : 0) | (vec ? 2 : 0) | (fuse ? 1 : 0);
  switch (key) {
    case 0: launch<false, false, false>(A, W, SA, SW, out, M, N, K, s); break;
    case 1: launch<false, false, true>(A, W, SA, SW, out, M, N, K, s); break;
    case 2: launch<false, true, false>(A, W, SA, SW, out, M, N, K, s); break;
    case 3: launch<false, true, true>(A, W, SA, SW, out, M, N, K, s); break;
    case 4: launch<true, false, false>(A, W, SA, SW, out, M, N, K, s); break;
    case 5: launch<true, false, true>(A, W, SA, SW, out, M, N, K, s); break;
    case 6: launch<true, true, false>(A, W, SA, SW, out, M, N, K, s); break;
    default: launch<true, true, true>(A, W, SA, SW, out, M, N, K, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
