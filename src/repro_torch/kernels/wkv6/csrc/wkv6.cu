// Chunked RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/wkv6/kernel.py::wkv6_kernel  (body ``_kernel``).
// What it computes, per row (one batch x head) with an (N, N) float32 state
// S, chunk by chunk of L steps, lc_i = sum_{s<i} log_w_s per channel and
// lcs_i = lc_{i+1}:
//
//   out_i = (r_i e^{lc_i}) . S                         cross-chunk
//         + sum_{j<i} A[i, j] v_j,                     intra-chunk pairs
//             A[i, j] = sum_d r_id k_jd e^{lc_id - lcs_jd}
//         + (r_i . u k_i) v_i                          current-token bonus
//   S'    = diag(e^{lc_end}) S + sum_j (k_j e^{lc_end - lcs_j}) v_j^T
//
// r/k/v arrive in float32 or bfloat16 and are upcast on load; log_w, u, the
// state and both outputs are float32.
//
// Differences from the TPU kernel, and why:
//   * The TPU grid walks the chunks as a sequential ("arbitrary") grid axis
//     and keeps S in VMEM scratch between grid steps.  Blocks on the card
//     run in no order, so one block owns a row (or a run of its value
//     columns, below) and walks the chunks itself, with S in shared memory
//     for the whole sequence.  While it computes one chunk, its threads
//     hold the next chunk's inputs in registers (loads issued early), so
//     the walk does not wait on device memory at every chunk.
//   * The TPU kernel builds the (L, L, N) pair tensor e^{lc_i - lcs_j} in
//     VMEM (1 MiB at L = N = 64), over what a block can hold here.  This
//     kernel never builds it, and keeps every exponent <= 0 (factoring
//     e^{lc_i} e^{-lcs_j} over a whole chunk overflows float32: lc falls to
//     about -470 in 64 steps of the model's decay).  The chunk is cut into
//     4-step tiles.  For i in tile ti (first step i0) and j in an earlier
//     tile tj (last step j3),
//         e^{lc_i - lcs_j}
//             = e^{lc_i - lc_i0} e^{lc_i0 - lcs_j3} e^{lcs_j3 - lcs_j}
//     and each factor is <= 1, so a factor that underflows stands for a
//     pair term that is itself below it.  The outer two factors are folded
//     into r and k once per chunk (rE, kF), the middle one is one
//     exponential per tile pair and channel: ~1 exponential per 16 pair
//     terms where the TPU kernel takes 16.  The 6 pairs j < i inside each
//     diagonal tile take one exponential each.  A is summed over the
//     channels in registers, one 4 x 4 tile of (i, j) per pair of threads.
//   * Column c of out and of S' depends on column c of v and S only, so a
//     row's N value columns may be split over ``n_split`` blocks (a second
//     grid axis) to fill the SMs when there are few rows; each such block
//     recomputes A, which is why the wrapper splits only while the blocks
//     fit one wave.
//
// What bounds it on the card.  Per row and chunk it moves ~L N (3 esize +
// 4) bytes in and 4 L N out, and does ~L^2 N / 2 pair terms plus ~2 L N^2
// multiply-adds of small matrix products: at the serve's shape (64 rows of
// 256 steps, N 64) ~17 MB against ~0.5 G float32 operations, so on paper
// it is bound by the CUDA cores, not by bytes.  This first design does all
// of it on the CUDA cores in float32 (no tensor cores, no TMA), with one
// 256-thread block per row per column split and the chunk's r, k, lc, lcs,
// rE, kF, A, v and S in up to ~160 KB of dynamic shared memory; at the
// serve's few rows it is bound by the latency of each block walking its
// chunks in order through six barriers a chunk.
//
// Interface: plain C, loaded with ctypes.  ``wkv6_launch`` returns
// cudaGetLastError() after the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// largest head size: every tile set below fits kThreads threads
constexpr int kMaxN = 64;
// inputs of one chunk a thread prefetches, in 4-element vectors
// (L N / 4 <= 1024 vectors over 256 threads)
constexpr int kVecs = 4;

// Four elements of r/k/v as loaded from device memory: 16 bytes of float32
// or 8 bytes of bfloat16.
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  using type = float4;
};
template <>
struct Raw4<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ void to_f32(const float4 x, float (&o)[4]) {
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
__device__ __forceinline__ void to_f32(const uint2 x, float (&o)[4]) {
  // bfloat16 is the high half of a float32
  o[0] = __uint_as_float(x.x << 16);
  o[1] = __uint_as_float(x.x & 0xffff0000u);
  o[2] = __uint_as_float(x.y << 16);
  o[3] = __uint_as_float(x.y & 0xffff0000u);
}

__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  to_f32(*reinterpret_cast<const float4*>(p), o);
}
__device__ __forceinline__ void st4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// Row length of the [L][N] arrays: N + 4 keeps rows 16-byte aligned and
// moves consecutive rows 4 banks apart.
__host__ __device__ inline int padded(int n) { return n + 4; }

// Shared memory, float32, in this order (row-major, one row per step):
//   rT, kT, lcT, lcsT, rE, kF   [L][NP]  r, k, lc, lcs of the chunk and the
//                                        folded rE = r e^{lc - lc_i0},
//                                        kF = k e^{lcs_j3 - lcs}; rT and kT
//                                        become r e^{lc} and
//                                        k e^{lc_end - lcs} once A is summed
//   aT                          [L][LA]  A transposed: aT[j][i] = A[i][j]
//   vs                          [L][NV]  this block's value columns of v
//   S                           [N][NV]  this block's columns of the state
//   bonus [L], eend [N] (lc_end), us [N] (u)
__host__ __device__ inline size_t smem_floats(int N, int L, int NV) {
  return 6 * (size_t)L * padded(N) + (size_t)L * padded(L) +
         (size_t)L * NV + (size_t)N * NV + L + 2 * (size_t)N;
}

// Tile row ti >= 1 and column tj < ti of the o-th tile below the diagonal
// of an nt x nt tile grid, counted row by row.
__device__ __forceinline__ void lower_tile(int o, int& ti, int& tj) {
  int t = (int)((1.f + sqrtf(1.f + 8.f * (float)o)) * 0.5f);
  while (t * (t - 1) / 2 > o) --t;
  while ((t + 1) * t / 2 <= o) ++t;
  ti = t;
  tj = o - t * (t - 1) / 2;
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    wkv6_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ log_w,
                        const float* __restrict__ u,
                        const float* __restrict__ s0,
                        float* __restrict__ out, float* __restrict__ s_out,
                        int T_len, int N, int NV) {
  using Raw = typename Raw4<T>::type;
  constexpr int LA = L + 4;     // row length of aT
  constexpr int nt = L / 4;     // 4-step tiles along the chunk
  extern __shared__ __align__(16) float smem[];
  const int NP = padded(N);
  float* rT = smem;
  float* kT = rT + L * NP;
  float* lcT = kT + L * NP;
  float* lcsT = lcT + L * NP;
  float* rE = lcsT + L * NP;
  float* kF = rE + L * NP;
  float* aT = kF + L * NP;
  float* vs = aT + L * LA;
  float* S = vs + L * NV;
  float* bonus = S + N * NV;
  float* eend = bonus + L;
  float* us = eend + N;

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int c0 = blockIdx.y * NV;          // this block's first value column
  const size_t seq0 = (size_t)row * T_len * N;
  const int nq = N / 4;                    // 4-channel quads per step
  const int nvq = NV / 4;                  // 4-column quads of this block
  const int n_off = nt * (nt - 1);         // off-diagonal units: 2 per tile
  const int n_out = nt * nvq;              // out tiles
  const int n_state = nq * nvq;            // state tiles
  const int n_chunks = T_len / L;

  {
    const float* srow = s0 + (size_t)row * N * N;
    for (int e = tid; e < N * nvq; e += kThreads) {
      const int d = e / nvq, c = 4 * (e - d * nvq);
      float x[4];
      ld4(srow + (size_t)d * N + c0 + c, x);
      st4(S + d * NV + c, x);
    }
    for (int d = tid; d < N; d += kThreads) us[d] = u[(size_t)row * N + d];
  }

  // next chunk's inputs, held in registers: vector e = tid + q kThreads
  Raw pr[kVecs], pk[kVecs], pv[kVecs];
  float4 pw[kVecs];
  auto prefetch = [&](int ch) {
    const size_t base = seq0 + (size_t)ch * L * N;
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const int e = tid + q * kThreads;
      if (e < L * nq) {
        pr[q] = *reinterpret_cast<const Raw*>(r + base + 4 * e);
        pk[q] = *reinterpret_cast<const Raw*>(k + base + 4 * e);
        pw[q] = *reinterpret_cast<const float4*>(log_w + base + 4 * e);
      }
      if (e < L * nvq) {
        const int t = e / nvq, c = 4 * (e - t * nvq);
        pv[q] = *reinterpret_cast<const Raw*>(v + base + (size_t)t * N + c0 +
                                              c);
      }
    }
  };
  prefetch(0);

  for (int ch = 0; ch < n_chunks; ++ch) {
    const size_t base = seq0 + (size_t)ch * L * N;
    __syncthreads();  // the previous chunk is done with shared memory

    // 1. stage the prefetched chunk (upcast), then prefetch the next one;
    //    log_w lands in lcT and is scanned in place
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const int e = tid + q * kThreads;
      if (e < L * nq) {
        const int t = e / nq, d = 4 * (e - t * nq);
        float x[4];
        to_f32(pr[q], x);
        st4(rT + t * NP + d, x);
        to_f32(pk[q], x);
        st4(kT + t * NP + d, x);
        to_f32(pw[q], x);
        st4(lcT + t * NP + d, x);
      }
      if (e < L * nvq) {
        const int t = e / nvq, c = 4 * (e - t * nvq);
        float x[4];
        to_f32(pv[q], x);
        st4(vs + t * NV + c, x);
      }
    }
    if (ch + 1 < n_chunks) prefetch(ch + 1);
    __syncthreads();

    // 2. per-channel prefix sums in the plain version's order
    //    (lc = cumsum - w, lcs = lc + w), and the bonus, on other threads
    if (tid < N) {
      float cs = 0.f;
#pragma unroll
      for (int t0 = 0; t0 < L; t0 += 16) {
        float w[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) w[t] = lcT[(t0 + t) * NP + tid];
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          cs += w[t];
          const float lc = cs - w[t];
          lcT[(t0 + t) * NP + tid] = lc;
          lcsT[(t0 + t) * NP + tid] = lc + w[t];
        }
      }
      eend[tid] = lcsT[(L - 1) * NP + tid];
    } else if (tid >= kMaxN && tid < kMaxN + L) {
      const int i = tid - kMaxN;
      float b = 0.f;
      for (int d = 0; d < N; d += 4) {
        float rv[4], kv[4], uv[4];
        ld4(rT + i * NP + d, rv);
        ld4(kT + i * NP + d, kv);
        ld4(us + d, uv);
#pragma unroll
        for (int x = 0; x < 4; ++x) b += rv[x] * uv[x] * kv[x];
      }
      bonus[i] = b;
    }
    __syncthreads();

    // 3. rE and kF, and the diagonal tiles of A: thread t takes position
    //    (a, b) = ((t / 4) % 4, t % 4) of diagonal tile t / 16, all
    //    channels, and writes 0 where b >= a
    for (int e = tid; e < L * nq; e += kThreads) {
      const int t = e / nq, d = 4 * (e - t * nq);
      const int t0 = t & ~3, t3 = t | 3;
      float rv[4], kv[4], lv[4], l0[4], sv[4], s3[4];
      ld4(rT + t * NP + d, rv);
      ld4(kT + t * NP + d, kv);
      ld4(lcT + t * NP + d, lv);
      ld4(lcT + t0 * NP + d, l0);
      ld4(lcsT + t * NP + d, sv);
      ld4(lcsT + t3 * NP + d, s3);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        rv[x] *= __expf(lv[x] - l0[x]);
        kv[x] *= __expf(s3[x] - sv[x]);
      }
      st4(rE + t * NP + d, rv);
      st4(kF + t * NP + d, kv);
    }
    if (tid < 16 * nt) {
      const int tile = tid >> 4, a = (tid >> 2) & 3, b = tid & 3;
      const int i = 4 * tile + a, j = 4 * tile + b;
      float acc = 0.f;
      if (b < a) {
        for (int d = 0; d < N; d += 4) {
          float rv[4], kv[4], lv[4], sv[4];
          ld4(rT + i * NP + d, rv);
          ld4(kT + j * NP + d, kv);
          ld4(lcT + i * NP + d, lv);
          ld4(lcsT + j * NP + d, sv);
#pragma unroll
          for (int x = 0; x < 4; ++x)
            acc += rv[x] * kv[x] * __expf(lv[x] - sv[x]);
        }
      }
      aT[j * LA + i] = acc;
    }
    __syncthreads();

    // 4. the off-diagonal tiles of A (two threads per tile, alternate
    //    channel quads), and the decays in place: r <- r e^{lc},
    //    k <- k e^{lc_end - lcs}
    {
      float acc[4][4] = {};
      int ti = 0, tj = 0;
      const bool off = tid < n_off;
      if (off) {
        lower_tile(tid >> 1, ti, tj);
        const int i0 = 4 * ti, j0 = 4 * tj;
        for (int d = 4 * (tid & 1); d < N; d += 8) {
          float g[4], l0[4], s3[4], re[4][4], kf[4][4];
          ld4(lcT + i0 * NP + d, l0);
          ld4(lcsT + (j0 + 3) * NP + d, s3);
#pragma unroll
          for (int x = 0; x < 4; ++x) g[x] = __expf(l0[x] - s3[x]);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            ld4(rE + (i0 + a) * NP + d, re[a]);
            ld4(kF + (j0 + a) * NP + d, kf[a]);
          }
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const float rg = re[a][x] * g[x];
#pragma unroll
              for (int b = 0; b < 4; ++b) acc[a][b] += rg * kf[b][x];
            }
        }
      }
      // the two halves of a tile sit in lanes 2m and 2m + 1
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float other = __shfl_xor_sync(0xffffffffu, acc[a][b], 1);
          acc[a][b] += other;
        }
      if (off && (tid & 1) == 0) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            aT[(4 * tj + b) * LA + 4 * ti + a] = acc[a][b];
      }
    }
    for (int e = tid; e < L * nq; e += kThreads) {
      const int t = e / nq, d = 4 * (e - t * nq);
      float rv[4], kv[4], lv[4], sv[4], ev[4];
      ld4(rT + t * NP + d, rv);
      ld4(kT + t * NP + d, kv);
      ld4(lcT + t * NP + d, lv);
      ld4(lcsT + t * NP + d, sv);
      ld4(eend + d, ev);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        rv[x] *= __expf(lv[x]);
        kv[x] *= __expf(ev[x] - sv[x]);
      }
      st4(rT + t * NP + d, rv);
      st4(kT + t * NP + d, kv);
    }
    __syncthreads();

    // 5. out tiles (written to device memory), then each thread's state
    //    tile (kept in registers until every reader of the old S is done)
    float sn[4][4];
    int my_state = -1;
    for (int w = tid; w < n_out + n_state; w += kThreads) {
      if (w < n_out) {
        const int ti = w / nvq, c = 4 * (w - ti * nvq);
        const int i0 = 4 * ti;
        float acc[4][4] = {};
        for (int d = 0; d < N; d += 4) {
          float a[4][4], s[4][4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            ld4(rT + (i0 + x) * NP + d, a[x]);
            ld4(S + (d + x) * NV + c, s[x]);
          }
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int z = 0; z < 4; ++z)
#pragma unroll
              for (int y = 0; y < 4; ++y) acc[x][y] += a[x][z] * s[z][y];
        }
        // A[i, j] is zero for j >= i: rows of this tile need j < i0 + 4
        for (int j = 0; j < i0 + 4; ++j) {
          float a[4], vv[4];
          ld4(aT + j * LA + i0, a);
          ld4(vs + j * NV + c, vv);
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) acc[x][y] += a[x] * vv[y];
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = i0 + x;
          const float b = bonus[i];
          float vv[4], o[4];
          ld4(vs + i * NV + c, vv);
#pragma unroll
          for (int y = 0; y < 4; ++y) o[y] = acc[x][y] + b * vv[y];
          st4(out + base + (size_t)i * N + c0 + c, o);
        }
      } else {
        my_state = w - n_out;
        const int d0 = 4 * (my_state / nvq);
        const int c = 4 * (my_state - (d0 / 4) * nvq);
        float ev[4];
        ld4(eend + d0, ev);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float e = __expf(ev[x]);
          float s[4];
          ld4(S + (d0 + x) * NV + c, s);
#pragma unroll
          for (int y = 0; y < 4; ++y) sn[x][y] = e * s[y];
        }
#pragma unroll 4
        for (int j = 0; j < L; ++j) {
          float kd[4], vv[4];
          ld4(kT + j * NP + d0, kd);
          ld4(vs + j * NV + c, vv);
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) sn[x][y] += kd[x] * vv[y];
        }
      }
    }
    __syncthreads();
    if (my_state >= 0) {
      const int d0 = 4 * (my_state / nvq);
      const int c = 4 * (my_state - (d0 / 4) * nvq);
#pragma unroll
      for (int x = 0; x < 4; ++x) st4(S + (d0 + x) * NV + c, sn[x]);
    }
  }
  __syncthreads();
  float* sorow = s_out + (size_t)row * N * N;
  for (int e = tid; e < N * nvq; e += kThreads) {
    const int d = e / nvq, c = 4 * (e - d * nvq);
    float x[4];
    ld4(S + d * NV + c, x);
    st4(sorow + (size_t)d * N + c0 + c, x);
  }
}

template <typename T, int L>
int launch(const void* r, const void* k, const void* v, const void* log_w,
           const void* u, const void* s0, void* out, void* s_out, int R,
           int T_len, int N, int n_split, cudaStream_t stream) {
  const int NV = N / n_split;
  const size_t smem = smem_floats(N, L, NV) * sizeof(float);
  auto kern = wkv6_chunked_kernel<T, L>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(R, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(log_w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_out), T_len, N, NV);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chunk(const void* r, const void* k, const void* v,
                 const void* log_w, const void* u, const void* s0, void* out,
                 void* s_out, int R, int T_len, int N, int chunk, int n_split,
                 cudaStream_t stream) {
  switch (chunk) {
    case 16:
      return launch<T, 16>(r, k, v, log_w, u, s0, out, s_out, R, T_len, N,
                           n_split, stream);
    case 32:
      return launch<T, 32>(r, k, v, log_w, u, s0, out, s_out, R, T_len, N,
                           n_split, stream);
    case 64:
      return launch<T, 64>(r, k, v, log_w, u, s0, out, s_out, R, T_len, N,
                           n_split, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// r, k, v: (R, T, N) of one dtype (0: float32, 1: bfloat16); log_w: (R, T,
// N) float32; u: (R, N) float32; state: (R, N, N) float32; out: (R, T, N)
// float32; state_out: (R, N, N) float32; all contiguous and 16-byte
// aligned.  chunk is 16, 32 or 64; N is a multiple of 4, at most 64;
// T % chunk == 0; each row's N value columns are split over n_split blocks
// (N / n_split a multiple of 4).  Returns cudaGetLastError() after the
// launch.
int wkv6_launch(const void* r, const void* k, const void* v,
                const void* log_w, const void* u, const void* state,
                void* out, void* state_out, int R, int T, int N, int chunk,
                int n_split, int dtype, void* stream) {
  if (R <= 0 || T <= 0 || N <= 0 || N > kMaxN || N % 4 != 0 || chunk <= 0 ||
      T % chunk != 0 || n_split <= 0 || N % n_split != 0 ||
      (N / n_split) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_chunk<__nv_bfloat16>(r, k, v, log_w, u, state, out,
                                       state_out, R, T, N, chunk, n_split, s);
  if (dtype == 0)
    return launch_chunk<float>(r, k, v, log_w, u, state, out, state_out, R,
                               T, N, chunk, n_split, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
