// Paged-attention decode for Hopper (sm_90a): one query token per sequence
// against K/V stored in fixed-size pages, gathered through a block table.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::paged_attention_kernel
// (body ``_kernel``).  What it computes, for sequence b and query head h of
// kv head kh = h / G (G = H / KH query rows share one kv head, GQA):
//
//   qr      = float(q[b, h]) * D^-0.5                    (pre-scaled query)
//   s[t]    = qr . k[page(t), t % bs, kh]                (float32)
//   valid   = t <= lengths[b]                            (INCLUSIVE)
//   online softmax over the pages: m, l, acc carried page by page,
//   masked scores are -0.7 * FLT_MAX and contribute exactly 0;
//   out     = acc / max(l, 1e-37)                        (in q's dtype)
//
// with page(t) = tables[b, t / bs].  Unused table entries point at page 0,
// the pool's trash page; only positions <= lengths[b] are ever read.
//
// Differences from the TPU kernel, and why:
//   * The TPU grid walks the pages as its innermost, sequential grid axis
//     and carries (m, l, acc) in VMEM scratch from one grid step to the
//     next.  Blocks on the card run in no order and a decode batch is a few
//     sequences, so one (sequence, kv head) is split over up to ``n_split``
//     blocks (a third grid axis), each walking its own run of pages with
//     the state in shared memory; a second kernel merges the splits'
//     (acc, m, l) as flash decoding does (the reference's mesh path merges
//     shards the same way, ``sharding.combine_softmax_state``).  With one
//     split the block writes the output itself.  Each step of a block's
//     walk takes several pages at once (up to 128 K/V rows, one per
//     thread), where the TPU takes one.
//   * The TPU kernel visits every table entry.  This one stops after the
//     page holding position lengths[b]: a later page is fully masked, and in
//     the reference it leaves the state unchanged (m_new = m_prev, every
//     exp is 0, corr = 1), so skipping it is exact; a split whose pages all
//     lie past it contributes the neutral state (m = -0.7 FLT_MAX, l = 0,
//     acc = 0).  Position 0 is always valid, so the merged m is finite, and
//     a length-0 slot whose table is all trash still gives finite output.
//   * The block table is read by the block itself (no scalar prefetch).
//
// What bounds it on the card: decode attention does ~2 flops per K/V
// element read, far below the H100's ~295 flops per byte, so it is bound by
// the bytes of the valid K and V rows (plus q and out) over HBM.  The
// design stages a step's K and V rows for its kv head into shared memory
// with 16-byte loads where the layout allows (bf16, D % 8 == 0), several
// rows' loads in flight at once, so each element is read from device
// memory once; the G query rows of the kv head then share it.  A thread
// scores one K row against all G query rows (registers, no cross-lane
// reduction; K rows padded in shared memory so the column reads do not
// conflict), the softmax update is one warp per query row, and the P @ V
// update gives each thread one head dimension for all G rows.  Measured on
// the H100, a step is bound by latency (one 128-thread block per SM, each
// stage waiting on the last), not by bytes: the splits buy parallelism,
// not bandwidth.
//
// Interface: plain C, loaded with ctypes.  ``paged_attention_launch``
// returns cudaGetLastError() after the launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// query rows of one kv head held in registers at a time (G is looped over
// in groups of this many)
constexpr int kMaxG = 8;
// shared memory one block may take (of the 227 KB a Hopper block can have)
constexpr size_t kSmemBudget = 200 * 1024;
// -0.7 * FLT_MAX, the reference's NEG_INF
constexpr float kNegInf = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Stage ``rows`` K and V rows of one kv head, from the pages in ``page_s``
// (``bs`` rows each), into shared memory as float32: K with a padded row
// stride ``ks`` (conflict-free when each thread reads its own row), V
// dense.  ``head`` points each page row at this kv head.  VEC: 16-byte
// loads (every row is a whole number of aligned 16-byte chunks).
template <typename T, bool VEC>
__device__ __forceinline__ void stage_rows(
    const T* __restrict__ kp, const T* __restrict__ vp, const int* page_s,
    long page_stride, long row_stride, long head, int bs, int rows, int D,
    int ks, float* __restrict__ k_s, float* __restrict__ v_s) {
  if (VEC) {
    constexpr int kPer = 16 / sizeof(T);
    const int chunks = D / kPer;
    // unrolled so that several rows' loads are in flight at once
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int j = i / chunks, c = i - j * chunks;
      const int pg = j / bs, r = j - pg * bs;
      const long off = (long)page_s[pg] * page_stride + head +
                       r * row_stride + c * kPer;
      const uint4 wk = *reinterpret_cast<const uint4*>(kp + off);
      const uint4 wv = *reinterpret_cast<const uint4*>(vp + off);
      const T* ek = reinterpret_cast<const T*>(&wk);
      const T* ev = reinterpret_cast<const T*>(&wv);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        k_s[j * ks + c * kPer + u] = to_f32(ek[u]);
        v_s[j * D + c * kPer + u] = to_f32(ev[u]);
      }
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const int pg = j / bs, r = j - pg * bs;
      const long off =
          (long)page_s[pg] * page_stride + head + r * row_stride + d;
      k_s[j * ks + d] = to_f32(kp[off]);
      v_s[i] = to_f32(vp[off]);
    }
  }
}

// grid (KH, B, n_split), kThreads threads; ``ppc`` pages per step, ``cps``
// steps per split; dynamic shared memory as ``smem_bytes`` computes.  With
// one split the block normalises and writes ``out``; with several, each
// writes its raw (acc, m, l) to ``part`` for ``merge_kernel``.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int KH, int D, int bs, int P, int ppc,
                       int cps, float* __restrict__ part, float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int G = H / KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows_max = ppc * bs;
  const int ks = D + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                  // (G, D) pre-scaled query rows
  float* acc_s = q_s + G * D;         // (G, D) unnormalised output
  float* k_s = acc_s + G * D;         // (rows_max, D + 1) K rows
  float* v_s = k_s + rows_max * ks;   // (rows_max, D) V rows
  float* p_s = v_s + rows_max * D;    // (G, rows_max) scores, then probs
  float* m_s = p_s + G * rows_max;    // (G,) running max
  float* l_s = m_s + G;               // (G,) running sum
  float* c_s = l_s + G;               // (G,) this step's rescale factor
  int* page_s = reinterpret_cast<int*>(c_s + G);   // (ppc,) page ids

  // query heads kh*G .. kh*G + G - 1 are contiguous rows of q[b]
  const long q_base = ((long)b * H + (long)kh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q[q_base + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int len = lengths[b];
  int n_pages = len < 0 ? 0 : len / bs + 1;
  if (n_pages > P) n_pages = P;
  const long row_stride = (long)KH * D;
  const long page_stride = (long)bs * row_stride;

  const int p_begin = split * cps * ppc;
  const int p_end = min(n_pages, p_begin + cps * ppc);
  for (int p0 = p_begin; p0 < p_end; p0 += ppc) {
    const int np = min(ppc, p_end - p0);
    const int rows = np * bs;
    for (int i = tid; i < np; i += kThreads)
      page_s[i] = tables[(long)b * P + p0 + i];
    __syncthreads();
    stage_rows<T, VEC>(kp, vp, page_s, page_stride, row_stride,
                       (long)kh * D, bs, rows, D, ks, k_s, v_s);
    __syncthreads();

    // scores: one thread per K row, all G query rows at once
    const int pos0 = p0 * bs;
    for (int j = tid; j < rows; j += kThreads) {
      const bool valid = pos0 + j <= len;
      for (int g0 = 0; g0 < G; g0 += kMaxG) {
        float s[kMaxG];
#pragma unroll
        for (int u = 0; u < kMaxG; ++u) s[u] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const float kv = k_s[j * ks + d];
#pragma unroll
          for (int u = 0; u < kMaxG; ++u)
            if (g0 + u < G) s[u] += q_s[(g0 + u) * D + d] * kv;
        }
#pragma unroll
        for (int u = 0; u < kMaxG; ++u)
          if (g0 + u < G) p_s[(g0 + u) * rows_max + j] = valid ? s[u] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax update: one warp per query row, lanes over the rows
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * rows_max;
      float mx = kNegInf;
      for (int j = lane; j < rows; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < rows; j += 32) {
        const float e = (pos0 + j <= len) ? expf(pg[j] - m_new) : 0.f;
        pg[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V: one thread per head dimension, all G rows
    for (int d = tid; d < D; d += kThreads) {
      for (int g0 = 0; g0 < G; g0 += kMaxG) {
        float a[kMaxG];
#pragma unroll
        for (int u = 0; u < kMaxG; ++u) a[u] = 0.f;
#pragma unroll 4
        for (int j = 0; j < rows; ++j) {
          const float vv = v_s[j * D + d];
#pragma unroll
          for (int u = 0; u < kMaxG; ++u)
            if (g0 + u < G) a[u] += p_s[(g0 + u) * rows_max + j] * vv;
        }
#pragma unroll
        for (int u = 0; u < kMaxG; ++u)
          if (g0 + u < G) {
            float* acc = acc_s + (g0 + u) * D + d;
            *acc = *acc * c_s[g0 + u] + a[u];
          }
      }
    }
    __syncthreads();
  }
  __syncthreads();   // l_s of a slot with no valid page was set by another thread

  if (n_split == 1) {
    for (int i = tid; i < G * D; i += kThreads)
      store(&out[q_base + i], acc_s[i] / fmaxf(l_s[i / D], 1e-37f));
    return;
  }
  // this split's raw state: (G, D + 2) = acc row, then m, l
  float* mine = part + (((long)b * KH + kh) * n_split + split) * G * (D + 2);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    mine[g * (D + 2) + (i - g * D)] = acc_s[i];
  }
  for (int g = tid; g < G; g += kThreads) {
    mine[g * (D + 2) + D] = m_s[g];
    mine[g * (D + 2) + D + 1] = l_s[g];
  }
}

// Merge the splits' states of one (sequence, kv head): the flash-decoding
// combine m = max m_s, l = sum l_s e^(m_s - m), acc = sum acc_s e^(m_s - m).
template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part, T* __restrict__ out, int H,
             int KH, int D, int n_split) {
  const int kh = blockIdx.x, b = blockIdx.y, G = H / KH;
  const float* base = part + ((long)b * KH + kh) * n_split * G * (D + 2);
  const long q_base = ((long)b * H + (long)kh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float m = kNegInf;
    for (int s = 0; s < n_split; ++s)
      m = fmaxf(m, base[(s * G + g) * (D + 2) + D]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* st = base + (s * G + g) * (D + 2);
      const float w = expf(st[D] - m);
      l += st[D + 1] * w;
      acc += st[d] * w;
    }
    store(&out[q_base + i], acc / fmaxf(l, 1e-37f));
  }
}

size_t smem_bytes(int G, int D, int rows) {
  return sizeof(float) * ((size_t)2 * G * D + (size_t)rows * (2 * D + 1) +
                          (size_t)G * rows + 3 * (size_t)G) +
         sizeof(int) * (size_t)rows;
}

template <typename T, bool VEC>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* lengths, void* out, int B, int H, int KH, int D,
           int bs, int P, float scale, int n_split_req, float* part,
           cudaStream_t stream) {
  const int G = H / KH;
  // pages per step: up to one K row per thread, within the budget
  int rows_cap = kThreads;
  while (rows_cap > bs && smem_bytes(G, D, rows_cap) > kSmemBudget)
    rows_cap /= 2;
  const int ppc = rows_cap >= bs ? rows_cap / bs : 1;
  const size_t smem = smem_bytes(G, D, ppc * bs);
  auto kern = paged_attention_kernel<T, VEC>;
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  // steps of a full table, shared out over at most n_split_req blocks
  const int steps = (P + ppc - 1) / ppc;
  const int cps = (steps + n_split_req - 1) / n_split_req;
  const int n_split = (steps + cps - 1) / cps;
  dim3 grid(KH, B, n_split);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, static_cast<T*>(out), H, KH,
      D, bs, P, ppc, cps, part, scale);
  if (n_split > 1)
    merge_kernel<T><<<dim3(KH, B), kThreads, 0, stream>>>(
        part, static_cast<T*>(out), H, KH, D, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, H, D); k, v: (N, bs, KH, D) pages; out: (B, H, D), all of one
// dtype (0: float32, 1: bfloat16) and contiguous; tables: (B, P) int32
// page ids in [0, N); lengths: (B,) int32 last valid position (inclusive).
// H must be a multiple of KH.  Each sequence's pages are split over at most
// ``n_split`` blocks; ``part`` is float32 scratch of B * KH * n_split *
// (H / KH) * (D + 2) elements (unused, and may be null, when n_split is 1).
// Returns cudaGetLastError() after the launches.
int paged_attention_launch(const void* q, const void* k, const void* v,
                           const void* tables, const void* lengths,
                           void* out, int B, int H, int KH, int D, int bs,
                           int P, float scale, int dtype, int n_split,
                           void* part, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || bs <= 0 || P <= 0 ||
      n_split <= 0 || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* T = static_cast<const int*>(tables);
  const int* L = static_cast<const int*>(lengths);
  float* W = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t esize = dtype == 1 ? 2 : 4;
  const bool vec = (D * esize) % 16 == 0 &&
                   ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, true>(q, k, v, T, L, out, B, H, KH, D,
                                             bs, P, scale, n_split, W, s)
               : launch<__nv_bfloat16, false>(q, k, v, T, L, out, B, H, KH,
                                              D, bs, P, scale, n_split, W, s);
  }
  if (dtype == 0) {
    return vec ? launch<float, true>(q, k, v, T, L, out, B, H, KH, D, bs, P,
                                     scale, n_split, W, s)
               : launch<float, false>(q, k, v, T, L, out, B, H, KH, D, bs, P,
                                      scale, n_split, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
