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
//   online softmax over the positions: m, l, acc carried along,
//   masked scores are -0.7 * FLT_MAX and contribute exactly 0;
//   out     = acc / max(l, 1e-37)                        (in q's dtype)
//
// The state variant (``paged_attention_state_launch``, the reference's
// ``return_state=True``, K2s) runs the same walk and merge and skips the
// division: it writes the raw flash-decoding state (acc, m, l) in float32,
// acc (B, KH, G, D) unnormalized and m, l (B, KH, G, 1).  Shards of a
// split-KV mesh each run it over their slice of the table and merge the
// states (``distributed/sharding.py::combine_softmax_state``).  A far
// shard's rebased length is negative, so all its positions are masked: every
// split walks nothing and holds the neutral state (acc 0, m -0.7 FLT_MAX,
// l 0); each merge of neutral states weighs them by exp(0) = 1, so the
// written state is exactly neutral, finite, and nothing divides by l.
//
// with page(t) = tables[b, t / bs].  Unused table entries point at page 0,
// the pool's trash page; only positions <= lengths[b] are ever read.
//
// Differences from the TPU kernel, and why:
//   * The TPU grid walks the pages as its innermost, sequential grid axis
//     and carries (m, l, acc) in VMEM scratch.  Blocks on the card run in
//     no order and a decode batch is a few sequences, so the positions of
//     one (sequence, kv head) are split over ``n_split`` blocks (a third
//     grid axis), each walking its own run of ``rows_per_split`` positions;
//     the host plans the split from shapes only (``ops.split_plan``).  The
//     last block to finish a (sequence, kv head, query group) merges the
//     splits' (acc, m, l) as flash decoding does (the reference's mesh path
//     merges shards the same way, ``sharding.combine_softmax_state``): an
//     int32 arrival counter, which that block resets to zero, picks it, so
//     there is no second launch and no memset.  With one split the block
//     writes the output itself.
//   * The TPU kernel visits every table entry.  This one stops after
//     position lengths[b]: a later position is masked, and in the reference
//     it leaves the state unchanged (every exp is 0, corr = 1), so skipping
//     it is exact; a split whose positions all lie past it contributes the
//     neutral state (m = -0.7 FLT_MAX, l = 0, acc = 0).  Every m stays
//     finite (at least -0.7 FLT_MAX), so no exp sees inf - inf; a length-0
//     slot whose table is all trash gives finite output, and so does a
//     negative length (all masked: 0 / max(0, 1e-37) = 0).
//   * A block reads its own table entries (no scalar prefetch): once, for
//     its run of pages, into shared memory, while it reads the length.
//   * More than 8 query rows per kv head (G > 8) are taken in groups of at
//     most 8, one group per block (K/V is read once per group).
//
// What bounds it on the card: decode attention does ~2 flops per K/V byte
// (times G), far below the H100's ~295 flops per byte, so it is bound by
// the bytes of the valid K and V rows over HBM (268 MB, ~80 us, for 32
// sequences of 8192 positions at qwen2-1.5b's 2 kv heads of 128 in bf16);
// at a serve's few hundred positions, by the latency of the launch and of
// two dependent reads (the table, then the rows).  What held the first
// design back was latency: float32 staging that left one block per SM,
// four barriers per step, and serial per-row loops.  This design:
//   * K/V stay in their own dtype in shared memory and are widened at the
//     point of use.  A stage is 128 rows of K and 128 of V (68 KB in bf16
//     at D 128, rows padded by 16 bytes); a ring of up to 3 stages (as many
//     as the split has) is filled by 1D bulk copies (TMA,
//     ``cp.async.bulk``), one 256-byte row per lane, completing on an
//     mbarrier, so two stages load while one is computed.  One block of 8
//     warps fills an SM (two blocks of 4 warps with the same ring per SM
//     measured no faster).
//   * Warps own rows: each of the 8 warps copies, waits on and reads only
//     its own 16 rows of each stage, with one mbarrier per (slot, warp), so
//     the walk has no block barrier.  Each warp keeps its own online-softmax
//     state and its own acc in registers; the warps' states merge through
//     shared memory once, at the end of the block's walk.
//   * bf16 at D 64 or 128 (the models' heads) takes the tensor cores:
//     ``mma.sync.m16n8k16`` with the warp's 16 rows on the M side and the
//     group's 8 (padded) query rows on N, q.k as S^T = K Q^T and p.v as
//     O^T += V^T P^T, rows read with ``ldmatrix`` (``.trans`` for V).  P is
//     fed as bf16 hi + lo parts, so p.v keeps ~16 bits of each probability
//     and the float32 result stays within summation noise of the plain
//     version.  Per 16 rows that is 24 MMAs in place of the CUDA cores'
//     hundreds of FMAs and shuffles per row, which bound the walk by
//     instruction issue; it now waits on its copies alone.
//   * float32 pages, and bf16 rows the tensor-core walk does not take, use
//     the CUDA cores: a row is 16-byte chunks across the lanes, q's rows in
//     registers, and the lanes' partial dots of all query rows summed by
//     one reduce-scatter (31 shuffles for 8 query rows over 32 lanes, not
//     5 per row).  No model of the repo runs this walk on its main path;
//     it is built once per dtype.
//   * The split's merge (last block) loads every split's (m, l) in one
//     pass and sixteen splits' accs per thread at a time.

// Interface: plain C, loaded with ctypes.  ``paged_attention_launch``
// returns cudaGetLastError() after the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// K/V rows a warp takes per stage, and a stage's rows
constexpr int kRowsPerWarp = 16;
constexpr int kStageRows = kWarps * kRowsPerWarp;
// ring depth: stages in shared memory at once, at most (fewer where the
// split has fewer stages or the rows are too wide for the budget)
constexpr int kStages = 3;
// dynamic shared memory one block may take (of the 227 KB a Hopper block
// can have, less its static shared memory)
constexpr int kSmemBudget = 226 * 1024;
// query rows one block takes (G is split into groups of at most this many)
constexpr int kMaxG = 8;
// padded row bytes the kernel takes: 16-byte chunks over at most 32 lanes
constexpr int kMaxRowBytes = 512;
// most splits of one sequence (their merge weights sit in shared memory)
constexpr int kMaxSplits = 128;
// per-warp scratch: scores and rescale factors, or the bf16 P^T tiles
constexpr int kWarpBufFloats = (kRowsPerWarp + 1) * kMaxG;
// -0.7 * FLT_MAX, the reference's NEG_INF
constexpr float kNegInf = -0.7f * 3.402823466e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// 16 bytes of a row, widened to float32
__device__ __forceinline__ void widen(const uint4& u, float (&f)[4],
                                      const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8],
                                      const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// mbarrier and 1D bulk-copy (TMA) helpers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// generic-proxy accesses of shared memory before async-proxy ones
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the TMA unit, completing on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&a)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}
// c += a (16 x 16, bf16, row) * b (16 x 8, bf16, col), float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Reduce-scatter of NV per-lane values over aligned groups of lanes (lane
// offsets O, O / 2, .., 1): while more than one value is left, a lane keeps
// one half and sends the other half to its partner; then the last value is
// summed over the remaining offsets.  On return v[0] holds, for value index
// ``idx``, the sum over the group.
template <int NV, int O>
struct GroupReduce {
  __device__ __forceinline__ static void run(float* v, int lane, int& idx) {
    if constexpr (O == 0) {
      return;
    } else if constexpr (NV > 1) {
      constexpr int H = NV / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      if (up) idx += H;
      GroupReduce<H, O / 2>::run(v, lane, idx);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      GroupReduce<1, O / 2>::run(v, lane, idx);
    }
  }
};

// A warp's walk on the CUDA cores (float32, or bf16 rows that the tensor
// core walk does not take): a row is 16-byte chunks across the warp's
// lanes, each lane holds the group's query rows for its chunk (pre-scaled)
// and their acc; each query row's online-softmax state sits in the lanes
// with lane % GT == row.
template <typename T>
struct CoreWalk {
  static constexpr int LPR = 32;      // lanes per row (rows up to 32 chunks)
  static constexpr int GT = kMaxG;
  static constexpr int E = 16 / sizeof(T);
  static constexpr int RPW = 32 / LPR;

  float qr[GT][E];
  float acc[GT][E];
  float m_d = kNegInf, l_d = 0.f;
  int lane, c;

  __device__ __forceinline__ void init(const T* __restrict__ q, long q_base,
                                       int gs, int D, int cpr, float scale) {
    lane = threadIdx.x & 31;
    c = lane % LPR;
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = c * E + e;
        qr[g][e] = (g < gs && c < cpr && d < D)
                       ? to_f32(q[q_base + (long)g * D + d]) * scale
                       : 0.f;
        acc[g][e] = 0.f;
      }
  }

  // the warp's rows r0 .. r0 + 15 of one stage, nv of them valid
  __device__ __forceinline__ void stage(const char* k_st, const char* v_st,
                                        int stride, int cpr, int r0, int nv,
                                        float, float* buf) {
    float* sc = buf;                          // (16, GT) scores, then p
    float* corr_s = buf + kRowsPerWarp * GT;  // (GT,) rescale factors
    const int sub = lane / LPR;
    for (int i = 0; i < nv; i += RPW) {
      const int r = i + sub;
      float part[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) part[g] = 0.f;
      if (c < cpr) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            k_st + (r0 + r) * stride + c * 16);
        float kf[E];
        widen(u, kf, static_cast<const T*>(nullptr));
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) part[g] = fmaf(qr[g][e], kf[e], part[g]);
      }
      int g_own = 0;
      GroupReduce<GT, LPR / 2>::run(part, lane, g_own);
      if ((lane & (LPR / GT - 1)) == 0) sc[r * GT + g_own] = part[0];
    }
    __syncwarp();

    // online softmax over the rows, query row g = lane % GT
    const int g = lane % GT;
    float cm = kNegInf;
    for (int idx = lane; idx < kRowsPerWarp * GT; idx += 32)
      if (idx / GT < nv) cm = fmaxf(cm, sc[idx]);
#pragma unroll
    for (int o = GT; o < 32; o <<= 1)
      cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, o));
    const float m_new = fmaxf(m_d, cm);
    float sum = 0.f;
    for (int idx = lane; idx < kRowsPerWarp * GT; idx += 32) {
      const float p = idx / GT < nv ? expf(sc[idx] - m_new) : 0.f;
      sc[idx] = p;
      sum += p;
    }
#pragma unroll
    for (int o = GT; o < 32; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
    const float corr = expf(m_d - m_new);
    l_d = l_d * corr + sum;
    m_d = m_new;
    if (lane < GT) corr_s[g] = corr;
    __syncwarp();

    // acc = acc * corr + p @ V, lanes over D
#pragma unroll
    for (int gg = 0; gg < GT; ++gg) {
      const float cg = corr_s[gg];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gg][e] *= cg;
    }
    for (int i = 0; i < nv; i += RPW) {
      const int r = i + sub;
      if (c < cpr) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            v_st + (r0 + r) * stride + c * 16);
        float vf[E];
        widen(u, vf, static_cast<const T*>(nullptr));
        float p[GT];
#pragma unroll
        for (int gg = 0; gg < GT; ++gg) p[gg] = sc[r * GT + gg];
#pragma unroll
        for (int gg = 0; gg < GT; ++gg)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[gg][e] = fmaf(p[gg], vf[e], acc[gg][e]);
      }
    }
    __syncwarp();   // the buffer is rewritten by the next stage
  }

  // the warp's (acc, m, l) into st (GT rows of sst floats: acc, m, l)
  __device__ __forceinline__ void store_state(float* st, int cpr, int sst,
                                              int dp) {
    // lanes that hold the same chunk took different rows
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], o);
    if (lane < LPR && c < cpr) {
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) st[g * sst + c * E + e] = acc[g][e];
    }
    if (lane < GT) {
      st[lane * sst + dp] = m_d;
      st[lane * sst + dp + 1] = l_d;
    }
  }
};

// A warp's walk on the tensor cores (bf16, head dim HD, a multiple of 16):
// ``mma.sync.m16n8k16`` with the warp's 16 K/V rows on the M side and the
// group's 8 (padded) query rows on the N side.  q.k: S^T (16 rows x 8) =
// K (16 x D) Q^T; p.v: O^T (D x 8) += V^T (D x 16 rows) P^T.  The rows are
// read with ``ldmatrix`` (``.trans`` for V^T) from the ring, whose rows are
// padded by 16 bytes so the eight rows of a read fall in distinct banks.
// P is split
// into bf16 hi + lo parts (two MMAs), so p.v keeps ~16 bits of each
// probability and the result stays within float32 summation noise of the
// CUDA-core walk.  Lane l holds query rows 2 (l % 4) and 2 (l % 4) + 1 of
// both S^T and O^T, and their (m, l).
template <int HD>
struct MmaWalk {
  static constexpr int D = HD;
  static constexpr int KS = D / 16;   // k-steps of q.k, m-tiles of p.v
  static constexpr int GT = kMaxG;
  static_assert(D % 16 == 0, "");

  unsigned qb[KS][2];   // B fragments of Q^T (unscaled bf16 pairs)
  float acc[KS][4];     // C fragments of O^T
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int lane;

  __device__ __forceinline__ void init(const __nv_bfloat16* __restrict__ q,
                                       long q_base, int gs, int, int,
                                       float) {
    lane = threadIdx.x & 31;
    const int g = lane >> 2, k2 = (lane & 3) * 2;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        qb[ks][h] = g < gs ? *reinterpret_cast<const unsigned*>(
                                 q + q_base + (long)g * D + 16 * ks + 8 * h +
                                 k2)
                           : 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ks][e] = 0.f;
    }
  }

  __device__ __forceinline__ void stage(const char* k_st, const char* v_st,
                                        int stride, int, int r0, int nv,
                                        float scale, float* buf) {
    // S^T = K Q^T over the warp's 16 rows
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    // the K row whose address this lane gives ldmatrix
    const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int ch = 2 * ks + (lane >> 4);
      unsigned a[4];
      ldsm_x4(a, k_st + (r0 + kr) * stride + (ch << 4));
      mma_bf16(s, a, qb[ks][0], qb[ks][1]);
    }
    // online softmax: lane holds rows j0, j0 + 8 of query rows g0, g0 + 1
    const int j0 = lane >> 2;
    const bool ok0 = j0 < nv, ok1 = j0 + 8 < nv;
    float p[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x0 = ok0 ? s[h] * scale : kNegInf;
      const float x1 = ok1 ? s[2 + h] * scale : kNegInf;
      float cm = fmaxf(x0, x1);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, o));
      const float mn = fmaxf(m[h], cm);
      p[h] = ok0 ? expf(x0 - mn) : 0.f;
      p[2 + h] = ok1 ? expf(x1 - mn) : 0.f;
      float sum = p[h] + p[2 + h];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
      const float corr = expf(m[h] - mn);
      l[h] = l[h] * corr + sum;
      m[h] = mn;
#pragma unroll
      for (int mt = 0; mt < KS; ++mt) {
        acc[mt][h] *= corr;
        acc[mt][2 + h] *= corr;
      }
    }
    // P^T (8 x 16) through the warp's buffer, as bf16 hi and lo parts
    __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(buf);
    __nv_bfloat16* pl = ph + GT * kRowsPerWarp;
    const int g0 = (lane & 3) * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = (g0 + (e & 1)) * kRowsPerWarp + j0 + (e >> 1) * 8;
      const __nv_bfloat16 hi = __float2bfloat16(p[e]);
      ph[idx] = hi;
      pl[idx] = __float2bfloat16(p[e] - __bfloat162float(hi));
    }
    __syncwarp();
    const int bq = (lane >> 2) * kRowsPerWarp + (lane & 3) * 2;
    const unsigned bh0 = *reinterpret_cast<const unsigned*>(ph + bq);
    const unsigned bh1 = *reinterpret_cast<const unsigned*>(ph + bq + 8);
    const unsigned bl0 = *reinterpret_cast<const unsigned*>(pl + bq);
    const unsigned bl1 = *reinterpret_cast<const unsigned*>(pl + bq + 8);
    // O^T += V^T P^T
    // the V row whose address this lane gives ldmatrix
    const int vr = (lane & 7) + (lane >> 4) * 8;
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      const int ch = 2 * mt + ((lane >> 3) & 1);
      unsigned a[4];
      ldsm_x4_trans(a, v_st + (r0 + vr) * stride + (ch << 4));
      mma_bf16(acc[mt], a, bh0, bh1);
      mma_bf16(acc[mt], a, bl0, bl1);
    }
    __syncwarp();   // the buffer is rewritten by the next stage
  }

  __device__ __forceinline__ void store_state(float* st, int, int sst,
                                              int dp) {
    const int g0 = (lane & 3) * 2, dr = lane >> 2;
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[(g0 + (e & 1)) * sst + 16 * mt + dr + (e >> 1) * 8] = acc[mt][e];
    if (lane < 4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        st[(g0 + h) * sst + dp] = m[h];
        st[(g0 + h) * sst + dp + 1] = l[h];
      }
    }
  }
};

// A ring row's bytes in shared memory: the row padded by 16 bytes, so the
// same 16-byte chunk of eight consecutive rows falls in distinct banks.
__host__ __device__ inline int ring_stride(int row_bytes) {
  return row_bytes + 16;
}
// Shared memory of one block: the ring of ``slots`` stages; its first
// bytes later hold the warps' final states and the splits' (m, l), so it
// is at least as large as those; then the per-warp buffers and the table
// entries of its run of pages.
__host__ __device__ inline int ring_bytes(int row_bytes, int slots,
                                          int n_split) {
  const int ring = slots * kStageRows * ring_stride(row_bytes) * 2;
  // (kWarps, kMaxG) states of up to row_bytes / 2 + 2 floats, and weights
  const int states = (int)sizeof(float) *
                     (kWarps * kMaxG * (row_bytes / 2 + 2) +
                      (kWarps + 2) * kMaxG);
  const int merge = (int)sizeof(float) * (2 * n_split + 1) * kMaxG;
  const int scratch = states > merge ? states : merge;
  return ring > scratch ? ring : scratch;
}
size_t smem_bytes(int row_bytes, int slots, int n_split, int tbl_cap) {
  return (size_t)ring_bytes(row_bytes, slots, n_split) +
         sizeof(float) * (size_t)kWarps * kWarpBufFloats +
         sizeof(int) * (size_t)tbl_cap;
}

// One warp's part of a ring slot: the K and V rows r0 .. r0 + 15 of the
// stage whose row 0 is position t0 (kv head offset ``head``), ``stride``
// bytes apart.  vec: one bulk copy per row and lane (lanes 0-15 K, 16-31
// V), completing on ``bar``; a row at or past ``t_hi`` is filled from
// position ``t_any`` (valid) instead, so it holds finite values whose
// probability is 0.  Otherwise element by element, rows past ``t_hi`` zero.
template <typename T>
__device__ __forceinline__ void issue_rows(
    const T* __restrict__ kp, const T* __restrict__ vp, const int* tbl_s,
    int pg_lo, int t0, int r0, int t_hi, int t_any, int bs, int bs_shift,
    long page_stride, long row_stride, long head, int D, int row_bytes,
    int stride, bool vec, char* k_dst, char* v_dst, uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    fence_proxy_async();   // the slot's last reads were generic ones
    if (lane == 0) mbar_arrive_expect_tx(bar, 2 * kRowsPerWarp * row_bytes);
    __syncwarp();
    const int r = r0 + (lane & (kRowsPerWarp - 1));
    int t = t0 + r;
    if (t >= t_hi) t = t_any;
    const int pg = bs_shift >= 0 ? t >> bs_shift : t / bs;
    const long off = (long)tbl_s[pg - pg_lo] * page_stride +
                     (t - pg * bs) * row_stride + head;
    const bool is_k = lane < kRowsPerWarp;
    bulk_copy((is_k ? k_dst : v_dst) + r * stride, (is_k ? kp : vp) + off,
              row_bytes, bar);
  } else {
    const int epr = stride / (int)sizeof(T);   // elements per ring row
    T* kd = reinterpret_cast<T*>(k_dst);
    T* vd = reinterpret_cast<T*>(v_dst);
    for (int i = lane; i < kRowsPerWarp * epr; i += 32) {
      const int r = r0 + i / epr, e = i % epr;
      const int t = t0 + r;
      T kv = T(0.f), vv = T(0.f);
      if (t < t_hi && e < D) {
        const int pg = t / bs;
        const long off = (long)tbl_s[pg - pg_lo] * page_stride +
                         (t - pg * bs) * row_stride + head + e;
        kv = kp[off];
        vv = vp[off];
      }
      kd[r * epr + e] = kv;
      vd[r * epr + e] = vv;
    }
  }
}

// grid (KH * n_groups, B, n_split), kThreads threads, dynamic shared memory
// as ``smem_bytes`` computes.  Query group gi of kv head kh covers query
// rows kh * G + gi * GS .. + min(GS, G - gi * GS) - 1.  Split ``z`` walks
// positions [z * rps, (z + 1) * rps).  With n_split > 1 each block writes
// its (acc, m, l) to ``part`` and the last to arrive merges; ``cnt`` (one
// int32 per (b, kh, group)) is zero on entry and left zero.  ``part`` holds
// the accs, (walks, n_split, GS, dp4) with dp4 = D rounded up to 4, then
// the (m, l) pairs, (walks, n_split, GS, 2).
template <typename T, class Walk>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       float* __restrict__ st_acc, float* __restrict__ st_m,
                       float* __restrict__ st_l, int H, int KH, int D, int bs,
                       int bs_shift, int P, int GS, int rps, int slots,
                       int vec, float* __restrict__ part,
                       int* __restrict__ cnt, float scale) {
  constexpr int GT = Walk::GT;
  const int n_groups = gridDim.x / KH;
  const int kh = blockIdx.x / n_groups, gi = blockIdx.x - kh * n_groups;
  const int b = blockIdx.y;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int G = H / KH;
  const int gs = min(GS, G - gi * GS);       // query rows of this group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_bytes = ((D * (int)sizeof(T) + 15) / 16) * 16;
  const int cpr = row_bytes / 16;
  const int dp = row_bytes / (int)sizeof(T);   // padded head dim
  const int sst = dp + 2;
  const long walks = (long)gridDim.x * gridDim.y;
  const long bkg = ((long)b * KH + kh) * n_groups + gi;
  // the state variant writes (acc, m, l) in place of out
  const bool state = st_acc != nullptr;

  extern __shared__ __align__(128) char smem[];
  __shared__ int is_last;
  // one barrier per (ring slot, warp): the warp's copies into the slot
  __shared__ __align__(8) uint64_t bars[kStages * kWarps];
  const int stride = ring_stride(row_bytes);
  const int stage_bytes = kStageRows * stride * 2;
  float* bufs =
      reinterpret_cast<float*>(smem + ring_bytes(row_bytes, slots, n_split));
  int* tbl_s = reinterpret_cast<int*>(bufs + kWarps * kWarpBufFloats);

  const long row0 = (long)b * H + (long)kh * G + gi * GS;  // query row
  const long q_base = row0 * D;
  Walk walk;
  walk.init(q, q_base, gs, D, cpr, scale);

  // the table entries of this split's positions, read while the length is
  // (so the two loads do not wait on each other)
  const int t_begin = split * rps;
  const int pg_lo = t_begin / bs;
  const int n_pg = min(P - 1, (t_begin + rps - 1) / bs) - pg_lo + 1;
  for (int j = tid; j < n_pg; j += kThreads)
    tbl_s[j] = tables[(long)b * P + pg_lo + j];
  if (tid < kStages * kWarps) mbar_init(&bars[tid], 1);
  mbar_init_fence();
  const int len = lengths[b];
  const int total = len < 0 ? 0 : min(P * bs, len + 1);
  const int t_hi = min(total, t_begin + rps);
  const int n_st =
      t_hi > t_begin ? (t_hi - t_begin + kStageRows - 1) / kStageRows : 0;
  __syncthreads();

  const long row_stride = (long)KH * D;
  const long page_stride = (long)bs * row_stride;
  const long head = (long)kh * D;
  // each warp fills and reads only its own 16 rows of every ring slot, so
  // a warp waits on its own copies alone: no block barrier in the walk.  A
  // warp with no valid row in a stage (the split's last only) neither
  // copies nor waits there.
  const int r0 = warp * kRowsPerWarp;
  auto warp_rows = [&](int s) {
    return min(kRowsPerWarp,
               max(0, t_hi - (t_begin + s * kStageRows + r0)));
  };
  auto issue = [&](int s) {
    if (warp_rows(s) == 0) return;
    char* k_dst = smem + (s % slots) * stage_bytes;
    issue_rows<T>(kp, vp, tbl_s, pg_lo, t_begin + s * kStageRows, r0, t_hi,
                  t_begin, bs, bs_shift, page_stride, row_stride, head, D,
                  row_bytes, stride, vec != 0, k_dst,
                  k_dst + kStageRows * stride,
                  &bars[(s % slots) * kWarps + warp]);
  };
  for (int s = 0; s < slots - 1 && s < n_st; ++s) issue(s);
  for (int s = 0; s < n_st; ++s) {
    // into the slot of stage s - 1, which this warp has finished reading
    if (s + slots - 1 < n_st) issue(s + slots - 1);
    const int nv = warp_rows(s);
    if (nv == 0) continue;      // warp-uniform
    if (vec)
      mbar_wait(&bars[(s % slots) * kWarps + warp], (s / slots) & 1);
    else
      __syncwarp();
    const char* k_st = smem + (s % slots) * stage_bytes;
    walk.stage(k_st, k_st + kStageRows * stride, stride, cpr, r0, nv, scale,
               bufs + warp * kWarpBufFloats);
  }

  // merge the warps' states through shared memory (reusing the ring: every
  // copy has landed)
  __syncthreads();
  float* st = reinterpret_cast<float*>(smem);   // (kWarps, GT, sst)
  walk.store_state(st + warp * GT * sst, cpr, sst, dp);
  __syncthreads();
  float* wts = st + kWarps * GT * sst;   // (kWarps, GT) weights, M, L
  float* L = wts + (kWarps + 1) * GT;
  if (tid < GT) {
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m = fmaxf(m, st[(w * GT + tid) * sst + dp]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(st[(w * GT + tid) * sst + dp] - m);
      wts[w * GT + tid] = f;
      l += st[(w * GT + tid) * sst + dp + 1] * f;
    }
    wts[kWarps * GT + tid] = m;
    L[tid] = l;
  }
  __syncthreads();

  const int dp4 = (D + 3) & ~3;
  const long walk_part = (bkg * n_split + split) * GS;
  float* part_acc = part + walk_part * dp4;
  float* part_ml = part + walks * n_split * GS * dp4 + walk_part * 2;
  for (int i = tid; i < gs * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a += wts[w * GT + g] * st[(w * GT + g) * sst + d];
    if (n_split > 1)
      part_acc[g * dp4 + d] = a;
    else if (state)
      st_acc[q_base + i] = a;
    else
      store(&out[q_base + i], a / fmaxf(L[g], 1e-37f));
  }
  if (n_split == 1) {
    if (state && tid < gs) {
      st_m[row0 + tid] = wts[kWarps * GT + tid];
      st_l[row0 + tid] = L[tid];
    }
    return;
  }
  if (tid < gs) {
    part_ml[2 * tid] = wts[kWarps * GT + tid];
    part_ml[2 * tid + 1] = L[tid];
  }

  // the last split to finish merges all splits' states
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&cnt[bkg], 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // every split's (m, l) of this group in one pass, then each query row's
  // split weights e^(m_z - M) and L in shared memory (reusing the ring)
  float* ml_s = reinterpret_cast<float*>(smem);   // (n_split, GT) (m, l)
  float* Lz = ml_s + 2 * n_split * GT;            // (GT,)
  const float2* ml = reinterpret_cast<const float2*>(
                         part + walks * n_split * GS * dp4) +
                     bkg * n_split * GS;
  for (int i = tid; i < n_split * gs; i += kThreads) {
    const int z = i / gs, g = i - z * gs;
    const float2 v = __ldcg(ml + z * GS + g);
    ml_s[2 * (z * GT + g)] = v.x;
    ml_s[2 * (z * GT + g) + 1] = v.y;
  }
  __syncthreads();
  for (int g = warp; g < gs; g += kWarps) {
    float m = kNegInf;
    for (int z = lane; z < n_split; z += 32)
      m = fmaxf(m, ml_s[2 * (z * GT + g)]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float l = 0.f;
    for (int z = lane; z < n_split; z += 32) {
      const float f = expf(ml_s[2 * (z * GT + g)] - m);
      ml_s[2 * (z * GT + g)] = f;   // the weight replaces m
      l += ml_s[2 * (z * GT + g) + 1] * f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
    if (lane == 0) {
      Lz[g] = l;
      if (state) {
        st_m[row0 + g] = m;
        st_l[row0 + g] = l;
      }
    }
  }
  __syncthreads();
  const float4* acc_all =
      reinterpret_cast<const float4*>(part + bkg * n_split * GS * dp4);
  const int d4n = dp4 / 4;
  for (int i = tid; i < gs * d4n; i += kThreads) {
    const int g = i / d4n, d4 = i - g * d4n;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    // sixteen splits' loads in flight at a time
    for (int z0 = 0; z0 < n_split; z0 += 16) {
      float4 v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = z0 + j < n_split
                   ? __ldcg(acc_all + ((z0 + j) * GS + g) * d4n + d4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float f = z0 + j < n_split ? ml_s[2 * ((z0 + j) * GT + g)] : 0.f;
        a.x += f * v[j].x;
        a.y += f * v[j].y;
        a.z += f * v[j].z;
        a.w += f * v[j].w;
      }
    }
    const float l = fmaxf(Lz[g], 1e-37f);
    const float r[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * d4 + e;
      if (d >= D) continue;
      if (state)
        st_acc[q_base + (long)g * D + d] = r[e];
      else
        store(&out[q_base + (long)g * D + d], r[e] / l);
    }
  }
  if (tid == 0) cnt[bkg] = 0;
}

template <typename T, class Walk>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* lengths, void* out, float* st_acc, float* st_m,
           float* st_l, int B, int H, int KH, int D,
           int bs, int P, int n_groups, int GS, float scale, int n_split,
           int rps, int vec, float* part, int* cnt, cudaStream_t stream) {
  const int row_bytes = ((D * (int)sizeof(T) + 15) / 16) * 16;
  const int tbl_cap = (rps + bs - 1) / bs + 1;
  // as many ring slots as the split has stages, at most kStages, fewer
  // where wide rows (float32 at D 128) outgrow the budget
  int slots = rps / kStageRows < kStages ? rps / kStageRows : kStages;
  while (slots > 1 &&
         smem_bytes(row_bytes, slots, n_split, tbl_cap) > kSmemBudget)
    --slots;
  const size_t smem = smem_bytes(row_bytes, slots, n_split, tbl_cap);
  if (smem > (size_t)kSmemBudget) return (int)cudaErrorInvalidValue;
  auto kern = paged_attention_kernel<T, Walk>;
  // one per instance: the attribute is set on this instance only
  static size_t configured = 48 * 1024 - 1024;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();   // not left pending for the next launch's check
      return (int)e;
    }
    configured = smem;
  }
  int bs_shift = -1;
  for (int i = 0; i < 31; ++i)
    if ((1 << i) == bs) bs_shift = i;
  dim3 grid(KH * n_groups, B, n_split);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, static_cast<T*>(out), st_acc,
      st_m, st_l, H, KH, D, bs, bs_shift, P, GS, rps, slots, vec, part, cnt,
      scale);
  return 0;
}

// the arguments of ``launch`` after its template parameters
#define PA_ARGS                                                            \
  q, k, v, tables, lengths, out, st_acc, st_m, st_l, B, H, KH, D, bs, P, \
      n_groups, GS, scale, n_split, rps, vec, part, cnt, s

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* tables,
             const int* lengths, void* out, float* st_acc, float* st_m,
             float* st_l, int B, int H, int KH, int D,
             int bs, int P, int n_groups, int GS, float scale, int n_split,
             int rps, int vec, float* part, int* cnt, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // the tensor-core walk: bf16 rows of 64 or 128 (the models' heads)
    if (vec && D == 128) return launch<T, MmaWalk<128>>(PA_ARGS);
    if (vec && D == 64) return launch<T, MmaWalk<64>>(PA_ARGS);
  }
  // everything else (float32 pages, other bf16 rows) on the CUDA cores,
  // one instance per dtype: a row on up to 32 lanes, up to 8 query rows
  return launch<T, CoreWalk<T>>(PA_ARGS);
}

#undef PA_ARGS

// checks the arguments and launches on ``stream``: the output ``out`` (q's
// dtype), or with ``st_acc`` non-null the state (st_acc, st_m, st_l)
int run(const void* q, const void* k, const void* v, const void* tables,
        const void* lengths, void* out, float* st_acc, float* st_m,
        float* st_l, int B, int H, int KH, int D, int bs, int P, float scale,
        int dtype, int n_groups, int n_split, int rows_per_split, void* part,
        void* cnt, void* stream) {
  const size_t esize = dtype == 1 ? 2 : 4;
  if (B <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || bs <= 0 || P <= 0 ||
      (dtype != 0 && dtype != 1) || D * esize > (size_t)kMaxRowBytes ||
      n_groups <= 0 || n_split <= 0 || n_split > kMaxSplits ||
      rows_per_split <= 0 || rows_per_split % kStageRows != 0 ||
      (long)n_split * rows_per_split < (long)P * bs ||
      (n_split > 1 && (part == nullptr || cnt == nullptr)) ||
      (st_acc == nullptr ? out == nullptr
                         : (st_m == nullptr || st_l == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  const int GS = (G + n_groups - 1) / n_groups;
  if (GS > kMaxG || (n_groups - 1) * GS >= G) return (int)cudaErrorInvalidValue;
  const int* tables_i = static_cast<const int*>(tables);
  const int* lengths_i = static_cast<const int*>(lengths);
  float* part_f = static_cast<float*>(part);
  int* cnt_i = static_cast<int*>(cnt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = (D * esize) % 16 == 0 &&
                  ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const int rc =
      dtype == 1
          ? dispatch<__nv_bfloat16>(q, k, v, tables_i, lengths_i, out,
                                    st_acc, st_m, st_l, B, H, KH, D, bs, P,
                                    n_groups, GS, scale, n_split,
                                    rows_per_split, vec, part_f, cnt_i, s)
          : dispatch<float>(q, k, v, tables_i, lengths_i, out, st_acc, st_m,
                            st_l, B, H, KH, D, bs, P, n_groups, GS, scale,
                            n_split, rows_per_split, vec, part_f, cnt_i, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, H, D); k, v: (N, bs, KH, D) pages; out: (B, H, D), all of one
// dtype (0: float32, 1: bfloat16) and contiguous; tables: (B, P) int32
// page ids in [0, N); lengths: (B,) int32 last valid position (inclusive).
// H must be a multiple of KH, and D * (dtype size) at most 512 bytes.  The
// G = H / KH query rows of a kv head are taken in ``n_groups`` groups of
// GS = ceil(G / n_groups) <= 8 rows.  Each sequence's positions are split
// over ``n_split`` <= 128 blocks of ``rows_per_split`` positions each (a
// multiple of 128, with n_split * rows_per_split >= P * bs).  With n_split >
// 1, ``part`` is float32 scratch of B * KH * n_groups * n_split * GS *
// (round_up(D, 4) + 2) elements and ``cnt`` int32 scratch of B * KH *
// n_groups elements, zero on entry and left zero; otherwise both may be
// null.  Returns cudaGetLastError() after the launch.
int paged_attention_launch(const void* q, const void* k, const void* v,
                           const void* tables, const void* lengths,
                           void* out, int B, int H, int KH, int D, int bs,
                           int P, float scale, int dtype, int n_groups,
                           int n_split, int rows_per_split, void* part,
                           void* cnt, void* stream) {
  return run(q, k, v, tables, lengths, out, nullptr, nullptr, nullptr, B, H,
             KH, D, bs, P, scale, dtype, n_groups, n_split, rows_per_split,
             part, cnt, stream);
}

// The state variant: the arguments of ``paged_attention_launch`` with the
// output replaced by three contiguous float32 ones, acc (B, H, D) (the
// reference's (B, KH, G, D)) and m, l (B, H) (its (B, KH, G, 1)).
int paged_attention_state_launch(const void* q, const void* k,
                                 const void* v, const void* tables,
                                 const void* lengths, void* acc, void* m,
                                 void* l, int B, int H, int KH, int D,
                                 int bs, int P, float scale, int dtype,
                                 int n_groups, int n_split,
                                 int rows_per_split, void* part, void* cnt,
                                 void* stream) {
  return run(q, k, v, tables, lengths, nullptr, static_cast<float*>(acc),
             static_cast<float*>(m), static_cast<float*>(l), B, H, KH, D, bs,
             P, scale, dtype, n_groups, n_split, rows_per_split, part, cnt,
             stream);
}

}  // extern "C"
