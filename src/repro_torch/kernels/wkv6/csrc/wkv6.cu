// Chunked RWKV-6 WKV recurrence for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/wkv6/kernel.py::wkv6_kernel  (body ``_kernel``).
// What it computes, per row (one batch x head) with an (N, N) float32 state
// S, chunk by chunk of L steps, lc_i = sum_{s<i} log_w_s per channel and
// lcs_i = lc_{i+1}:
//
//   out_i = (r_i e^{lc_i}) . S_c                       cross-chunk
//         + sum_{j<i} A[i, j] v_j,                     intra-chunk pairs
//             A[i, j] = sum_d r_id k_jd e^{lc_id - lcs_jd}
//         + (r_i . u k_i) v_i                          current-token bonus
//   S_{c+1} = diag(e^{lc_end}) S_c + dS_c,  dS_c = sum_j (k_j e^{lc_end -
//             lcs_j}) v_j^T
//
// r/k/v arrive in float32 or bfloat16 and are upcast; log_w, u, the state
// and both outputs are float32.
//
// What bounds it on this card.  Per row and chunk of L steps it moves L N
// (3 esize + 8) bytes and does ~2.5 L N^2 multiply-adds of small products:
// at the serves' shapes (N 64, L 64, bf16) the work itself is bound by
// bytes (~0.14 TF32 flop per byte).  What keeps a kernel from that bound
// is, first, the one serial part, the state chain S_{c+1} = e^{lc_end} S_c
// + dS_c; everything else (A, A v, the bonus, dS_c) does not depend on the
// carried state.  The first design of this kernel walked every chunk of
// a row inside one block on the CUDA cores.  Second, on this card the
// products' float32 accuracy costs 2-3 TF32 MMAs each, and splitting an
// operand is an emulated cvt.rna.tf32 (several instructions); third, the
// exponentials of the pair terms run on the special-function units (16 a
// clock per SM).
//
// The design: two kernels per call, the chunked linear-attention
// arrangement.  A chain through a thread block cluster's distributed
// shared memory would keep S on chip, but a cluster holds at most 16
// blocks, so a 64-chunk row would still walk runs of chunks serially
// inside each block, and the hand-off through distributed shared memory
// would sit on the chain itself; two kernels leave the chain nothing else
// to do.
//
//   wkv6_state_kernel  a block per (row, column block of S): warps 0 ..
//       NP/16 - 1 keep S in the tensor cores' accumulator registers (16
//       rows each) and per chunk write S_c (transposed) to a float32
//       workspace of R x (T / L) x N x N, scale S by e^{lc_end} and add
//       k_dec^T v with mma.sync; warps 4-7 meanwhile turn the next chunk's
//       k and log_w into k_dec and lc_end.  k and log_w stream through a
//       three-stage cp.async ring two chunks ahead of the producers, v
//       through one two chunks ahead of the MMA warps.
//   wkv6_chunk_kernel  a block per (row, chunk) -- or per half of a
//       chunk's rows where the plan splits them (``split`` 2: sub-chunks
//       {0, 3} and {1, 2}, equal work) -- computes the state-free part of
//       the chunk, then waits for the state kernel (programmatic dependent
//       launch: it is launched while the state kernel runs and blocks in
//       ``griddepcontrol.wait`` only before it reads the workspace), then
//       adds (r e^{lc}) . S_c.
//
// The workspace costs 2 x 4 R T N^2 / L bytes (written and read), 54% more
// than the kernels' own bytes at N = L = 64.
//
// Every product is on the tensor cores (mma.sync.m16n8k8, TF32 in, float32
// sums): r.S, A.v, k_dec^T.v and the off-diagonal 16 x 16 blocks of A.
// TF32 keeps 11 significant bits, so each float32 operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) and a product takes three MMAs (hi hi
// + hi lo + lo hi; lo lo is below 2^-22 of it).  An operand that is a
// bfloat16 input as it came (v) is exact in TF32 and takes no lo part.
// The operands of r.S are split once into shared memory; the others as
// their fragments are loaded.
//
// The pair matrix A is cut into 16-step sub-chunks.  For a row sub-chunk
// ti (first step i0) and an earlier column sub-chunk tj, j < i0:
//     e^{lc_i - lcs_j} = e^{lc_i - lc_i0} e^{lc_i0 - lcs_j}
// and both exponents are <= 0 (lc does not increase and j + 1 <= i0).  So
// a factor that underflows stands for a pair term that is smaller still,
// and nothing overflows: lc falls to about -470 in 64 steps of the
// model's decay, so the TPU kernel's own e^{lc_i} e^{-lcs_j} factoring
// over a whole chunk would.  The first factor is folded into r as each A
// fragment is loaded, the second into k as each B fragment is.  The 16 x
// 16 diagonal blocks are cut into 4 x 4 tiles on the CUDA cores: a tile
// below the diagonal factors the same way at its own corners (three
// factors, each <= 1), a tile on the diagonal takes one exponential per
// pair j < i and channel.  Exponents are clamped at 0: those that are
// exactly 0 (lc_i - lcs_{i-1}) round to a unit in the last place either
// side.
//
// The prefix sums are the plain version's own float32 arithmetic: per
// channel cs_t = cs_{t-1} + w_t in step order (torch.cumsum's order along
// the steps), lc = cs - w, lcs = lc + w, and every exponent a difference
// of those, in natural-log units, scaled by log2(e) for one ex2.  At the
// model's decay range (-exp([-8, 2]) per step) lc reaches hundreds within
// a chunk, and float32 rounding of the prefix alone moves outputs by a
// large share of the float32 gate of 2e-4, so a reordered (segmented,
// parallel) scan missed the gate against the plain version where this one
// shares its rounding.  The chain is 64 dependent
// adds per channel on 64 threads, once per chunk, while the other
// threads upcast the chunk (chunk kernel) or apply the previous chunk
// (state kernel).
//
// The k-step loops of every product stay rolled (each block runs its
// phases once, so unrolled straight-line code would be fetched from the
// instruction cache's slower levels at every instruction).
//
// Interface: plain C, loaded with ctypes.  ``wkv6_launch`` launches both
// kernels and returns the first CUDA error (0 on success); a failed
// attribute or launch is cleared, not left pending.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kThreads = 256;   // both kernels: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;      // the state kernel's input ring
constexpr int kSmemMax = 232448;   // a block's shared memory on sm_90
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// Row strides, in elements.  A fragment read with the row index on the
// lane's group (g = lane / 4) wants a stride of 4 mod 32 words; one read
// with the row index on the lane's thread-in-group (t = lane % 4), as a
// transposed A or a [k][n] B operand is, wants 8 or 24 mod 32.  Staged
// rows (bf16 or float32) are padded by 8 elements for the latter.
__host__ __device__ constexpr int row_a(int np) { return np + 4; }
__host__ __device__ constexpr int row_t(int n) { return n + 8; }

// Shared memory of the state kernel: a ring of kStages stages of raw k and
// log_w ([L][N] each), a ring of kStages stages of this block's value
// columns of v ([L][CB + 8]), two buffers of k_dec ([L][NP + 8] float32)
// and two of lc_end [NP].
__host__ __device__ inline size_t state_smem_bytes(int N, int L, int esz,
                                                   int col_blocks) {
  const int NP = pad16(N), CB = NP / col_blocks;
  return kStages * ((size_t)L * N * (esz + 4) + (size_t)L * row_t(CB) * esz) +
         4 * 2 * ((size_t)L * row_t(NP) + NP);
}

// Shared memory of the chunk kernel, in this order (SA = NP + 4, LP = L +
// 4):
//   rs  [L][SA]           r, later r e^{lc}
//   ks  [max(L, NP)][SA]  k, later S_c^T from the workspace
//   lc  [L][SA]           sum_{s<t} log_w_s (cs - w), later the TF32
//                         low part of r e^{lc}
//   lcs [max(L, NP)][SA]  log_w as staged, then lc + w, later the low
//                         part of S_c^T
//   us [NP], bonus [L]    (float32 so far)
//   v   [L][N + 8]        raw, the B operand of A v
//   r and k raw ([L][N] each), later A ([L][LP] float32)
__host__ __device__ inline size_t chunk_smem_bytes(int N, int L, int esz) {
  const int NP = pad16(N), SA = row_a(NP);
  const size_t raw = 2 * (size_t)L * N * esz;
  const size_t a = 4 * (size_t)L * (L + 4);
  return 4 * ((size_t)L * SA * 2 + 2 * (size_t)(L > NP ? L : NP) * SA +
              NP + L) +
         (size_t)L * row_t(N) * esz + (raw > a ? raw : a);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive elements as float32
__device__ __forceinline__ float4 ld4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4f(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(x.x << 16),
                     __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16),
                     __uint_as_float(x.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// e^x for an exponent that is <= 0 up to rounding, in natural-log units
__device__ __forceinline__ float exp_le0(float x) {
  return ex2(fminf(x, 0.f) * kLog2e);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 x), both parts TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// four values split at once, the parts as float32 bit patterns
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  uint32_t h, l;
  split_tf32(x.x, h, l);
  hi.x = __uint_as_float(h);
  lo.x = __uint_as_float(l);
  split_tf32(x.y, h, l);
  hi.y = __uint_as_float(h);
  lo.y = __uint_as_float(l);
  split_tf32(x.z, h, l);
  hi.z = __uint_as_float(h);
  lo.z = __uint_as_float(l);
  split_tf32(x.w, h, l);
  hi.w = __uint_as_float(h);
  lo.w = __uint_as_float(l);
}

// c (16 x 8) += a (16 x 8, row) b (8 x 8, col), TF32 in, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of the 16 x 8 block at p, split: element (row, col) at
// p[row * rs + col * cs].  Rows g and g + 8, columns t and t + 4.
__device__ __forceinline__ void load_a(const float* p, int rs, int cs,
                                       int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_tf32(p[g * rs + t * cs], hi[0], lo[0]);
  split_tf32(p[(g + 8) * rs + t * cs], hi[1], lo[1]);
  split_tf32(p[g * rs + (t + 4) * cs], hi[2], lo[2]);
  split_tf32(p[(g + 8) * rs + (t + 4) * cs], hi[3], lo[3]);
}

// c += a b, a split; b = (b0, b1) split too unless EXACT_B (b is a
// bfloat16 value, exact in TF32): three MMAs or two
template <bool EXACT_B>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0,
                                     float b1) {
  if (EXACT_B) {
    const uint32_t h0 = __float_as_uint(b0), h1 = __float_as_uint(b1);
    mma(c, ahi, h0, h1);
    mma(c, alo, h0, h1);
  } else {
    uint32_t h0, l0, h1, l1;
    split_tf32(b0, h0, l0);
    split_tf32(b1, h1, l1);
    mma(c, ahi, h0, h1);
    mma(c, ahi, l0, l1);
    mma(c, alo, h0, h1);
  }
}

// c += a b with both already split: a = ahi + alo, b = bhi + blo
__device__ __forceinline__ void mma3s(float (&c)[4],
                                      const uint32_t (&ahi)[4],
                                      const uint32_t (&alo)[4],
                                      const float* bh, const float* bl,
                                      int k4) {
  const uint32_t h0 = __float_as_uint(bh[0]), h1 = __float_as_uint(bh[k4]);
  mma(c, ahi, h0, h1);
  mma(c, ahi, __float_as_uint(bl[0]), __float_as_uint(bl[k4]));
  mma(c, alo, h0, h1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 4 elements global -> shared, asynchronously (8 or 16 bytes)
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The state chain: a block per (row, column block) walks the row's chunks,
// two roles in a pipeline.  Warps 4-7 (producers) turn chunk c + 1's k and
// log_w into k_dec and lc_end while warps 0 .. NP/16 - 1 (the MMA warps)
// apply chunk c: S = e^{lc_end} S + k_dec^T v.  One barrier per chunk.
// ---------------------------------------------------------------------------
template <typename T, int L, int NP>
__global__ void __launch_bounds__(kThreads, 1)
    wkv6_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ log_w,
                      const float* __restrict__ s0, float* __restrict__ ws,
                      float* __restrict__ s_out, int T_len, int N,
                      int col_blocks) {
  // the chunk kernel may start now: it waits for this grid before it
  // reads the workspace
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int DT = NP / 16;          // MMA warps: one per 16 rows of S
  constexpr int KD = row_t(NP);        // k_dec's row stride
  constexpr int kProd = 128;           // producer threads (warps 4-7)
  constexpr bool kExactV = sizeof(T) == 2;
  const int CB = NP / col_blocks;      // this block's value columns
  const int CT = CB / 8;               // their 8-column tiles (<= 8)
  const int RV = row_t(CB);
  const int c0 = blockIdx.x * CB;
  const int row = blockIdx.y;
  const int nc = T_len / L;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t xbytes = (size_t)L * N * (sizeof(T) + 4);
  const size_t vbytes = (size_t)L * RV * sizeof(T);
  float* kd0 = reinterpret_cast<float*>(smem + kStages * (xbytes + vbytes));
  float* lend0 = kd0 + 2 * L * KD;
  auto x_k = [&](int c) {
    return reinterpret_cast<T*>(smem + (c % kStages) * xbytes);
  };
  auto x_w = [&](int c) {
    return reinterpret_cast<float*>(x_k(c) + L * N);
  };
  auto v_st = [&](int c) {
    return reinterpret_cast<T*>(smem + kStages * xbytes +
                                (c % kStages) * vbytes);
  };

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t seq0 = (size_t)row * T_len * N;
  const int nq = N / 4;
  const int nv = (N - c0 < CB ? N - c0 : CB) / 4;   // v's 4-column groups
  // each role copies what it reads: the producers k and log_w, the other
  // warps v (a thread's copy groups are its own; the barrier at the top of
  // every chunk publishes them to the block)
  const bool producer = tid >= kThreads - kProd;
  const int rt = producer ? tid - (kThreads - kProd) : tid;   // role thread
  auto load_x = [&](int c) {   // k and log_w of chunk c, contiguous
    if (c >= nc || !producer) return;
    const size_t off = seq0 + (size_t)c * L * N;
    for (int e = rt; e < L * nq; e += kProd) {
      cp_async4(x_k(c) + 4 * e, k + off + 4 * e);
      cp_async4(x_w(c) + 4 * e, log_w + off + 4 * e);
    }
  };
  auto load_v = [&](int c) {   // this block's columns of v, padded rows
    if (c >= nc || producer) return;
    const size_t off = seq0 + (size_t)c * L * N + c0;
    for (int e = rt; e < L * nv; e += kThreads - kProd) {
      const int t = e / nv, cc = 4 * (e - t * nv);
      cp_async4(v_st(c) + t * RV + cc, v + off + (size_t)t * N + cc);
    }
  };
  // producers: chunk c's k_dec = k e^{lc_end - lcs} and lc_end, in the
  // plain version's order (lcs_t = (cs_t - w_t) + w_t, cs in step order)
  auto produce = [&](int c) {
    float* kd = kd0 + (c & 1) * L * KD;
    float* lend = lend0 + (c & 1) * NP;
    const T* sk = x_k(c);
    const float* sw = x_w(c);
    if (rt < NP) {
      const int d = rt;
      float cs = 0.f, l = 0.f;
#pragma unroll 1
      for (int t0 = 0; t0 < L; t0 += 16) {
        float w[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) w[t] = d < N ? sw[(t0 + t) * N + d] : 0.f;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          cs += w[t];
          l = (cs - w[t]) + w[t];
          kd[(t0 + t) * KD + d] = l;   // lcs_t, parked
        }
      }
      lend[d] = l;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kProd) : "memory");
    constexpr int kIt = (L * NP / 4 + kProd - 1) / kProd;
    float4 kv[kIt], lv[kIt], le[kIt];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int e = rt + it * kProd;
      const int t = e / (NP / 4), d = 4 * (e % (NP / 4));
      kv[it] = lv[it] = le[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < L * NP / 4) {
        if (d < N) kv[it] = ld4f(sk + t * N + d);
        lv[it] = ld4f(kd + t * KD + d);
        le[it] = ld4f(lend + d);
      }
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int e = rt + it * kProd;
      const int t = e / (NP / 4), d = 4 * (e % (NP / 4));
      if (e < L * NP / 4)
        st4(kd + t * KD + d,
            make_float4(kv[it].x * exp_le0(le[it].x - lv[it].x),
                        kv[it].y * exp_le0(le[it].y - lv[it].y),
                        kv[it].z * exp_le0(le[it].z - lv[it].z),
                        kv[it].w * exp_le0(le[it].w - lv[it].w)));
    }
  };

  // MMA warp w < DT owns rows [16 w, +16) of S and all CT column tiles
  const bool mma_warp = warp < DT;
  const int dlo = 16 * warp + g, dhi = dlo + 8;
  float S[8][4];
  const float* s0r = s0 + (size_t)row * N * N;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + 8 * j + 2 * t4;
    float2 a = make_float2(0.f, 0.f), b = a;
    if (mma_warp && j < CT && c < N) {
      if (dlo < N) a = *reinterpret_cast<const float2*>(s0r + dlo * N + c);
      if (dhi < N) b = *reinterpret_cast<const float2*>(s0r + dhi * N + c);
    }
    S[j][0] = a.x;
    S[j][1] = a.y;
    S[j][2] = b.x;
    S[j][3] = b.y;
  }

  // copy groups, in order: {x0}, {x1, v0}, {x2, v1}, then per chunk c
  // {x(c + 3), v(c + 2)}: at the top of chunk c the group holding x(c + 1)
  // and v(c) is the second newest
  load_x(0);
  cp_async_commit();
  load_x(1);
  load_v(0);
  cp_async_commit();
  load_x(2);
  load_v(1);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();
  if (producer) produce(0);
  float* wsr = ws + (size_t)row * nc * N * N;
  for (int ch = 0; ch < nc; ++ch) {
    cp_async_wait<1>();
    __syncthreads();   // x(ch + 1), v(ch) staged; k_dec(ch) ready; the
                       // stages of chunk ch - 1 are free
    load_x(ch + 3);
    load_v(ch + 2);
    cp_async_commit();
    if (producer) {
      if (ch + 1 < nc) produce(ch + 1);
    } else if (mma_warp) {
      const float* kd = kd0 + (ch & 1) * L * KD;
      const float* lend = lend0 + (ch & 1) * NP;
      const T* sv = v_st(ch);
      // S_c -> the workspace, transposed (ws[c][d]); then S = e^{lc_end}
      // S + k_dec^T v, with k_dec^T read in place (row d, column t)
      float* wsc = wsr + (size_t)ch * N * N;
      const float elo = exp_le0(lend[dlo]), ehi = exp_le0(lend[dhi]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + 8 * j + 2 * t4;
        if (j < CT && c < N) {
          if (dlo < N) {
            wsc[c * N + dlo] = S[j][0];
            wsc[(c + 1) * N + dlo] = S[j][1];
          }
          if (dhi < N) {
            wsc[c * N + dhi] = S[j][2];
            wsc[(c + 1) * N + dhi] = S[j][3];
          }
        }
        S[j][0] *= elo;
        S[j][1] *= elo;
        S[j][2] *= ehi;
        S[j][3] *= ehi;
      }
#pragma unroll 1
      for (int kk = 0; kk < L / 8; ++kk) {
        uint32_t ahi[4], alo[4];
        load_a(kd + 8 * kk * KD + 16 * warp, 1, KD, g, t4, ahi, alo);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < CT) {
            const T* b = sv + (8 * kk + t4) * RV + 8 * j + g;
            mma3<kExactV>(S[j], ahi, alo, to_f(b[0]), to_f(b[4 * RV]));
          }
        }
      }
    }
  }
  if (mma_warp) {
    float* so = s_out + (size_t)row * N * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + 8 * j + 2 * t4;
      if (j < CT && c < N) {
        if (dlo < N)
          *reinterpret_cast<float2*>(so + dlo * N + c) =
              make_float2(S[j][0], S[j][1]);
        if (dhi < N)
          *reinterpret_cast<float2*>(so + dhi * N + c) =
              make_float2(S[j][2], S[j][3]);
      }
    }
  }
}

// Row sub-chunk q of a chunk-kernel block: all of them unsplit, else part
// p takes {p, NS - 1 - p} (split 2 needs NS = 4).
__device__ __forceinline__ int own_sub(int q, int split, int part, int ns) {
  return split == 1 ? q : (q == 0 ? part : ns - 1 - part);
}

// ---------------------------------------------------------------------------
// The output of one chunk (or one half of its rows).
// ---------------------------------------------------------------------------
template <typename T, int L, int NP>
__global__ void __launch_bounds__(kThreads, 2)
    wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ log_w,
                      const float* __restrict__ u,
                      const float* __restrict__ ws, float* __restrict__ out,
                      int T_len, int N, int split) {
  constexpr int NS = L / 16;
  constexpr int LP = L + 4;
  constexpr int SA = row_a(NP);
  constexpr int NT8 = NP / 8;
  constexpr int SCAN = (NP + 31) / 32 * 32;   // threads of the scan's warps
  constexpr bool kExactV = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem);
  float* ks = rs + L * SA;
  float* lc = ks + (L > NP ? L : NP) * SA;
  float* lcs = lc + L * SA;
  float* us = lcs + (L > NP ? L : NP) * SA;
  float* bonus = us + NP;
  const int RV = row_t(N);
  T* vr = reinterpret_cast<T*>(bonus + L);
  T* r_raw = vr + L * RV;
  T* k_raw = r_raw + L * N;
  float* aS = reinterpret_cast<float*>(r_raw);   // after r, k are upcast
  float* St = ks;                                // after A is summed

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int part = blockIdx.x % split, ch = blockIdx.x / split;
  const int row = blockIdx.y;
  const int nc = T_len / L;
  const int n_own = NS / split;
  const size_t base = ((size_t)row * T_len + (size_t)ch * L) * N;
  const int nq = N / 4;

  // 0. stage the chunk: r, k raw; v raw in padded rows; log_w straight
  //    into lcs's rows
  for (int e = tid; e < L * nq; e += kThreads) {
    const int t = e / nq, d = 4 * (e - t * nq);
    cp_async4(r_raw + 4 * e, r + base + 4 * e);
    cp_async4(k_raw + 4 * e, k + base + 4 * e);
    cp_async4(vr + t * RV + d, v + base + 4 * e);
    cp_async4(lcs + t * SA + d, log_w + base + 4 * e);
  }
  cp_async_commit();
  for (int e = tid; e < NP; e += kThreads)
    us[e] = e < N ? u[(size_t)row * N + e] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // 1. the scan's warps: each channel's prefix sums in the plain version's
  //    order (cs in step order, lc = cs - w, lcs = lc + w); the others:
  //    upcast r and k, zero past N
  if (tid < SCAN) {
    if (tid < NP) {
      const int d = tid;
      float cs = 0.f;
#pragma unroll 1
      for (int t0 = 0; t0 < L; t0 += 16) {
        float w[16];
#pragma unroll
        for (int t = 0; t < 16; ++t)
          w[t] = d < N ? lcs[(t0 + t) * SA + d] : 0.f;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          cs += w[t];
          const float l = cs - w[t];
          lc[(t0 + t) * SA + d] = l;
          lcs[(t0 + t) * SA + d] = l + w[t];
        }
      }
    }
  } else {
    // loads of a batch issued before its stores
    constexpr int kCvt = kThreads - SCAN;
    constexpr int kIt = (L * NP / 4 + kCvt - 1) / kCvt;
    constexpr int kBatch = kIt < 4 ? kIt : 4;
#pragma unroll 1
    for (int it0 = 0; it0 < kIt; it0 += kBatch) {
      float4 rv[kBatch], kv[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = tid - SCAN + (it0 + b) * kCvt;
        const int t = e / (NP / 4), d = 4 * (e % (NP / 4));
        rv[b] = kv[b] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < L * NP / 4 && d < N) {
          rv[b] = ld4f(r_raw + t * N + d);
          kv[b] = ld4f(k_raw + t * N + d);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = tid - SCAN + (it0 + b) * kCvt;
        const int t = e / (NP / 4), d = 4 * (e % (NP / 4));
        if (e < L * NP / 4) {
          st4(rs + t * SA + d, rv[b]);
          st4(ks + t * SA + d, kv[b]);
        }
      }
    }
  }
  __syncthreads();

  // 2. the bonus (r . u k); the diagonal 16 x 16 blocks of A: zeros in
  //    the 4 x 4 tiles above their diagonal, then the tiles on and below
  //    it, summed in registers (~1 float of shared memory read per term)
  {
    const int i = tid >> 2, q = tid & 3;
    float b = 0.f;
    if (i < L) {
#pragma unroll
      for (int d = q * (NP / 4); d < (q + 1) * (NP / 4); d += 4) {
        const float4 rv = ld4f(rs + i * SA + d), kv = ld4f(ks + i * SA + d),
                     uv = ld4f(us + d);
        b += rv.x * uv.x * kv.x + rv.y * uv.y * kv.y + rv.z * uv.z * kv.z +
             rv.w * uv.w * kv.w;
      }
    }
    b += __shfl_xor_sync(0xffffffffu, b, 1);
    b += __shfl_xor_sync(0xffffffffu, b, 2);
    if (i < L && q == 0) bonus[i] = b;
  }
  for (int e = tid; e < n_own * 256; e += kThreads) {
    const int i0 = 16 * own_sub(e >> 8, split, part, NS);
    const int a = (e >> 4) & 15, b = e & 15;
    if ((b >> 2) > (a >> 2)) aS[(i0 + a) * LP + i0 + b] = 0.f;
  }
  {
    // 4 x 4 tiles of (i, j) pairs, the 6 below the diagonal of every owned
    // block first, then the 4 on it, spread over all warps; a thread per
    // (tile, group of channels), a tile's groups in adjacent lanes, as
    // many groups as a warp's lanes take.  A tile below the diagonal
    // factors its terms at its own corners, e^{lc_i - lcs_j} = e^{lc_i -
    // lc_a0} e^{lc_a0 - lcs_b3} e^{lcs_b3 - lcs_j} (a0 its first row step,
    // b3 its last column step; every exponent <= 0), ~9 exponentials per
    // channel for 16 terms; a tile on the diagonal takes one per pair j < i.
    const int n_tiles = n_own * 10;
    const int tpw = (n_tiles + kWarps - 1) / kWarps;   // tiles per warp
    // channel groups per tile: 16, 8 or 4, as many as a warp's lanes take,
    // at least 4 channels each
    int ng = 16;
    while (ng > 4 && (tpw * ng > 32 || NP / ng < 4)) ng >>= 1;
    const int tile = warp * tpw + lane / ng;
    const bool active = lane / ng < tpw && tile < n_tiles;
    const int q = lane % ng;
    const int cw = NP / ng;   // channels per group
    int own = 0, ti = 0, tj = 0;
    if (active && tile < n_own * 6) {
      own = tile / 6;
      const int x = tile - own * 6;   // (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
      ti = x < 1 ? 1 : (x < 3 ? 2 : 3);
      tj = x - (ti * (ti - 1)) / 2;
    } else if (active) {
      const int f = tile - n_own * 6;
      own = f >> 2;
      ti = tj = f & 3;
    }
    const int i0 = 16 * own_sub(own, split, part, NS);
    const int ia = i0 + 4 * ti, jb = i0 + 4 * tj;
    const bool diag = ti == tj;
    float acc[4][4] = {};
    if (active) {
#pragma unroll 1
      for (int d = q * cw; d < (q + 1) * cw; d += 4) {
        float4 kv[4];
        if (!diag) {
          const float4 la0 = ld4f(lc + ia * SA + d);
          const float4 sb3 = ld4f(lcs + (jb + 3) * SA + d);
          const float4 gm = make_float4(
              exp_le0(la0.x - sb3.x), exp_le0(la0.y - sb3.y),
              exp_le0(la0.z - sb3.z), exp_le0(la0.w - sb3.w));
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float4 kb = ld4f(ks + (jb + b) * SA + d);
            const float4 sb = ld4f(lcs + (jb + b) * SA + d);
            kv[b] = make_float4(kb.x * exp_le0(sb3.x - sb.x) * gm.x,
                                kb.y * exp_le0(sb3.y - sb.y) * gm.y,
                                kb.z * exp_le0(sb3.z - sb.z) * gm.z,
                                kb.w * exp_le0(sb3.w - sb.w) * gm.w);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float4 rv = ld4f(rs + (ia + a) * SA + d);
            const float4 lv = ld4f(lc + (ia + a) * SA + d);
            const float4 re = make_float4(
                rv.x * exp_le0(lv.x - la0.x), rv.y * exp_le0(lv.y - la0.y),
                rv.z * exp_le0(lv.z - la0.z), rv.w * exp_le0(lv.w - la0.w));
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][b] += re.x * kv[b].x + re.y * kv[b].y +
                           re.z * kv[b].z + re.w * kv[b].w;
          }
        } else {
          float4 sv[4];
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            kv[b] = ld4f(ks + (jb + b) * SA + d);
            sv[b] = ld4f(lcs + (jb + b) * SA + d);
          }
#pragma unroll
          for (int a = 1; a < 4; ++a) {
            const float4 rv = ld4f(rs + (ia + a) * SA + d);
            const float4 lv = ld4f(lc + (ia + a) * SA + d);
#pragma unroll
            for (int b = 0; b < a; ++b)
              acc[a][b] += rv.x * kv[b].x * exp_le0(lv.x - sv[b].x) +
                           rv.y * kv[b].y * exp_le0(lv.y - sv[b].y) +
                           rv.z * kv[b].z * exp_le0(lv.z - sv[b].z) +
                           rv.w * kv[b].w * exp_le0(lv.w - sv[b].w);
          }
        }
      }
    }
    for (int m = 1; m < ng; m <<= 1)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a][b] += __shfl_xor_sync(0xffffffffu, acc[a][b], m);
    if (active && q < 4) {
      // lane q < 4 writes row ia + q of the tile (zero on and above the
      // diagonal of a diagonal tile)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float x = q == 0 ? acc[0][b]
                        : q == 1 ? acc[1][b]
                        : q == 2 ? acc[2][b]
                                 : acc[3][b];
        aS[(ia + q) * LP + jb + b] = diag && b >= q ? 0.f : x;
      }
    }
  }

  // 3. the off-diagonal blocks of A on the tensor cores, a warp each:
  //    A(ti, tj) = (r e^{lc - lc_i0})_ti . (k e^{lc_i0 - lcs})_tj^T
  {
    int n_off = 0;
    for (int q = 0; q < n_own; ++q) n_off += own_sub(q, split, part, NS);
    for (int p = warp; p < n_off; p += kWarps) {
      int ti = 0, tj = p;
      for (int q = 0; q < n_own; ++q) {
        const int o = own_sub(q, split, part, NS);
        if (tj < o) {
          ti = o;
          break;
        }
        tj -= o;
      }
      const int i0 = 16 * ti, j0 = 16 * tj;
      float acc[2][4] = {};
#pragma unroll 1
      for (int kk = 0; kk < NT8; ++kk) {
        const int d = 8 * kk + t4;
        const float l0a = lc[i0 * SA + d], l0b = lc[i0 * SA + d + 4];
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = i0 + g + 8 * (x & 1), dx = d + 4 * (x >> 1);
          split_tf32(rs[i * SA + dx] *
                         exp_le0(lc[i * SA + dx] - ((x >> 1) ? l0b : l0a)),
                     ahi[x], alo[x]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int j = j0 + 8 * n + g;
          const float b0 = ks[j * SA + d] * exp_le0(l0a - lcs[j * SA + d]);
          const float b1 =
              ks[j * SA + d + 4] * exp_le0(l0b - lcs[j * SA + d + 4]);
          mma3<false>(acc[n], ahi, alo, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float* a0 = aS + (i0 + g) * LP + j0 + 8 * n + 2 * t4;
        a0[0] = acc[n][0];
        a0[1] = acc[n][1];
        a0[8 * LP] = acc[n][2];
        a0[8 * LP + 1] = acc[n][3];
      }
    }
  }
  __syncthreads();

  // 4. wait for the state kernel and start copying S_c^T into ks; then
  //    out = A v on the tensor cores (v read in place) and r <- r e^{lc}
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  {
    const float* src = ws + ((size_t)row * nc + ch) * N * N;
    for (int e = tid; e < N * nq; e += kThreads) {
      const int c = e / nq;
      cp_async4(St + c * SA + 4 * (e - c * nq), src + 4 * e);
    }
    cp_async_commit();
    if (N < NP)
      for (int e = tid; e < NP * NP; e += kThreads) {
        const int c = e / NP, d = e % NP;
        if (c >= N || d >= N) St[c * SA + d] = 0.f;
      }
  }
  const int wpr = kWarps / n_own;   // warps per row sub-chunk
  const int ti = own_sub(warp / wpr, split, part, NS);
  const int cgrp = warp % wpr;
  const int i0 = 16 * ti;
  float acc[4][4] = {};
#pragma unroll 1
  for (int kk = 0; kk < 2 * (ti + 1); ++kk) {
    uint32_t ahi[4], alo[4];
    load_a(aS + i0 * LP + 8 * kk, LP, 1, g, t4, ahi, alo);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = cgrp + wpr * j;
      if (nt < NT8) {
        const T* b = vr + (8 * kk + t4) * RV + 8 * nt + g;
        mma3<kExactV>(acc[j], ahi, alo, to_f(b[0]), to_f(b[4 * RV]));
      }
    }
  }
  {
    // r e^{lc} on the owned rows, split once into TF32 parts: the high
    // part over r, the low part over lc; loads before stores
    constexpr int kIt = (4 * (L / 16) * NP + kThreads - 1) / kThreads;
    float4 rv[kIt], lv[kIt];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int e = tid + it * kThreads;
      const int q = e / (4 * NP), rem = e - q * 4 * NP;
      const int i = 16 * own_sub(q < n_own ? q : 0, split, part, NS) +
                    rem / (NP / 4);
      const int d = 4 * (rem % (NP / 4));
      if (e < n_own * 4 * NP) {
        rv[it] = ld4f(rs + i * SA + d);
        lv[it] = ld4f(lc + i * SA + d);
      }
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int e = tid + it * kThreads;
      const int q = e / (4 * NP), rem = e - q * 4 * NP;
      const int i = 16 * own_sub(q < n_own ? q : 0, split, part, NS) +
                    rem / (NP / 4);
      const int d = 4 * (rem % (NP / 4));
      if (e < n_own * 4 * NP) {
        float4 hi, lo;
        split4(make_float4(rv[it].x * exp_le0(lv[it].x),
                           rv[it].y * exp_le0(lv[it].y),
                           rv[it].z * exp_le0(lv[it].z),
                           rv[it].w * exp_le0(lv[it].w)),
               hi, lo);
        st4(rs + i * SA + d, hi);
        st4(lc + i * SA + d, lo);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  {
    // S_c^T split once into TF32 parts: high over itself, low over lcs
    constexpr int kIt = (NP * NP / 4 + kThreads - 1) / kThreads;
    float4 x[kIt];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int e = tid + it * kThreads;
      const int c = e / (NP / 4), d = 4 * (e % (NP / 4));
      if (e < NP * NP / 4) x[it] = ld4f(St + c * SA + d);
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int e = tid + it * kThreads;
      const int c = e / (NP / 4), d = 4 * (e % (NP / 4));
      if (e < NP * NP / 4) {
        float4 hi, lo;
        split4(x[it], hi, lo);
        st4(St + c * SA + d, hi);
        st4(lcs + c * SA + d, lo);
      }
    }
  }
  __syncthreads();

  // 5. out += (r e^{lc}) S_c from the split parts, then the bonus, and
  //    store
#pragma unroll 1
  for (int kk = 0; kk < NT8; ++kk) {
    uint32_t ahi[4], alo[4];
    const float* ph = rs + (i0 + g) * SA + 8 * kk + t4;
    const float* pl = lc + (i0 + g) * SA + 8 * kk + t4;
    ahi[0] = __float_as_uint(ph[0]);
    ahi[1] = __float_as_uint(ph[8 * SA]);
    ahi[2] = __float_as_uint(ph[4]);
    ahi[3] = __float_as_uint(ph[8 * SA + 4]);
    alo[0] = __float_as_uint(pl[0]);
    alo[1] = __float_as_uint(pl[8 * SA]);
    alo[2] = __float_as_uint(pl[4]);
    alo[3] = __float_as_uint(pl[8 * SA + 4]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = cgrp + wpr * j;
      if (nt < NT8) {
        const int o = (8 * nt + g) * SA + 8 * kk + t4;
        mma3s(acc[j], ahi, alo, St + o, lcs + o, 4);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 8 * (cgrp + wpr * j) + 2 * t4;
    if (c < N) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + g + 8 * h;
        const float bi = bonus[i];
        const float2 o =
            make_float2(acc[j][2 * h] + bi * to_f(vr[i * RV + c]),
                        acc[j][2 * h + 1] + bi * to_f(vr[i * RV + c + 1]));
        *reinterpret_cast<float2*>(out + base + (size_t)i * N + c) = o;
      }
    }
  }
}

// cudaFuncSetAttribute once per instance and size; a refusal is cleared
template <typename K>
int allow_smem(K kern, size_t bytes, size_t* configured) {
  if (bytes <= *configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();   // not left pending for the next launch's check
    return (int)e;
  }
  *configured = bytes;
  return 0;
}

struct Args {
  const void *r, *k, *v, *log_w, *u, *s0;
  void *out, *s_out, *ws;
  int R, T, N, split, col_blocks;
  size_t smem_state, smem_chunk;
  cudaStream_t stream;
};

template <typename T, int L, int NP>
int launch(const Args& a) {
  const int esz = (int)sizeof(T);
  if (a.smem_state != state_smem_bytes(a.N, L, esz, a.col_blocks) ||
      a.smem_chunk != chunk_smem_bytes(a.N, L, esz) ||
      a.smem_state > (size_t)kSmemMax || a.smem_chunk > (size_t)kSmemMax ||
      (a.split == 2 && L != 64) || NP % (8 * a.col_blocks) != 0 ||
      a.R > 65535)
    return (int)cudaErrorInvalidValue;
  auto state = wkv6_state_kernel<T, L, NP>;
  auto chunk = wkv6_chunk_kernel<T, L, NP>;
  static size_t conf_state = 48 * 1024, conf_chunk = 48 * 1024;
  int rc = allow_smem(state, a.smem_state, &conf_state);
  if (rc) return rc;
  rc = allow_smem(chunk, a.smem_chunk, &conf_chunk);
  if (rc) return rc;

  state<<<dim3(a.col_blocks, a.R), kThreads, a.smem_state, a.stream>>>(
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.log_w), static_cast<const float*>(a.s0),
      static_cast<float*>(a.ws), static_cast<float*>(a.s_out), a.T, a.N,
      a.col_blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.T / L) * a.split, a.R);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.smem_chunk;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, chunk, static_cast<const T*>(a.r),
                         static_cast<const T*>(a.k),
                         static_cast<const T*>(a.v),
                         static_cast<const float*>(a.log_w),
                         static_cast<const float*>(a.u),
                         static_cast<const float*>(a.ws),
                         static_cast<float*>(a.out), a.T, a.N, a.split);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

template <typename T, int L>
int launch_np(const Args& a) {
  switch (pad16(a.N)) {
    case 16: return launch<T, L, 16>(a);
    case 32: return launch<T, L, 32>(a);
    case 48: return launch<T, L, 48>(a);
    case 64: return launch<T, L, 64>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_chunk(const Args& a, int chunk) {
  switch (chunk) {
    case 16: return launch_np<T, 16>(a);
    case 32: return launch_np<T, 32>(a);
    case 64: return launch_np<T, 64>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// r, k, v: (R, T, N) of one dtype (0: float32, 1: bfloat16); log_w: (R, T,
// N) float32; u: (R, N) float32; state: (R, N, N) float32; out: (R, T, N)
// float32; state_out: (R, N, N) float32; ws: R * (T / chunk) * N * N
// float32 of workspace; all contiguous and 16-byte aligned.  chunk is 16,
// 32 or 64; N is a multiple of 4, at most 64; T % chunk == 0.  The host
// plan gives split (1, or 2 with chunk 64: halves of each chunk's rows per
// output block), col_blocks (1, 2 or 4 blocks per row of the state chain)
// and both kernels' shared-memory bytes, which must equal this file's.
// Launches the state kernel, then the chunk kernel as its programmatic
// dependent; returns the first CUDA error.
int wkv6_launch(const void* r, const void* k, const void* v,
                const void* log_w, const void* u, const void* state,
                void* out, void* state_out, void* ws, int R, int T, int N,
                int chunk, int split, int col_blocks, int dtype,
                int smem_state, int smem_chunk, void* stream) {
  if (R <= 0 || T <= 0 || N <= 0 || N > kMaxN || N % 4 != 0 || chunk <= 0 ||
      T % chunk != 0 || (split != 1 && split != 2) ||
      (col_blocks != 1 && col_blocks != 2 && col_blocks != 4))
    return (int)cudaErrorInvalidValue;
  const Args a{r, k, v, log_w, u, state, out, state_out, ws, R, T, N, split,
               col_blocks, (size_t)smem_state, (size_t)smem_chunk,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return launch_chunk<__nv_bfloat16>(a, chunk);
  if (dtype == 0) return launch_chunk<float>(a, chunk);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
