// DSMIL attention pooling for one bag, forward and streaming backward, for
// Hopper (K1, K2, K3 of the port).
//
// Replaces the Pallas TPU kernels of tpumil/ops/dsmil_pallas.py:
//   K1  fused_attention_pool (_kernel)   -> pool_fwd_kernel + pool_merge_kernel
//   K2  _bwd1_kernel                     -> pool_bwd1_kernel + reduce_partials
//   K3  _bwd2_kernel                     -> pool_bwd2_rows_kernel,
//                                           pool_bwd2_dw0_kernel,
//                                           pool_bwd2_df_kernel + reduce_partials
//
// Per bag (feats f [N, K] row-major f32, D = 128, C <= 8 classes):
//   z1 = f W0^T + b0; h = relu(z1); q = tanh(h W2^T + b2)   (nonlinear q)
//   q = z1                                                  (linear q)
//   l = q q_max^T / sqrt(D), rows >= n_valid masked
//   K1: B = softmax_N(l)^T f  [C, K], plus the softmax stats (m, s)
//   K2: s_red[c] = sum_n A[n,c] (f_n . dB_c)
//   K3: dl = A (f dB^T - s_red); dF = A dB + dz1 W0, and dW0, db0, dW2, db2,
//       dq_max, recomputing every activation from (m, s) tile by tile.
//
// What bounds them: arithmetic. Each row costs 2 K D + 2 D^2 FMAs of the
// recompute (+ the backward's products) against 4 K bytes read, about 80
// flop per byte at K = 512, above the card's balance point.
//
// K1 and K2 (simple first): the TPU grid walks one bag serially over N. Here
// the valid rows are split across G blocks (at most what fits on the card at
// once); each block walks its rows in tiles of T = 32 rows staged in shared
// memory (64 KB at K = 512). Weights stream through a padded shared-memory
// chunk of 32 x 128 floats. The products run in true f32 on the CUDA cores
// (FFMA). Each block writes partials (K1: its own m, s and acc [C, K]; K2:
// its partial sums) and a second small kernel merges them in a fixed block
// order, so a rerun is bitwise equal (no float atomics).
//
// K3 does 32.6 GFLOP at N = 65529, K = 512, C = 2 (z1, the q-MLP, dW2, dh,
// dW0 and dF's dz1 W0, each 2 N K D or 2 N D^2, plus the small products with
// dB and q_max; 24 GFLOP without dF). Its bound is 0.486 ms in f32 FFMA (67
// TFLOP/s) and 0.198 ms as 3xTF32 on the tensor cores (3 x 32.6 GFLOP at
// 495 TFLOP/s). The design:
//  * every product runs on the tensor cores, mma.sync m16n8k8 with tf32
//    operands, in the 3xTF32 split (x = hi + lo; hi hi + hi lo + lo hi):
//    the counterpart of the TPU kernel's Precision.HIGHEST, f32-level error
//    where one TF32 pass would lose three digits;
//  * the rows pass takes tiles of 128 rows; the feats tile and [W0; dB]
//    stream through a double-buffered cp.async ring in K chunks of 32, with
//    dB's C rows as extra output columns, so z1 and f . dB come from one
//    pass over f; W2 stays resident in shared memory; dW2, db0, db2 and
//    dq_max stay per CTA;
//  * dW0 leaves the per-tile loop: the rows pass writes dz1 [N, 128] (and
//    A [N, C] where dF is wanted), and dW0 = dz1^T f is a split-N product,
//    each CTA holding a [128 x 128] slab in registers;
//  * dF = dz1 W0 + A dB is a third product, launched only when dF is
//    wanted;
//  * every partial merges in a fixed order, with no float atomics, so a
//    rerun is bitwise equal. Rows >= n_valid are never read: their attention
//    weight is exactly 0, and K3 writes zeros for their dF rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;                // ATTN_DIM
constexpr int T = 32;                 // rows per tile
constexpr int NT = 256;               // threads per block
constexpr int RPT = T * D / NT;       // rows per thread in a tile product (16)
constexpr int IC = 32;                // depth of one staged weight chunk
constexpr int LDM = D + 1;            // padded row of the staged chunk
constexpr int CMAX = 8;               // compile-time bound on classes
constexpr float NEG = -1e30f;

struct Weights {
  const float* w0;  // [D, K]
  const float* b0;  // [D]
  const float* w2;  // [D, D] (nonlinear only)
  const float* b2;  // [D]    (nonlinear only)
  const float* qm;  // [C, D]
};

// Stage M(i, j), i in [i0, i0 + IC), j in [j0, j0 + D), into sM[il * LDM + jl]
// with M(i, j) = trans ? W[j * I + i] : W[i * J + j]; out of range -> 0.
// Loads are coalesced along the contiguous index of W.
__device__ __forceinline__ void stage_chunk(float* sM, const float* __restrict__ W,
                                            bool trans, int I, int J, int i0, int j0) {
  for (int e = threadIdx.x; e < IC * D; e += NT) {
    int il, jl;
    if (trans) { il = e % IC; jl = e / IC; } else { il = e / D; jl = e % D; }
    const int i = i0 + il, j = j0 + jl;
    float v = 0.f;
    if (i < I && j < J) v = trans ? W[(int64_t)j * I + i] : W[(int64_t)i * J + j];
    sM[il * LDM + jl] = v;
  }
}

// acc[r] = sum_{i < I} sIn[(r0 + r) * ld + i] * M(i, j0 + col) for r < RPT,
// col = tid % D, r0 = (tid / D) * RPT. I % 4 == 0, ld % 4 == 0, sIn 16-byte
// aligned. Every thread of the block must call it (it synchronizes).
__device__ __forceinline__ void tile_product(float acc[RPT], const float* sIn, int ld,
                                             const float* __restrict__ W, bool trans,
                                             int I, int J, int j0, float* sM) {
  const int col = threadIdx.x % D, r0 = (threadIdx.x / D) * RPT;
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
  for (int i0 = 0; i0 < I; i0 += IC) {
    __syncthreads();  // the previous chunk is consumed
    stage_chunk(sM, W, trans, I, J, i0, j0);
    __syncthreads();
    const int n = min(IC, I - i0);
    for (int kk = 0; kk < n; kk += 4) {
      const float w0 = sM[kk * LDM + col], w1 = sM[(kk + 1) * LDM + col];
      const float w2 = sM[(kk + 2) * LDM + col], w3 = sM[(kk + 3) * LDM + col];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(sIn + (r0 + r) * ld + i0 + kk);
        float a = acc[r];
        a = fmaf(x.x, w0, a);
        a = fmaf(x.y, w1, a);
        a = fmaf(x.z, w2, a);
        a = fmaf(x.w, w3, a);
        acc[r] = a;
      }
    }
  }
}

// Stage rows [row0, row0 + rows) of feats into sF [T, K]; rows past `rows`
// are zero.
__device__ __forceinline__ void load_tile(float* sF, const float* __restrict__ feats,
                                          int64_t row0, int rows, int K) {
  const int kv = K / 4;
  for (int e = threadIdx.x; e < T * kv; e += NT) {
    const int r = e / kv, k4 = e % kv;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) v = *reinterpret_cast<const float4*>(feats + (row0 + r) * K + 4 * k4);
    *reinterpret_cast<float4*>(sF + r * K + 4 * k4) = v;
  }
}

// The shared recompute of one tile (the TPU kernel's _recompute_tile):
// nonlinear -> sH = relu(z1), sQ = tanh(sH W2^T + b2); linear -> sQ = z1.
// sH may alias sQ. Logits land in sL[r * CMAX + c], rows >= rows at NEG.
template <bool NL>
__device__ __forceinline__ void recompute(const float* sF, int K, const Weights& w, int C,
                                          int rows, const float* sQm, float* sH,
                                          float* sQ, float* sL, float* sM) {
  const int col = threadIdx.x % D, r0 = (threadIdx.x / D) * RPT;
  float acc[RPT];
  tile_product(acc, sF, K, w.w0, true, K, D, 0, sM);
  const float b0 = w.b0[col];
  if (NL) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) sH[(r0 + r) * D + col] = fmaxf(acc[r] + b0, 0.f);
    tile_product(acc, sH, D, w.w2, true, D, D, 0, sM);  // syncs before reading sH
    const float b2 = w.b2[col];
    __syncthreads();  // sQ may alias sH
#pragma unroll
    for (int r = 0; r < RPT; ++r) sQ[(r0 + r) * D + col] = tanhf(acc[r] + b2);
  } else {
#pragma unroll
    for (int r = 0; r < RPT; ++r) sQ[(r0 + r) * D + col] = acc[r] + b0;
  }
  __syncthreads();
  const float scale = 1.f / sqrtf((float)D);
  for (int e = threadIdx.x; e < T * C; e += NT) {
    const int r = e / C, c = e % C;
    float v = NEG;
    if (r < rows) {
      float d = 0.f;
      for (int k = 0; k < D; ++k) d = fmaf(sQ[r * D + k], sQm[c * D + k], d);
      v = d * scale;
    }
    sL[r * CMAX + c] = v;
  }
  __syncthreads();
}

struct Range {
  int t_begin, t_end;
};

__device__ __forceinline__ Range block_tiles(int n_valid, int tpc) {
  const int tiles = (n_valid + T - 1) / T;
  Range rg;
  rg.t_begin = min(blockIdx.x * tpc, tiles);
  rg.t_end = min(rg.t_begin + tpc, tiles);
  return rg;
}

// ---------------------------------------------------------------- K1 ---
// Shared memory: sF [T*K] | sM [IC*LDM] | sH [T*D] | sQm [C*D] | sL [T*CMAX]
//                | sAcc [C*K] | sStat [3*CMAX]
template <bool NL>
__global__ void __launch_bounds__(NT) pool_fwd_kernel(const float* __restrict__ feats,
                                                      Weights w, int n_valid, int K, int C,
                                                      int tpc, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* sF = reinterpret_cast<float*>(smem4);
  float* sM = sF + T * K;
  float* sH = sM + IC * LDM;
  float* sQm = sH + T * D;
  float* sL = sQm + C * D;
  float* sAcc = sL + T * CMAX;
  float* sStat = sAcc + C * K;  // m | s | corr
  const int tid = threadIdx.x;
  for (int e = tid; e < C * D; e += NT) sQm[e] = w.qm[e];
  for (int e = tid; e < C * K; e += NT) sAcc[e] = 0.f;
  if (tid < C) { sStat[tid] = NEG; sStat[CMAX + tid] = 0.f; }
  const Range rg = block_tiles(n_valid, tpc);
  for (int t = rg.t_begin; t < rg.t_end; ++t) {
    const int64_t row0 = (int64_t)t * T;
    const int rows = min(T, (int)(n_valid - row0));
    __syncthreads();
    load_tile(sF, feats, row0, rows, K);
    recompute<NL>(sF, K, w, C, rows, sQm, sH, sH, sL, sM);
    // online softmax: new max, rescale factor, p = exp(l - m) in place
    if (tid < C) {
      const int c = tid;
      const float m_old = sStat[c];
      float mx = m_old;
      for (int r = 0; r < T; ++r) mx = fmaxf(mx, sL[r * CMAX + c]);
      const float corr = expf(m_old - mx);
      float ssum = 0.f;
      for (int r = 0; r < T; ++r) {
        const float p = expf(sL[r * CMAX + c] - mx);
        sL[r * CMAX + c] = p;
        ssum += p;
      }
      sStat[c] = mx;
      sStat[CMAX + c] = sStat[CMAX + c] * corr + ssum;
      sStat[2 * CMAX + c] = corr;
    }
    __syncthreads();
    for (int k = tid; k < K; k += NT) {
      for (int c = 0; c < C; ++c) {
        float a = sAcc[c * K + k] * sStat[2 * CMAX + c];
        for (int r = 0; r < T; ++r) a = fmaf(sL[r * CMAX + c], sF[r * K + k], a);
        sAcc[c * K + k] = a;
      }
    }
  }
  __syncthreads();
  // partial layout per block: m [C] | s [C] | acc [C*K]
  float* out = part + (int64_t)blockIdx.x * C * (K + 2);
  if (tid < C) { out[tid] = sStat[tid]; out[C + tid] = sStat[CMAX + tid]; }
  for (int e = tid; e < C * K; e += NT) out[2 * C + e] = sAcc[e];
}

// Merge the G partials in block order: m = max m_g, s = sum s_g e^{m_g - m},
// B = sum acc_g e^{m_g - m} / s.
__global__ void pool_merge_kernel(const float* __restrict__ part, int G, int K, int C,
                                  float* __restrict__ out_b, float* __restrict__ out_m,
                                  float* __restrict__ out_s) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * K) return;
  const int c = idx / K, k = idx % K;
  const int64_t stride = (int64_t)C * (K + 2);
  float m = NEG;
  for (int g = 0; g < G; ++g) m = fmaxf(m, part[g * stride + c]);
  float s = 0.f, acc = 0.f;
  for (int g = 0; g < G; ++g) {
    const float* pg = part + g * stride;
    const float wgt = expf(pg[c] - m);
    s = fmaf(pg[C + c], wgt, s);
    acc = fmaf(pg[2 * C + c * K + k], wgt, acc);
  }
  out_b[idx] = acc / fmaxf(s, 1e-30f);
  if (k == 0) { out_m[c] = m; out_s[c] = s; }
}

// out[j] = sum_g part[g * M + j], in block order.
__global__ void reduce_partials(const float* __restrict__ part, int G, int64_t M,
                                float* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M) return;
  float a = 0.f;
  for (int g = 0; g < G; ++g) a += part[g * M + j];
  out[j] = a;
}

// Attention weights A = exp(l - m) / max(s, 1e-30) of the tile, written over
// sL; rows >= rows get 0.
__device__ __forceinline__ float attn_weight(float l, float m, float s) {
  return expf(l - m) / fmaxf(s, 1e-30f);
}

// ---------------------------------------------------------------- K2 ---
// Shared memory: sF [T*K] | sM [IC*LDM] | sH [T*D] | sQm [C*D] | sL [T*CMAX]
//                | sDB [C*K] | sR [CMAX*NT]
template <bool NL>
__global__ void __launch_bounds__(NT) pool_bwd1_kernel(
    const float* __restrict__ feats, Weights w, const float* __restrict__ m_stat,
    const float* __restrict__ s_stat, const float* __restrict__ db, int n_valid, int K,
    int C, int tpc, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* sF = reinterpret_cast<float*>(smem4);
  float* sM = sF + T * K;
  float* sH = sM + IC * LDM;
  float* sQm = sH + T * D;
  float* sL = sQm + C * D;
  float* sDB = sL + T * CMAX;
  float* sR = sDB + C * K;
  const int tid = threadIdx.x;
  for (int e = tid; e < C * D; e += NT) sQm[e] = w.qm[e];
  for (int e = tid; e < C * K; e += NT) sDB[e] = db[e];
  float red[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) red[c] = 0.f;
  const Range rg = block_tiles(n_valid, tpc);
  for (int t = rg.t_begin; t < rg.t_end; ++t) {
    const int64_t row0 = (int64_t)t * T;
    const int rows = min(T, (int)(n_valid - row0));
    __syncthreads();
    load_tile(sF, feats, row0, rows, K);
    recompute<NL>(sF, K, w, C, rows, sQm, sH, sH, sL, sM);
    for (int e = tid; e < T * C; e += NT) {
      const int r = e / C, c = e % C;
      if (r >= rows) continue;
      const float a = attn_weight(sL[r * CMAX + c], m_stat[c], s_stat[c]);
      float da = 0.f;
      for (int k = 0; k < K; ++k) da = fmaf(sF[r * K + k], sDB[c * K + k], da);
#pragma unroll
      for (int cc = 0; cc < CMAX; ++cc)
        if (cc == c) red[cc] = fmaf(a, da, red[cc]);
    }
  }
#pragma unroll
  for (int c = 0; c < CMAX; ++c) sR[c * NT + tid] = red[c];
  __syncthreads();
  if (tid < C) {
    float a = 0.f;
    for (int i = 0; i < NT; ++i) a += sR[tid * NT + i];
    part[(int64_t)blockIdx.x * C + tid] = a;
  }
}

// ---------------------------------------------------------------- K3 ---
// Three passes, all on the tensor cores in 3xTF32 (see the note at the top):
//   rows  (pool_bwd2_rows_kernel, G CTAs, tiles of TR rows): recompute z1,
//         h, q, A; dl, dz2, dz1; dz1 (and A where dF is wanted) to the
//         scratch Z [rows, zld]; per-CTA partials of db0, dW2, db2, dq_max.
//   dW0   (pool_bwd2_dw0_kernel, D x 128 slabs x S row splits): dz1^T f as
//         a split-N product, one [D, 128] slab per CTA in registers.
//   dF    (pool_bwd2_df_kernel, only when dF is wanted): [dz1 | A] times
//         [W0; dB] over tiles of 64 rows x 128 columns.
// Partials are summed by reduce_partials in a fixed order (no atomics).

namespace k3 {
constexpr int TR = 128;              // rows per tile of the rows pass
constexpr int KC = 32;               // depth of one streamed K chunk
constexpr int LDK = KC + 4;          // row of a staged chunk (ld / 4 odd)
constexpr int NB = D + CMAX;         // z1's D columns + dB's C (padded)
constexpr int LDA = D + 4;           // row of an activation tile (ld / 4 odd)
constexpr int RING = 2 * (TR + NB) * LDK;   // two stages of (feats, [W0; dB])
constexpr int ACT = TR * LDA;
constexpr int RC = 32;               // rows per stage of the dW0 pass
constexpr int LD2 = 128 + 8;         // row of a dW0-pass stage (ld / 8 odd)
constexpr int TR3 = 64;              // rows per tile of the dF pass
constexpr int LDZ3 = NB + 4;         // row of the dF pass's Z tile (ld / 4 odd)
constexpr int LDB3 = 128 + 8;        // row of the dF pass's [W0; dB] slab
constexpr int SLAB = 128;            // output columns per CTA (dW0, dF passes)
static_assert(RING >= ACT, "the activation tile aliases the chunk ring");

// Per-CTA partials of the rows pass: db0 [D] | dW2 [D*D] | db2 [D] | dqm [C*D]
__host__ __device__ __forceinline__ int64_t rows_partial_size(int C) {
  return (int64_t)D + D * D + D + (int64_t)C * D;
}

__host__ __device__ __forceinline__ size_t rows_smem_floats(bool nl) {
  return (size_t)RING + (nl ? 2 * (size_t)ACT : 0) + 3 * (size_t)CMAX * TR;
}
}  // namespace k3

// 3xTF32 on mma.sync: x = hi + lo with hi = tf32(x), lo = tf32(x - hi);
// a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, f32-level error (the dropped
// a_lo b_lo is 2^-22 relative).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b over one k8 step. The three products go into a fresh
// accumulator, small terms first, which is then added to d by an f32 add
// (round to nearest): the tensor core's own accumulation rounds toward zero,
// and over a long K that bias alone would exceed f32-level error.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh);
  mma_tf32(t, ah, bl);
  mma_tf32(t, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// Fragments of mma.m16n8k8 (PTX ISA), g = lane / 4, t = lane % 4:
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A(m, k) = p[m * SM + k * SK] and B(k, n) = p[k * SK + n * SN] from shared
// memory, split into (hi, lo).
template <int SM, int SK>
__device__ __forceinline__ void frag_a(uint32_t (&h)[4], uint32_t (&l)[4], const float* p) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  split_tf32(p[g * SM + t * SK], h[0], l[0]);
  split_tf32(p[(g + 8) * SM + t * SK], h[1], l[1]);
  split_tf32(p[g * SM + (t + 4) * SK], h[2], l[2]);
  split_tf32(p[(g + 8) * SM + (t + 4) * SK], h[3], l[3]);
}

template <int SK, int SN>
__device__ __forceinline__ void frag_b(uint32_t (&h)[2], uint32_t (&l)[2], const float* p) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  split_tf32(p[t * SK + g * SN], h[0], l[0]);
  split_tf32(p[(t + 4) * SK + g * SN], h[1], l[1]);
}

// 16-byte cp.async; src_ok == false fills the 16 bytes with zeros (src is
// then not read).
__device__ __forceinline__ void cp16(float* smem, const float* src, bool src_ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage K chunk [k0, k0 + KC) of the tile's feats rows into sF [TR][LDK]
// (rows >= rows and columns >= K zero) and of [W0; dB; 0] into sB [NB][LDK].
__device__ __forceinline__ void stage_rows_chunk(float* sF, float* sB,
                                                 const float* __restrict__ feats,
                                                 const float* __restrict__ w0,
                                                 const float* __restrict__ db, int64_t row0,
                                                 int rows, int K, int C, int k0) {
  constexpr int V = k3::KC / 4;
  for (int e = threadIdx.x; e < k3::TR * V; e += NT) {
    const int r = e / V, k = k0 + 4 * (e % V);
    const bool ok = r < rows && k < K;
    cp16(sF + r * k3::LDK + (k - k0), ok ? feats + (row0 + r) * K + k : feats, ok);
  }
  for (int e = threadIdx.x; e < k3::NB * V; e += NT) {
    const int n = e / V, k = k0 + 4 * (e % V);
    const bool ok = k < K && n < D + C;
    const float* src = n < D ? w0 + (int64_t)n * K + k : db + (int64_t)(n - D) * K + k;
    cp16(sB + n * k3::LDK + (k - k0), ok ? src : w0, ok);
  }
}

// The rows pass. Warp w owns rows [16 w, 16 w + 16) of every [TR, *] product
// and rows [16 w, 16 w + 16) of dW2. Shared memory (floats):
//   ring [RING] (aliased by sG [TR][LDA]: q, then dz2 / dz1)
//   | sH [TR][LDA] | sW2 [D][LDA] (nonlinear only)
//   | sQm [CMAX][D] | sDa [TR][CMAX] | sDl [TR][CMAX]
template <bool NL>
__global__ void __launch_bounds__(NT, 1) pool_bwd2_rows_kernel(
    const float* __restrict__ feats, Weights w, const float* __restrict__ m_stat,
    const float* __restrict__ s_stat, const float* __restrict__ db,
    const float* __restrict__ s_red, int n_valid, int K, int C, int tpc, int zld,
    int write_a, float* __restrict__ part, float* __restrict__ z) {
  using namespace k3;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* sG = ring;
  float* sH = ring + RING;
  float* sW2 = sH + ACT;
  float* sQm = NL ? sW2 + ACT : sH;
  float* sDa = sQm + CMAX * D;
  float* sDl = sDa + TR * CMAX;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;            // this warp's first row (or dW2 row)
  const float scale = 1.f / sqrtf((float)D);

  for (int e = tid; e < C * D; e += NT) sQm[e] = w.qm[e];
  if constexpr (NL)
    for (int e = tid; e < D * D; e += NT) sW2[(e / D) * LDA + e % D] = w.w2[e];

  float wacc[NL ? D / 8 : 1][4];       // dW2 rows [wr, wr + 16), all D columns
#pragma unroll
  for (int j = 0; j < (NL ? D / 8 : 1); ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) wacc[j][i] = 0.f;
  float dqm[CMAX * D / NT];            // dq_max[c][d], e = tid + NT i
#pragma unroll
  for (int i = 0; i < CMAX * D / NT; ++i) dqm[i] = 0.f;
  float bsum = 0.f;                    // tid < D: db0[tid]; else db2[tid - D]

  const int tiles = (n_valid + TR - 1) / TR;
  const int t_begin = min((int)blockIdx.x * tpc, tiles), t_end = min(t_begin + tpc, tiles);
  const int nch = (K + KC - 1) / KC;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int64_t row0 = (int64_t)tile * TR;
    const int rows = min(TR, (int)(n_valid - row0));
    __syncthreads();  // the previous tile's sG is consumed

    // z1 | da = f [W0; dB]^T, streamed over K in chunks through the ring
    float acc[NB / 8][4];
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    stage_rows_chunk(ring, ring + TR * LDK, feats, w.w0, db, row0, rows, K, C, 0);
    cp_commit();
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch) {
        float* nxt = ring + ((ch + 1) & 1) * (TR + NB) * LDK;
        stage_rows_chunk(nxt, nxt + TR * LDK, feats, w.w0, db, row0, rows, K, C,
                         (ch + 1) * KC);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const float* sF = ring + (ch & 1) * (TR + NB) * LDK;
      const float* sB = sF + TR * LDK;
#pragma unroll 1
      for (int ks = 0; ks < KC; ks += 8) {
        uint32_t ah[4], al[4];
        frag_a<LDK, 1>(ah, al, sF + wr * LDK + ks);
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          uint32_t bh[2], bl[2];
          frag_b<1, LDK>(bh, bl, sB + j * 8 * LDK + ks);
          mma3(acc[j], ah, al, bh, bl);
        }
      }
      __syncthreads();  // this stage is consumed before it is refilled
    }
    // h = relu(z1 + b0) -> sH (nonlinear) or q = z1 + b0 -> sG (linear);
    // da -> sDa
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wr + g + (i >> 1) * 8, d = j * 8 + 2 * t + (i & 1);
        const float z1 = acc[j][i] + w.b0[d];
        if constexpr (NL) sH[r * LDA + d] = fmaxf(z1, 0.f);
        else sG[r * LDA + d] = z1;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sDa[(wr + g + (i >> 1) * 8) * CMAX + 2 * t + (i & 1)] = acc[D / 8][i];
    __syncthreads();

    if constexpr (NL) {  // q = tanh(h W2^T + b2) -> sG
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll 1
      for (int ks = 0; ks < D; ks += 8) {
        uint32_t ah[4], al[4];
        frag_a<LDA, 1>(ah, al, sH + wr * LDA + ks);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          uint32_t bh[2], bl[2];
          frag_b<1, LDA>(bh, bl, sW2 + j * 8 * LDA + ks);
          mma3(acc[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wr + g + (i >> 1) * 8, d = j * 8 + 2 * t + (i & 1);
          sG[r * LDA + d] = tanhf(acc[j][i] + w.b2[d]);
        }
      __syncthreads();
    }

    // logits, A and dl = A (f . dB - s_red) per (row, class); A to Z
    for (int e = tid; e < TR * C; e += NT) {
      const int r = e / C, c = e % C;
      float a = 0.f, dl = 0.f;
      if (r < rows) {
        float l = 0.f;
        for (int k = 0; k < D; ++k) l = fmaf(sG[r * LDA + k], sQm[c * D + k], l);
        a = attn_weight(l * scale, m_stat[c], s_stat[c]);
        dl = a * (sDa[r * CMAX + c] - s_red[c]);
      }
      sDl[r * CMAX + c] = dl;
      if (write_a) z[(row0 + r) * zld + D + c] = a;
    }
    if (write_a)
      for (int e = tid; e < TR * (CMAX - C); e += NT)
        z[(row0 + e / (CMAX - C)) * zld + D + C + e % (CMAX - C)] = 0.f;
    __syncthreads();

    // dq_max += dl^T q (scaled at the end), one (c, d) per thread and slot
#pragma unroll
    for (int i = 0; i < CMAX * D / NT; ++i) {
      const int e = tid + NT * i, c = e / D, d = e % D;
      if (c < C) {
        float a = 0.f;
        for (int r = 0; r < TR; ++r) a = fmaf(sDl[r * CMAX + c], sG[r * LDA + d], a);
        dqm[i] += a;
      }
    }
    __syncthreads();

    // dq = scale dl q_max; nonlinear: dz2 = dq (1 - q^2), linear: dz1 = dq;
    // in place over q in sG
    for (int e = tid; e < TR * D / 4; e += NT) {
      const int r = e / (D / 4), d = 4 * (e % (D / 4));
      float4 q = *reinterpret_cast<float4*>(sG + r * LDA + d);
      float4 dq = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = 0; c < C; ++c) {
        const float dl = sDl[r * CMAX + c];
        const float4 qm = *reinterpret_cast<const float4*>(sQm + c * D + d);
        dq.x = fmaf(dl, qm.x, dq.x);
        dq.y = fmaf(dl, qm.y, dq.y);
        dq.z = fmaf(dl, qm.z, dq.z);
        dq.w = fmaf(dl, qm.w, dq.w);
      }
      if constexpr (NL) {
        q.x = dq.x * scale * (1.f - q.x * q.x);
        q.y = dq.y * scale * (1.f - q.y * q.y);
        q.z = dq.z * scale * (1.f - q.z * q.z);
        q.w = dq.w * scale * (1.f - q.w * q.w);
      } else {
        q = make_float4(dq.x * scale, dq.y * scale, dq.z * scale, dq.w * scale);
      }
      *reinterpret_cast<float4*>(sG + r * LDA + d) = q;
    }
    __syncthreads();

    if constexpr (NL) {
      if (tid >= D)  // db2 += column sums of dz2
        for (int r = 0; r < TR; ++r) bsum += sG[r * LDA + tid - D];
      // dW2 += dz2^T h: A(d, r) = sG[r][d], B(r, j) = sH[r][j]
#pragma unroll 1
      for (int ks = 0; ks < TR; ks += 8) {
        uint32_t ah[4], al[4];
        frag_a<1, LDA>(ah, al, sG + ks * LDA + wr);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          uint32_t bh[2], bl[2];
          frag_b<LDA, 1>(bh, bl, sH + ks * LDA + j * 8);
          mma3(wacc[j], ah, al, bh, bl);
        }
      }
      // dh = dz2 W2: A(r, d) = sG[r][d], B(d, j) = sW2[d][j]
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll 1
      for (int ks = 0; ks < D; ks += 8) {
        uint32_t ah[4], al[4];
        frag_a<LDA, 1>(ah, al, sG + wr * LDA + ks);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          uint32_t bh[2], bl[2];
          frag_b<LDA, 1>(bh, bl, sW2 + ks * LDA + j * 8);
          mma3(acc[j], ah, al, bh, bl);
        }
      }
      __syncthreads();  // every warp is done reading dz2
      // dz1 = dh * (z1 > 0) -> this warp's rows of sG
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wr + g + (i >> 1) * 8, d = j * 8 + 2 * t + (i & 1);
          sG[r * LDA + d] = sH[r * LDA + d] > 0.f ? acc[j][i] : 0.f;
        }
      __syncthreads();
    }
    // db0 += column sums of dz1; dz1 -> Z (rows past n_valid are zero)
    if (tid < D)
      for (int r = 0; r < TR; ++r) bsum += sG[r * LDA + tid];
    for (int e = tid; e < TR * D / 4; e += NT) {
      const int r = e / (D / 4), d = 4 * (e % (D / 4));
      *reinterpret_cast<float4*>(z + (row0 + r) * zld + d) =
          *reinterpret_cast<const float4*>(sG + r * LDA + d);
    }
  }

  // this CTA's partials: db0 | dW2 | db2 | dq_max
  float* p = part + (int64_t)blockIdx.x * rows_partial_size(C);
  if (tid < D) p[tid] = bsum;
  else p[D + D * D + tid - D] = NL ? bsum : 0.f;
  if constexpr (NL) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[D + (wr + g + (i >> 1) * 8) * D + j * 8 + 2 * t + (i & 1)] = wacc[j][i];
  } else {
    for (int e = tid; e < D * D; e += NT) p[D + e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < CMAX * D / NT; ++i) {
    const int e = tid + NT * i;
    if (e < C * D) p[2 * D + D * D + e] = dqm[i] * scale;
  }
}

// dW0 partial of row split blockIdx.y, columns [128 blockIdx.x, + 128):
// part[split][d][k] = sum_n Z[n][d] f[n][k] over the split's rows. Warps 4 x 2
// own 32 x 64 of the [D, 128] slab. Shared memory: 2 stages of
// sZ [RC][LD2] | sF [RC][LD2].
__global__ void __launch_bounds__(NT) pool_bwd2_dw0_kernel(
    const float* __restrict__ z, int zld, const float* __restrict__ feats, int n_valid,
    int K, int rps, float* __restrict__ part) {
  using namespace k3;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  const int k0 = blockIdx.x * SLAB;
  const int64_t r_begin = (int64_t)blockIdx.y * rps;
  const int64_t r_end = min((int64_t)n_valid, r_begin + rps);
  const int nch = (int)((r_end - r_begin + RC - 1) / RC);

  auto stage = [&](int ch) {
    float* sZ = ring + (ch & 1) * 2 * RC * LD2;
    float* sF = sZ + RC * LD2;
    for (int e = tid; e < RC * (D / 4); e += NT) {
      const int r = e / (D / 4), v = 4 * (e % (D / 4));
      const int64_t n = r_begin + (int64_t)ch * RC + r;
      const bool ok = n < r_end;
      cp16(sZ + r * LD2 + v, ok ? z + n * zld + v : z, ok);
      const bool okf = ok && k0 + v < K;
      cp16(sF + r * LD2 + v, okf ? feats + n * K + k0 + v : feats, okf);
    }
  };

  float acc[2][SLAB / 2 / 8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < SLAB / 2 / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.f;
  if (nch > 0) {
    stage(0);
    cp_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      stage(ch + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sZ = ring + (ch & 1) * 2 * RC * LD2;
    const float* sF = sZ + RC * LD2;
#pragma unroll
    for (int ks = 0; ks < RC; ks += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)  // A(d, n) = sZ[n][d]
        frag_a<1, LD2>(ah[mi], al[mi], sZ + ks * LD2 + wm + mi * 16);
#pragma unroll
      for (int j = 0; j < SLAB / 2 / 8; ++j) {
        uint32_t bh[2], bl[2];       // B(n, k) = sF[n][k]
        frag_b<LD2, 1>(bh, bl, sF + ks * LD2 + wn + j * 8);
        mma3(acc[0][j], ah[0], al[0], bh, bl);
        mma3(acc[1][j], ah[1], al[1], bh, bl);
      }
    }
    __syncthreads();
  }
  float* p = part + (int64_t)blockIdx.y * D * K;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < SLAB / 2 / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = wm + mi * 16 + g + h * 8, k = k0 + wn + j * 8 + 2 * t;
        if (k < K)
          *reinterpret_cast<float2*>(p + (int64_t)d * K + k) =
              make_float2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
      }
}

// dF rows [64 (blockIdx.x / slabs), + 64), columns [128 (blockIdx.x % slabs),
// + 128): dF = [dz1 | A] [W0; dB; 0] (depth NB); the CTAs of one row tile are
// neighbours, so its Z tile is read from device memory once. Warps 2 x 4 own
// 32 x 32.
// Shared memory: sZ [TR3][LDZ3] | sB [NB][LDB3].
__global__ void __launch_bounds__(NT) pool_bwd2_df_kernel(
    const float* __restrict__ z, const float* __restrict__ w0, const float* __restrict__ db,
    int n_valid, int K, int C, float* __restrict__ df) {
  using namespace k3;
  extern __shared__ float4 smem4[];
  float* sZ = reinterpret_cast<float*>(smem4);
  float* sB = sZ + TR3 * LDZ3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const int slabs = (K + SLAB - 1) / SLAB;
  const int k0 = (blockIdx.x % slabs) * SLAB;
  const int64_t row0 = (int64_t)(blockIdx.x / slabs) * TR3;
  for (int e = tid; e < TR3 * (NB / 4); e += NT) {
    const int r = e / (NB / 4), v = 4 * (e % (NB / 4));
    cp16(sZ + r * LDZ3 + v, z + (row0 + r) * NB + v, true);
  }
  for (int e = tid; e < NB * (SLAB / 4); e += NT) {
    const int d = e / (SLAB / 4), v = 4 * (e % (SLAB / 4));
    const bool ok = k0 + v < K && d < D + C;
    const float* src = d < D ? w0 + (int64_t)d * K + k0 + v : db + (int64_t)(d - D) * K + k0 + v;
    cp16(sB + d * LDB3 + v, ok ? src : w0, ok);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < NB; ks += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)  // A(r, d) = sZ[r][d]
      frag_a<LDZ3, 1>(ah[mi], al[mi], sZ + (wm + mi * 16) * LDZ3 + ks);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bh[2], bl[2];         // B(d, k) = sB[d][k]
      frag_b<LDB3, 1>(bh, bl, sB + ks * LDB3 + wn + j * 8);
      mma3(acc[0][j], ah[0], al[0], bh, bl);
      mma3(acc[1][j], ah[1], al[1], bh, bl);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t n = row0 + wm + mi * 16 + g + h * 8;
        const int k = k0 + wn + j * 8 + 2 * t;
        if (n < n_valid && k < K)
          *reinterpret_cast<float2*>(df + n * K + k) =
              make_float2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
      }
}

size_t smem_bytes(int which, int K, int C) {
  size_t f = (size_t)T * K + IC * LDM + (size_t)C * D + T * CMAX;
  if (which == 1) f += T * D + (size_t)C * K + 3 * CMAX;
  else f += T * D + (size_t)C * K + CMAX * NT;
  return f * sizeof(float);
}

const void* kernel_of(int which, bool nl) {
  if (which == 1) return nl ? (const void*)pool_fwd_kernel<true> : (const void*)pool_fwd_kernel<false>;
  return nl ? (const void*)pool_bwd1_kernel<true> : (const void*)pool_bwd1_kernel<false>;
}

bool bad_args(int n, int n_valid, int K, int C) {
  return K <= 0 || K % 4 != 0 || C < 1 || C > CMAX || n_valid < 1 || n_valid > n;
}

int smem_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Checks shared by the K1 and K2 entry points; sets the kernel's
// shared-memory limit.
int prepare(int which, int nonlinear, int n, int n_valid, int K, int C, size_t* smem) {
  if ((which != 1 && which != 2) || bad_args(n, n_valid, K, C))
    return (int)cudaErrorInvalidValue;
  *smem = smem_bytes(which, K, C);
  if (*smem > (size_t)smem_limit()) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel_of(which, nonlinear != 0),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

int tiles_per_block(int n_valid, int G) {
  const int tiles = (n_valid + T - 1) / T;
  return (tiles + G - 1) / G;
}

Weights weights(const void* w0, const void* b0, const void* w2, const void* b2,
                const void* qm) {
  return Weights{static_cast<const float*>(w0), static_cast<const float*>(b0),
                 static_cast<const float*>(w2), static_cast<const float*>(b2),
                 static_cast<const float*>(qm)};
}

// K3's launch shape and scratch (floats): part1 [G, rows_partial_size] |
// part2 [S, D, K] | Z [tiles * TR, zld].
struct Bwd2Plan {
  int G, tpc, S, rps, slabs, zld;
  int64_t part1, part2, z;
  size_t smem1, smem2, smem3;
  const void* rows_kernel;
};

int bwd2_plan(int nonlinear, int n, int n_valid, int K, int C, int need_df, Bwd2Plan* p) {
  using namespace k3;
  if (bad_args(n, n_valid, K, C)) return (int)cudaErrorInvalidValue;
  const bool nl = nonlinear != 0;
  p->rows_kernel = nl ? (const void*)pool_bwd2_rows_kernel<true>
                      : (const void*)pool_bwd2_rows_kernel<false>;
  p->smem1 = rows_smem_floats(nl) * sizeof(float);
  p->smem2 = (size_t)4 * RC * LD2 * sizeof(float);
  p->smem3 = ((size_t)TR3 * LDZ3 + (size_t)NB * LDB3) * sizeof(float);
  const size_t limit = (size_t)smem_limit();
  if (p->smem1 > limit || p->smem2 > limit || p->smem3 > limit)
    return (int)cudaErrorInvalidValue;
  const void* kernels[3] = {p->rows_kernel, (const void*)pool_bwd2_dw0_kernel,
                            (const void*)pool_bwd2_df_kernel};
  const size_t smem[3] = {p->smem1, p->smem2, p->smem3};
  for (int i = 0; i < 3; ++i) {
    const int err = (int)cudaFuncSetAttribute(
        kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem[i]);
    if (err != 0) return err;
  }
  const int sms = sm_count();
  int per_sm = 0, per_sm2 = 0;
  int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p->rows_kernel, NT,
                                                               p->smem1);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm2, (const void*)pool_bwd2_dw0_kernel, NT, p->smem2);
  if (err != 0) return err;
  if (per_sm < 1 || per_sm2 < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (n_valid + TR - 1) / TR;
  const int gmax = per_sm * sms;
  p->tpc = (tiles + gmax - 1) / gmax;
  p->G = (tiles + p->tpc - 1) / p->tpc;
  // dW0: enough row splits that every SM holds per_sm2 CTAs
  p->slabs = (K + SLAB - 1) / SLAB;
  const int want = (per_sm2 * sms + p->slabs - 1) / p->slabs;
  const int per = (n_valid + want - 1) / want;
  p->rps = (per + RC - 1) / RC * RC;
  p->S = (n_valid + p->rps - 1) / p->rps;
  p->zld = need_df ? NB : D;
  p->part1 = (int64_t)p->G * rows_partial_size(C);
  p->part2 = (int64_t)p->S * D * K;
  p->z = (int64_t)tiles * TR * p->zld;
  return 0;
}

}  // namespace

// Number of blocks G to launch for kernel `which` (1 = forward, 2 = backward
// pass 1): at most the blocks the card holds at once, at most one per tile.
// Returns G > 0, or -(CUDA error code).
extern "C" int tpumil_attention_pool_grid(int which, int nonlinear, int n, int n_valid,
                                          int K, int C) {
  size_t smem = 0;
  int err = prepare(which, nonlinear, n, n_valid, K, C, &smem);
  if (err != 0) return -err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_of(which, nonlinear != 0), NT, smem);
  if (err != 0) return -err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const int tiles = (n_valid + T - 1) / T;
  const int gmax = per_sm * sm_count();
  const int tpc = (tiles + gmax - 1) / gmax;
  return (tiles + tpc - 1) / tpc;
}

// K1. part: G * C * (K + 2) floats of scratch. Outputs B [C, K], m [C], s [C].
extern "C" int tpumil_attention_pool_fwd(const void* feats, const void* w0, const void* b0,
                                         const void* w2, const void* b2, const void* qm,
                                         int n, int n_valid, int K, int C, int nonlinear,
                                         int G, void* part, void* out_b, void* out_m,
                                         void* out_s, void* stream) {
  size_t smem = 0;
  int err = prepare(1, nonlinear, n, n_valid, K, C, &smem);
  if (err != 0 || G < 1) return err != 0 ? err : (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights w = weights(w0, b0, w2, b2, qm);
  const int tpc = tiles_per_block(n_valid, G);
  const float* f = static_cast<const float*>(feats);
  float* p = static_cast<float*>(part);
  if (nonlinear) pool_fwd_kernel<true><<<G, NT, smem, st>>>(f, w, n_valid, K, C, tpc, p);
  else pool_fwd_kernel<false><<<G, NT, smem, st>>>(f, w, n_valid, K, C, tpc, p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  pool_merge_kernel<<<(C * K + 255) / 256, 256, 0, st>>>(
      p, G, K, C, static_cast<float*>(out_b), static_cast<float*>(out_m),
      static_cast<float*>(out_s));
  return (int)cudaGetLastError();
}

// K2. part: G * C floats of scratch. Output s_red [C].
extern "C" int tpumil_attention_pool_bwd1(const void* feats, const void* w0, const void* b0,
                                          const void* w2, const void* b2, const void* qm,
                                          const void* m_stat, const void* s_stat,
                                          const void* db, int n, int n_valid, int K, int C,
                                          int nonlinear, int G, void* part, void* s_red,
                                          void* stream) {
  size_t smem = 0;
  int err = prepare(2, nonlinear, n, n_valid, K, C, &smem);
  if (err != 0 || G < 1) return err != 0 ? err : (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights w = weights(w0, b0, w2, b2, qm);
  const int tpc = tiles_per_block(n_valid, G);
  const float* f = static_cast<const float*>(feats);
  const float* ms = static_cast<const float*>(m_stat);
  const float* ss = static_cast<const float*>(s_stat);
  const float* g = static_cast<const float*>(db);
  float* p = static_cast<float*>(part);
  if (nonlinear)
    pool_bwd1_kernel<true><<<G, NT, smem, st>>>(f, w, ms, ss, g, n_valid, K, C, tpc, p);
  else
    pool_bwd1_kernel<false><<<G, NT, smem, st>>>(f, w, ms, ss, g, n_valid, K, C, tpc, p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  reduce_partials<<<1, 32, 0, st>>>(p, G, C, static_cast<float*>(s_red));
  return (int)cudaGetLastError();
}

// Size of K3's packed gradient output.
extern "C" long long tpumil_attention_pool_bwd2_size(int K, int C) {
  return (long long)D * K + k3::rows_partial_size(C);
}

// Floats of scratch that K3 needs, or -(CUDA error code).
extern "C" long long tpumil_attention_pool_bwd2_scratch(int nonlinear, int n, int n_valid,
                                                        int K, int C, int need_df) {
  Bwd2Plan p;
  const int err = bwd2_plan(nonlinear, n, n_valid, K, C, need_df, &p);
  if (err != 0) return -(long long)err;
  return (long long)(p.part1 + p.part2 + p.z);
}

// K3. scratch: tpumil_attention_pool_bwd2_scratch floats. Outputs grads
// packed as dW0 [D, K] | db0 [D] | dW2 [D, D] | db2 [D] | dq_max [C, D] and,
// when need_df, dF [n, K] (rows >= n_valid set to 0; df may be null
// otherwise).
extern "C" int tpumil_attention_pool_bwd2(const void* feats, const void* w0, const void* b0,
                                          const void* w2, const void* b2, const void* qm,
                                          const void* m_stat, const void* s_stat,
                                          const void* db, const void* s_red, int n,
                                          int n_valid, int K, int C, int nonlinear,
                                          int need_df, void* scratch, void* df, void* grads,
                                          void* stream) {
  using namespace k3;
  Bwd2Plan p;
  int err = bwd2_plan(nonlinear, n, n_valid, K, C, need_df, &p);
  if (err != 0) return err;
  if (need_df && df == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights w = weights(w0, b0, w2, b2, qm);
  const float* f = static_cast<const float*>(feats);
  float* part1 = static_cast<float*>(scratch);
  float* part2 = part1 + p.part1;
  float* z = part2 + p.part2;
  float* out = static_cast<float*>(grads);
  float* dff = static_cast<float*>(df);
  const float* g = static_cast<const float*>(db);
  if (need_df && n > n_valid) {
    err = (int)cudaMemsetAsync(dff + (int64_t)n_valid * K, 0,
                               (size_t)(n - n_valid) * K * sizeof(float), st);
    if (err != 0) return err;
  }
  const float* ms = static_cast<const float*>(m_stat);
  const float* ss = static_cast<const float*>(s_stat);
  const float* sr = static_cast<const float*>(s_red);
  if (nonlinear)
    pool_bwd2_rows_kernel<true><<<p.G, NT, p.smem1, st>>>(f, w, ms, ss, g, sr, n_valid, K, C,
                                                           p.tpc, p.zld, need_df, part1, z);
  else
    pool_bwd2_rows_kernel<false><<<p.G, NT, p.smem1, st>>>(f, w, ms, ss, g, sr, n_valid, K, C,
                                                            p.tpc, p.zld, need_df, part1, z);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t P1 = rows_partial_size(C);
  reduce_partials<<<(unsigned)((P1 + 255) / 256), 256, 0, st>>>(part1, p.G, P1,
                                                                 out + (int64_t)D * K);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  pool_bwd2_dw0_kernel<<<dim3(p.slabs, p.S), NT, p.smem2, st>>>(z, p.zld, f, n_valid, K,
                                                                 p.rps, part2);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  reduce_partials<<<(unsigned)(((int64_t)D * K + 255) / 256), 256, 0, st>>>(
      part2, p.S, (int64_t)D * K, out);
  err = (int)cudaGetLastError();
  if (err != 0 || !need_df) return err;
  const int64_t tiles3 = ((int64_t)n_valid + TR3 - 1) / TR3;
  pool_bwd2_df_kernel<<<(unsigned)(tiles3 * p.slabs), NT, p.smem3, st>>>(
      z, static_cast<const float*>(w0), g, n_valid, K, C, dff);
  return (int)cudaGetLastError();
}
