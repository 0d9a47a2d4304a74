// DSMIL attention pooling for one bag, forward and streaming backward, for
// Hopper (K1, K2, K3 of the port).
//
// Replaces the Pallas TPU kernels of tpumil/ops/dsmil_pallas.py:
//   K1  fused_attention_pool (_kernel)   -> pool_logits_kernel,
//                                           pool_attend_kernel + pool_merge_kernel
//   K2  _bwd1_kernel                     -> pool_bwd1_kernel + pool_bwd1_fold_kernel
//   K3  _bwd2_kernel                     -> pool_bwd2_rows_kernel,
//                                           pool_bwd2_dw0_kernel,
//                                           pool_bwd2_df_kernel + reduce_partials
//
// Per bag (feats f [N, K] row-major f32, D = 128, C <= 8 classes):
//   z1 = f W0^T + b0; h = relu(z1); q = tanh(h W2^T + b2)   (nonlinear q)
//   q = z1                                                  (linear q)
//   l = q q_max^T / sqrt(D), rows >= n_valid masked
//   K1: l [N, C], B = softmax_N(l)^T f [C, K] and the softmax stats (m, s)
//   K2: s_red[c] = sum_n A[n,c] (f_n . dB_c), A = exp(l - m) / s from K1's l
//   K3: dl = A (f dB^T - s_red); dF = A dB + dz1 W0, and dW0, db0, dW2, db2,
//       dq_max, recomputing every activation from (m, s) tile by tile.
//
// The TPU kernels recompute the q-MLP in every pass because their residuals
// must stay O(tile) in VMEM. Here K1 keeps the logits (C floats per
// instance), so K2 needs no q-MLP: it is one read of the bag.
//
// What bounds them:
//  * K1's logits pass and K3: arithmetic. Each row costs 2 K D + 2 D^2 FMAs
//    of the q-MLP (+ K3's backward products) against 4 K bytes read, about
//    80 flop per byte at K = 512. At N = 65529, K = 512, C = 2 the q-MLP
//    and logits are 10.9 GFLOP, K3 32.6 GFLOP (24 without dF): 0.066 and
//    0.198 ms as 3xTF32 on the tensor cores (three TF32 products per f32
//    product at 495 TFLOP/s), 0.163 and 0.486 ms in f32 FFMA (67 TFLOP/s).
//  * K1's pool pass and K2: bytes. 2 N C K FMAs against 4 N K bytes: one
//    read of f, 0.040 ms at N = 65529.
//
// The design:
//  * every product of the q-MLP runs on the tensor cores, mma.sync
//    m16n8k8 with tf32 operands, in the 3xTF32 split (x = hi + lo; hi hi +
//    hi lo + lo hi): the counterpart of the TPU kernel's Precision.HIGHEST,
//    f32-level error where one TF32 pass would lose three digits;
//  * K1's logits pass and K3's rows pass share their front half
//    (rows_front): tiles of 128 rows; the feats tile and W0 (K3: [W0; dB],
//    dB's C rows as extra output columns, so z1 and f . dB come from one
//    pass over f) stream through a double-buffered cp.async ring in K
//    chunks of 32; W2 stays resident in shared memory; the logits are one
//    more n-tile of 8 columns (the classes) against q_max;
//  * K1's pool pass and K2 stream the bag once in f32 FFMA, with 16-byte
//    loads along K: exp(l - m) of a chunk of rows is staged in shared
//    memory once per CTA; K1 pools B's columns per thread in registers, K2
//    gives each warp whole rows with dB in shared memory;
//  * K3's dW0 leaves the per-tile loop: the rows pass writes dz1 [N, 128]
//    (and A [N, C] where dF is wanted), and dW0 = dz1^T f is a split-N
//    product, each CTA holding a [128 x 128] slab in registers; dF = dz1 W0
//    + A dB is a third product, launched only when dF is wanted;
//  * every cross-CTA result merges partials in a fixed order, with no float
//    atomics, so a rerun is bitwise equal. Rows >= n_valid are never read:
//    their attention weight is exactly 0, their logits are written as NEG,
//    and K3 writes zeros for their dF rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int D = 128;                // ATTN_DIM
constexpr int NT = 256;               // threads per block
constexpr int CMAX = 8;               // compile-time bound on classes
constexpr float NEG = -1e30f;

struct Weights {
  const float* w0;  // [D, K]
  const float* b0;  // [D]
  const float* w2;  // [D, D] (nonlinear only)
  const float* b2;  // [D]    (nonlinear only)
  const float* qm;  // [C, D]
};

// out[j] = sum_g part[g * M + j], in block order.
__global__ void reduce_partials(const float* __restrict__ part, int G, int64_t M,
                                float* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M) return;
  float a = 0.f;
  for (int g = 0; g < G; ++g) a += part[g * M + j];
  out[j] = a;
}

// Attention weight A = exp(l - m) / max(s, 1e-30).
__device__ __forceinline__ float attn_weight(float l, float m, float s) {
  return expf(l - m) / fmaxf(s, 1e-30f);
}

// ------------------------------------------------- the rows passes (K1, K3) ---
// K1's logits pass (pool_logits_kernel) and K3's rows pass
// (pool_bwd2_rows_kernel) share their front half, rows_front.
//
// K3, three passes, all on the tensor cores in 3xTF32 (see the note at the
// top):
//   rows  (pool_bwd2_rows_kernel, G CTAs, tiles of TR rows): recompute z1,
//         h, q, A; dl, dz2, dz1; dz1 (and A where dF is wanted) to the
//         scratch Z [rows, zld]; per-CTA partials of db0, dW2, db2, dq_max.
//   dW0   (pool_bwd2_dw0_kernel, D x 128 slabs x S row splits): dz1^T f as
//         a split-N product, one [D, 128] slab per CTA in registers.
//   dF    (pool_bwd2_df_kernel, only when dF is wanted): [dz1 | A] times
//         [W0; dB] over tiles of 64 rows x 128 columns.
// Partials are summed by reduce_partials in a fixed order (no atomics).

namespace k3 {
constexpr int TR = 128;              // rows per tile of the rows passes
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

// Shared memory of the rows passes (floats):
//   ring [RING] (aliased by sG [TR][LDA]: q, then K3's dz2 / dz1)
//   | sH [TR][LDA] | sW2 [D][LDA] (nonlinear only)
//   | sQm [CMAX][LDA] | sDa [TR][CMAX] | sL [TR][CMAX] (logits; K3's dl)
__host__ __device__ __forceinline__ size_t rows_smem_floats(bool nl) {
  return (size_t)RING + (nl ? 2 * (size_t)ACT : 0) + (size_t)CMAX * LDA + 2 * (size_t)CMAX * TR;
}
}  // namespace k3

struct RowsSmem {
  float *ring, *sH, *sW2, *sQm, *sDa, *sL;
};

template <bool NL>
__device__ __forceinline__ RowsSmem rows_smem(float* base) {
  using namespace k3;
  RowsSmem s;
  s.ring = base;
  s.sH = base + RING;
  s.sW2 = s.sH + ACT;
  s.sQm = NL ? s.sW2 + ACT : s.sH;
  s.sDa = s.sQm + CMAX * LDA;
  s.sL = s.sDa + TR * CMAX;
  return s;
}

// The resident weights of the rows passes: W2 -> sW2 [D][LDA] (nonlinear)
// and q_max -> sQm [CMAX][LDA], classes >= C zero.
template <bool NL>
__device__ __forceinline__ void load_resident(const Weights& w, int C, const RowsSmem& sm) {
  using namespace k3;
  for (int e = threadIdx.x; e < CMAX * D; e += NT)
    sm.sQm[(e / D) * LDA + e % D] = e < C * D ? w.qm[e] : 0.f;
  if constexpr (NL)
    for (int e = threadIdx.x; e < D * D; e += NT) sm.sW2[(e / D) * LDA + e % D] = w.w2[e];
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
// (rows >= rows and columns >= K zero) and of the NCOL weight rows into
// sB [NCOL][LDK]: W0 (NCOL = D), or [W0; dB; 0] (NCOL = NB).
template <int NCOL>
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
  for (int e = threadIdx.x; e < NCOL * V; e += NT) {
    const int n = e / V, k = k0 + 4 * (e % V);
    const bool ok = k < K && n < D + C;
    const float* src = n < D ? w0 + (int64_t)n * K + k : db + (int64_t)(n - D) * K + k;
    cp16(sB + n * k3::LDK + (k - k0), ok ? src : w0, ok);
  }
}

// The front half of the rows passes, for the tile of rows [row0, row0 +
// rows): z1 = f W0^T + b0 streamed over K through the ring (NCOL = NB also
// gives da = f dB^T -> sDa); h = relu(z1) -> sH and q = tanh(h W2^T + b2)
// (nonlinear) or q = z1 (linear) -> sG (the ring); the logits l = q q_max^T
// / sqrt(D) -> sL [TR][CMAX], rows >= rows at NEG. Warp w owns rows
// [16 w, 16 w + 16) of every product. Starts and ends with a barrier.
template <bool NL, int NCOL>
__device__ __forceinline__ void rows_front(const float* __restrict__ feats, const Weights& w,
                                           const float* __restrict__ db, int64_t row0,
                                           int rows, int K, int C, const RowsSmem& sm) {
  using namespace k3;
  constexpr int STAGE = (TR + NCOL) * LDK;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // this warp's first row
  const int nch = (K + KC - 1) / KC;
  float* sG = sm.ring;
  __syncthreads();  // the previous tile's sG and sL are consumed

  float acc[NCOL / 8][4];
#pragma unroll
  for (int j = 0; j < NCOL / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  stage_rows_chunk<NCOL>(sm.ring, sm.ring + TR * LDK, feats, w.w0, db, row0, rows, K, C, 0);
  cp_commit();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      float* nxt = sm.ring + ((ch + 1) & 1) * STAGE;
      stage_rows_chunk<NCOL>(nxt, nxt + TR * LDK, feats, w.w0, db, row0, rows, K, C,
                             (ch + 1) * KC);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sF = sm.ring + (ch & 1) * STAGE;
    const float* sB = sF + TR * LDK;
#pragma unroll 1
    for (int ks = 0; ks < KC; ks += 8) {
      uint32_t ah[4], al[4];
      frag_a<LDK, 1>(ah, al, sF + wr * LDK + ks);
#pragma unroll
      for (int j = 0; j < NCOL / 8; ++j) {
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
      if constexpr (NL) sm.sH[r * LDA + d] = fmaxf(z1, 0.f);
      else sG[r * LDA + d] = z1;
    }
  if constexpr (NCOL > D) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sm.sDa[(wr + g + (i >> 1) * 8) * CMAX + 2 * t + (i & 1)] = acc[D / 8][i];
  }
  __syncthreads();

  if constexpr (NL) {  // q = tanh(h W2^T + b2) -> sG
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < D; ks += 8) {
      uint32_t ah[4], al[4];
      frag_a<LDA, 1>(ah, al, sm.sH + wr * LDA + ks);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t bh[2], bl[2];
        frag_b<1, LDA>(bh, bl, sm.sW2 + j * 8 * LDA + ks);
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

  // l = q q_max^T / sqrt(D): one n-tile of 8 columns (the classes), each
  // warp over its own rows. B(k, c) = sQm[c][k]; classes >= C are zero.
  float lg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int ks = 0; ks < D; ks += 8) {
    uint32_t ah[4], al[4], bh[2], bl[2];
    frag_a<LDA, 1>(ah, al, sG + wr * LDA + ks);
    frag_b<1, LDA>(bh, bl, sm.sQm + ks);
    mma3(lg, ah, al, bh, bl);
  }
  const float scale = 1.f / sqrtf((float)D);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = wr + g + (i >> 1) * 8;
    sm.sL[r * CMAX + 2 * t + (i & 1)] = r < rows ? lg[i] * scale : NEG;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- K1 ---
// Two passes and a merge:
//   logits (pool_logits_kernel, G1 CTAs, tiles of TR rows on the tensor
//          cores): the masked logits l [n, C] and each CTA's max cmax [G1, C];
//   pool   (pool_attend_kernel, row blocks x column chunks): with m = max
//          of cmax, p = exp(l - m) and per-CTA partials of s = sum p and
//          acc = p^T f, one read of f in f32 FFMA;
//   merge  (pool_merge_kernel): B = sum acc / s, s, m, in a fixed order.

template <bool NL>
__global__ void __launch_bounds__(NT, 1) pool_logits_kernel(
    const float* __restrict__ feats, Weights w, int n, int n_valid, int K, int C, int tpc,
    float* __restrict__ logits, float* __restrict__ cmax) {
  using namespace k3;
  extern __shared__ float4 smem4[];
  const RowsSmem sm = rows_smem<NL>(reinterpret_cast<float*>(smem4));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  load_resident<NL>(w, C, sm);
  float mx = NEG;  // warps c < C: this CTA's max of class c
  const int tiles = (n_valid + TR - 1) / TR;
  const int t_begin = min((int)blockIdx.x * tpc, tiles), t_end = min(t_begin + tpc, tiles);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int64_t row0 = (int64_t)tile * TR;
    const int rows = min(TR, (int)(n_valid - row0));
    rows_front<NL, D>(feats, w, nullptr, row0, rows, K, C, sm);
    const int stored = (int)min((int64_t)TR, (int64_t)n - row0) * C;
    for (int e = tid; e < stored; e += NT) logits[row0 * C + e] = sm.sL[(e / C) * CMAX + e % C];
    if (warp < C)
      for (int r = lane; r < TR; r += 32) mx = fmaxf(mx, sm.sL[r * CMAX + warp]);
  }
  // rows past the last tile (n > tiles * TR) are padding too
  for (int64_t e = (int64_t)tiles * TR * C + (int64_t)blockIdx.x * NT + tid; e < (int64_t)n * C;
       e += (int64_t)gridDim.x * NT)
    logits[e] = NEG;
  if (warp < C) {
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) cmax[blockIdx.x * C + warp] = mx;
  }
}

// the streaming passes (K1's pool pass, K2)
constexpr int PR = NT;               // rows per staged chunk of weights
constexpr int KCH = 4 * NT;          // columns of f per CTA

// p = exp(l - m) of rows [r0, r0 + nr) -> sP [PR][CMAX], one row per
// thread; each thread adds its rows' p to ps.
__device__ __forceinline__ void stage_weights(float* sP, const float* __restrict__ logits,
                                              const float* sM, int64_t r0, int nr, int C,
                                              float (&ps)[CMAX]) {
  const int r = threadIdx.x;
  if (r < nr) {
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) {
        const float p = expf(logits[(r0 + r) * C + c] - sM[c]);
        sP[r * CMAX + c] = p;
        ps[c] += p;
      }
  }
}

// Sum of v over the warp; every lane ends with the same value.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// CTA (bx, by) takes rows [bx rpb, + rpb) and float4 columns [by NT, + NT)
// of f. A row slot of W threads reads one row, thread (slot, x) its float4
// column 4 (by NT + x); slots take rows slot, slot + slots, ... Partial
// layout per row block: acc [C][K] | m [CMAX] | s [CMAX] (16-byte aligned).
// Shared memory: sP [PR][CMAX] | sAcc [slots - 1][C][W] float4.
__global__ void __launch_bounds__(NT) pool_attend_kernel(
    const float* __restrict__ feats, const float* __restrict__ logits,
    const float* __restrict__ cmax, int G1, int n_valid, int K, int C, int rpb,
    float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* sP = reinterpret_cast<float*>(smem4);
  float4* sAcc = smem4 + PR * CMAX / 4;
  __shared__ float sM[CMAX], sS[NT / 32][CMAX];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (warp == 0)  // m = the max of the logits pass's CTA maxima (exact in any order)
    for (int c = 0; c < C; ++c) {
      float mx = NEG;
      for (int g = lane; g < G1; g += 32) mx = fmaxf(mx, cmax[g * C + c]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) sM[c] = mx;
    }
  const int W = min(K / 4 - (int)blockIdx.y * NT, NT), slots = NT / W;
  const int slot = tid / W, x = tid % W, k4 = blockIdx.y * NT + x;
  const int64_t r_begin = (int64_t)blockIdx.x * rpb;
  const int64_t r_end = min((int64_t)n_valid, r_begin + rpb);
  float acc[CMAX][4], ps[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    ps[c] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
  }
  for (int64_t r0 = r_begin; r0 < r_end; r0 += PR) {
    const int nr = (int)min((int64_t)PR, r_end - r0);
    __syncthreads();  // sM is set; the previous chunk's sP is consumed
    stage_weights(sP, logits, sM, r0, nr, C, ps);
    __syncthreads();
    if (slot < slots) {
      const float* f = feats + r0 * K + 4 * k4;
#pragma unroll 4
      for (int r = slot; r < nr; r += slots) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(f + (int64_t)r * K));
#pragma unroll
        for (int c = 0; c < CMAX; ++c)
          if (c < C) {
            const float p = sP[r * CMAX + c];
            acc[c][0] = fmaf(p, v.x, acc[c][0]);
            acc[c][1] = fmaf(p, v.y, acc[c][1]);
            acc[c][2] = fmaf(p, v.z, acc[c][2]);
            acc[c][3] = fmaf(p, v.w, acc[c][3]);
          }
      }
    }
  }
  // this CTA's partial: acc summed over the slots in order; s over the
  // threads in a fixed order (written by the first column chunk)
  if (slot >= 1 && slot < slots)
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C)
        sAcc[((slot - 1) * C + c) * W + x] = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) {
      const float v = warp_sum(ps[c]);
      if (lane == 0) sS[warp][c] = v;
    }
  __syncthreads();
  float* out = part + (int64_t)blockIdx.x * ((int64_t)C * K + 2 * CMAX);
  if (slot == 0)
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) {
        float4 a = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
        for (int sl = 1; sl < slots; ++sl) {
          const float4 b = sAcc[((sl - 1) * C + c) * W + x];
          a.x += b.x;
          a.y += b.y;
          a.z += b.z;
          a.w += b.w;
        }
        *reinterpret_cast<float4*>(out + (int64_t)c * K + 4 * k4) = a;
      }
  if (blockIdx.y == 0 && tid < C) {
    float s = 0.f;
    for (int wi = 0; wi < NT / 32; ++wi) s += sS[wi][tid];
    out[(int64_t)C * K + tid] = sM[tid];
    out[(int64_t)C * K + CMAX + tid] = s;
  }
}

// B = sum_g acc_g / max(sum_g s_g, 1e-30), m, s = sum_g s_g over the G row
// blocks. CTA (bx, c) takes columns [32 bx, + 32) of class c; thread (j =
// tid / 32, x = tid % 32) sums the partials g = j, j + 8, ... in order, then
// thread j = 0 the 8 slices in order.
__global__ void __launch_bounds__(NT) pool_merge_kernel(const float* __restrict__ part, int G,
                                                        int K, int C, float* __restrict__ out_b,
                                                        float* __restrict__ out_m,
                                                        float* __restrict__ out_s) {
  constexpr int SL = NT / 32;
  __shared__ float sA[SL][32], sS[SL];
  const int c = blockIdx.y, j = threadIdx.x >> 5, x = threadIdx.x & 31;
  const int k = blockIdx.x * 32 + x;
  const int64_t ps = (int64_t)C * K + 2 * CMAX;
  float a = 0.f, s = 0.f;
  for (int g = j; g < G; g += SL) {
    const float* pg = part + g * ps;
    if (k < K) a += pg[(int64_t)c * K + k];
    s += pg[(int64_t)C * K + CMAX + c];
  }
  sA[j][x] = a;
  if (x == 0) sS[j] = s;
  __syncthreads();
  if (j != 0) return;
  a = 0.f;
  s = 0.f;
  for (int i = 0; i < SL; ++i) {
    a += sA[i][x];
    s += sS[i];
  }
  if (k < K) out_b[c * K + k] = a / fmaxf(s, 1e-30f);
  if (blockIdx.x == 0 && x == 0) {
    out_m[c] = part[(int64_t)C * K + c];
    out_s[c] = s;
  }
}

// ---------------------------------------------------------------- K2 ---
// s_red[c] = sum_n exp(l[n,c] - m_c) (f_n . dB_c) / max(s_c, 1e-30): one
// read of f, no q-MLP. CTA (bx, by) takes rows [bx rpb, + rpb) and columns
// [by KCH, + KCH) of f and dB (f . dB is a sum over column chunks); warp w
// takes rows w, w + 8, ... of each staged chunk, lane l the float4 columns
// l, l + 32, ..., and sums p (f . dB) over its rows and columns. Per-CTA
// partials [G][C], divided by s, are folded by pool_bwd1_fold_kernel.
// Shared memory: sP [PR][CMAX] | sDB [C][kc].
__global__ void __launch_bounds__(NT) pool_bwd1_kernel(
    const float* __restrict__ feats, const float* __restrict__ logits,
    const float* __restrict__ m_stat, const float* __restrict__ s_stat,
    const float* __restrict__ db, int n_valid, int K, int C, int rpb,
    float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* sP = reinterpret_cast<float*>(smem4);
  const float4* sDB = smem4 + PR * CMAX / 4;
  __shared__ float sM[CMAX], sR[NT / 32][CMAX];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.y * KCH, kv = min(KCH, K - k0) / 4;
  for (int e = tid; e < C * kv; e += NT)
    smem4[PR * CMAX / 4 + e] =
        *reinterpret_cast<const float4*>(db + (int64_t)(e / kv) * K + k0 + 4 * (e % kv));
  if (tid < C) sM[tid] = m_stat[tid];
  const int64_t r_begin = (int64_t)blockIdx.x * rpb;
  const int64_t r_end = min((int64_t)n_valid, r_begin + rpb);
  float red[CMAX], ps[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) red[c] = ps[c] = 0.f;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += PR) {
    const int nr = (int)min((int64_t)PR, r_end - r0);
    __syncthreads();  // sM and sDB are set; the previous chunk's sP is consumed
    stage_weights(sP, logits, sM, r0, nr, C, ps);
    __syncthreads();
#pragma unroll 2
    for (int r = warp; r < nr; r += NT / 32) {
      const float4* f = reinterpret_cast<const float4*>(feats + (r0 + r) * K + k0);
      float d[CMAX];
#pragma unroll
      for (int c = 0; c < CMAX; ++c) d[c] = 0.f;
#pragma unroll 4
      for (int v = lane; v < kv; v += 32) {
        const float4 x = __ldg(f + v);
#pragma unroll
        for (int c = 0; c < CMAX; ++c)
          if (c < C) {
            const float4 b = sDB[c * kv + v];
            d[c] = fmaf(x.x, b.x, d[c]);
            d[c] = fmaf(x.y, b.y, d[c]);
            d[c] = fmaf(x.z, b.z, d[c]);
            d[c] = fmaf(x.w, b.w, d[c]);
          }
      }
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) red[c] = fmaf(sP[r * CMAX + c], d[c], red[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) {
      const float v = warp_sum(red[c]);
      if (lane == 0) sR[warp][c] = v;
    }
  __syncthreads();
  if (tid < C) {
    float a = 0.f;
    for (int wi = 0; wi < NT / 32; ++wi) a += sR[wi][tid];
    part[((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * C + tid] = a / fmaxf(s_stat[tid], 1e-30f);
  }
}

// out[c] = sum_g part[g][c]: thread (j = tid / CMAX, c = tid % CMAX) sums
// g = j, j + NT / CMAX, ... in order, then thread c the slices in order.
__global__ void __launch_bounds__(NT) pool_bwd1_fold_kernel(const float* __restrict__ part,
                                                            int G, int C,
                                                            float* __restrict__ out) {
  constexpr int SL = NT / CMAX;
  __shared__ float sR[NT];
  const int tid = threadIdx.x, j = tid / CMAX, c = tid % CMAX;
  float a = 0.f;
  if (c < C)
    for (int g = j; g < G; g += SL) a += part[(int64_t)g * C + c];
  sR[tid] = a;
  __syncthreads();
  if (tid < C) {
    a = 0.f;
    for (int i = 0; i < SL; ++i) a += sR[i * CMAX + tid];
    out[tid] = a;
  }
}

// ---------------------------------------------------------------- K3 ---
// The rows pass: rows_front, then A, dl, dq_max, the MLP's backward. Warp w
// owns rows [16 w, 16 w + 16) of every [TR, *] product and rows [16 w, 16 w
// + 16) of dW2. Shared memory: rows_smem (sL holds dl after the logits).
template <bool NL>
__global__ void __launch_bounds__(NT, 1) pool_bwd2_rows_kernel(
    const float* __restrict__ feats, Weights w, const float* __restrict__ m_stat,
    const float* __restrict__ s_stat, const float* __restrict__ db,
    const float* __restrict__ s_red, int n_valid, int K, int C, int tpc, int zld,
    int write_a, float* __restrict__ part, float* __restrict__ z) {
  using namespace k3;
  extern __shared__ float4 smem4[];
  const RowsSmem sm = rows_smem<NL>(reinterpret_cast<float*>(smem4));
  float* sG = sm.ring;
  float* sH = sm.sH;
  const float* sW2 = sm.sW2;
  const float* sQm = sm.sQm;
  float* sDl = sm.sL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;            // this warp's first row (or dW2 row)
  const float scale = 1.f / sqrtf((float)D);

  load_resident<NL>(w, C, sm);

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
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int64_t row0 = (int64_t)tile * TR;
    const int rows = min(TR, (int)(n_valid - row0));
    rows_front<NL, NB>(feats, w, db, row0, rows, K, C, sm);

    // A and dl = A (f . dB - s_red) per (row, class), dl over the logits
    // in sL; A to Z
    for (int e = tid; e < TR * C; e += NT) {
      const int r = e / C, c = e % C;
      float a = 0.f, dl = 0.f;
      if (r < rows) {
        a = attn_weight(sm.sL[r * CMAX + c], m_stat[c], s_stat[c]);
        dl = a * (sm.sDa[r * CMAX + c] - s_red[c]);
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
        const float4 qm = *reinterpret_cast<const float4*>(sQm + c * LDA + d);
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
      float acc[D / 8][4];
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

// Row blocks of the streaming passes (K1's pool pass, K2): about four CTAs
// per SM, at least 32 rows each.
void stream_rows(int n_valid, int* rpb, int* blocks) {
  const int want = 4 * sm_count();
  const int per = (n_valid + want - 1) / want;
  *rpb = per > 32 ? per : 32;
  *blocks = (n_valid + *rpb - 1) / *rpb;
}

// K1's launch shapes and scratch (floats): part [G2, C K + 2 CMAX] |
// cmax [G1, C].
struct FwdPlan {
  int G1, tpc, G2, rpb, chunks;
  int64_t part, cmax;
  size_t smem1, smem2;
  const void* logits_kernel;
};

int fwd_plan(int nonlinear, int n, int n_valid, int K, int C, FwdPlan* p) {
  using namespace k3;
  if (bad_args(n, n_valid, K, C)) return (int)cudaErrorInvalidValue;
  const bool nl = nonlinear != 0;
  p->logits_kernel = nl ? (const void*)pool_logits_kernel<true>
                        : (const void*)pool_logits_kernel<false>;
  p->smem1 = rows_smem_floats(nl) * sizeof(float);
  if (p->smem1 > (size_t)smem_limit()) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(p->logits_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem1);
  if (err != 0) return err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p->logits_kernel, NT,
                                                           p->smem1);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (n_valid + TR - 1) / TR;
  const int gmax = per_sm * sm_count();
  p->tpc = (tiles + gmax - 1) / gmax;
  p->G1 = (tiles + p->tpc - 1) / p->tpc;
  stream_rows(n_valid, &p->rpb, &p->G2);
  p->chunks = (K / 4 + NT - 1) / NT;
  p->smem2 = ((size_t)PR * CMAX + (size_t)C * NT * 4) * sizeof(float);
  p->part = (int64_t)p->G2 * ((int64_t)C * K + 2 * CMAX);
  p->cmax = (int64_t)p->G1 * C;
  return 0;
}

// K2's launch shape and scratch (floats): part [G * chunks, C].
struct Bwd1Plan {
  int G, rpb, chunks;
  int64_t part;
  size_t smem;
};

int bwd1_plan(int n, int n_valid, int K, int C, Bwd1Plan* p) {
  if (bad_args(n, n_valid, K, C)) return (int)cudaErrorInvalidValue;
  stream_rows(n_valid, &p->rpb, &p->G);
  p->chunks = (K + KCH - 1) / KCH;
  p->smem = ((size_t)PR * CMAX + (size_t)C * (K < KCH ? K : KCH)) * sizeof(float);
  p->part = (int64_t)p->G * p->chunks * C;
  return 0;
}

}  // namespace

// Floats of scratch that K1 needs, or -(CUDA error code).
extern "C" long long tpumil_attention_pool_fwd_scratch(int nonlinear, int n, int n_valid, int K,
                                                       int C) {
  FwdPlan p;
  const int err = fwd_plan(nonlinear, n, n_valid, K, C, &p);
  if (err != 0) return -(long long)err;
  return (long long)(p.part + p.cmax);
}

// K1. scratch: tpumil_attention_pool_fwd_scratch floats. Outputs B [C, K],
// m [C], s [C] and the masked logits [n, C] (rows >= n_valid at -1e30).
extern "C" int tpumil_attention_pool_fwd(const void* feats, const void* w0, const void* b0,
                                         const void* w2, const void* b2, const void* qm,
                                         int n, int n_valid, int K, int C, int nonlinear,
                                         void* scratch, void* out_b, void* out_m, void* out_s,
                                         void* logits, void* stream) {
  FwdPlan p;
  int err = fwd_plan(nonlinear, n, n_valid, K, C, &p);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights w = weights(w0, b0, w2, b2, qm);
  const float* f = static_cast<const float*>(feats);
  float* part = static_cast<float*>(scratch);
  float* cmax = part + p.part;
  float* l = static_cast<float*>(logits);
  if (nonlinear)
    pool_logits_kernel<true><<<p.G1, NT, p.smem1, st>>>(f, w, n, n_valid, K, C, p.tpc, l, cmax);
  else
    pool_logits_kernel<false><<<p.G1, NT, p.smem1, st>>>(f, w, n, n_valid, K, C, p.tpc, l, cmax);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  pool_attend_kernel<<<dim3(p.G2, p.chunks), NT, p.smem2, st>>>(f, l, cmax, p.G1, n_valid, K, C,
                                                                 p.rpb, part);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  pool_merge_kernel<<<dim3((K + 31) / 32, C), NT, 0, st>>>(
      part, p.G2, K, C, static_cast<float*>(out_b), static_cast<float*>(out_m),
      static_cast<float*>(out_s));
  return (int)cudaGetLastError();
}

// Floats of scratch that K2 needs, or -(CUDA error code).
extern "C" long long tpumil_attention_pool_bwd1_scratch(int n, int n_valid, int K, int C) {
  Bwd1Plan p;
  const int err = bwd1_plan(n, n_valid, K, C, &p);
  if (err != 0) return -(long long)err;
  return (long long)p.part;
}

// K2. scratch: tpumil_attention_pool_bwd1_scratch floats. Output s_red [C].
extern "C" int tpumil_attention_pool_bwd1(const void* feats, const void* logits,
                                          const void* m_stat, const void* s_stat,
                                          const void* db, int n, int n_valid, int K, int C,
                                          void* scratch, void* s_red, void* stream) {
  Bwd1Plan p;
  int err = bwd1_plan(n, n_valid, K, C, &p);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  pool_bwd1_kernel<<<dim3(p.G, p.chunks), NT, p.smem, st>>>(
      static_cast<const float*>(feats), static_cast<const float*>(logits),
      static_cast<const float*>(m_stat), static_cast<const float*>(s_stat),
      static_cast<const float*>(db), n_valid, K, C, p.rpb, part);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  pool_bwd1_fold_kernel<<<1, NT, 0, st>>>(part, p.G * p.chunks, C, static_cast<float*>(s_red));
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
