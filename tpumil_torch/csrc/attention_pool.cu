// DSMIL attention pooling for one bag, forward and streaming backward, for
// Hopper (K1, K2, K3 of the port).
//
// Replaces the Pallas TPU kernels of tpumil/ops/dsmil_pallas.py:
//   K1  fused_attention_pool (_kernel)   -> pool_fwd_kernel + pool_merge_kernel
//   K2  _bwd1_kernel                     -> pool_bwd1_kernel + reduce_partials
//   K3  _bwd2_kernel                     -> pool_bwd2_kernel + reduce_partials
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
// What bounds it: arithmetic. Each row costs 2 K D + 2 D^2 (+ the backward's
// three more products) FMAs against 4 K bytes read, about 80 flop per byte
// at K = 512, above the card's f32 balance point. The products run in true
// f32 on the CUDA cores (FFMA): the TPU kernel pins its f32 dots to HIGHEST,
// so TF32 tensor cores are not used here.
//
// Design (simple first): the TPU grid walks one bag serially over N. Here
// the valid rows are split across G blocks (at most what fits on the card at
// once); each block walks its rows in tiles of T = 32 rows staged in shared
// memory (64 KB at K = 512). Weights stream through a padded shared-memory
// chunk of 32 x 128 floats. Each block writes partials (K1: its own m, s and
// acc [C, K]; K2/K3: its partial sums) and a second small kernel merges them
// in a fixed block order, so a rerun is bitwise equal (no float atomics).
// Rows >= n_valid are never read: their attention weight is exactly 0, and
// K3 writes zeros for their dF rows.

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
// Per-block partial sums in global memory, P floats per block:
//   dW0 [D*K] | db0 [D] | dW2 [D*D] | db2 [D] | dqm [C*D]
// Shared memory: sF [T*K] | sM [IC*LDM] | sH [T*D] | sQ [T*D] | sG [T*D]
//                | sQm [C*D] | sL [T*CMAX] | sDl [T*CMAX] | sDB [C*K]
__host__ __device__ __forceinline__ int64_t bwd2_partial_size(int K, int C) {
  return (int64_t)D * K + D + D * D + D + C * D;
}

// part[(d0 + dd) * ldo + j] += sum_r sA[r * D + d0 + dd] * sB[r * ldb + j] for
// dd < 64, j = j0 + tid % D (if j < J), d0 = (tid / D) * 64: a [D, J] outer
// product accumulated over the tile's T rows.
__device__ __forceinline__ void outer_accumulate(float* __restrict__ part, int ldo,
                                                 const float* sA, const float* sB, int ldb,
                                                 int J, int j0) {
  constexpr int DD = D / (NT / D);  // 64 rows of the gradient per thread
  const int j = j0 + threadIdx.x % D, d0 = (threadIdx.x / D) * DD;
  if (j >= J) return;
  float a[DD];
#pragma unroll
  for (int dd = 0; dd < DD; ++dd) a[dd] = 0.f;
  for (int r = 0; r < T; ++r) {
    const float bv = sB[r * ldb + j];
#pragma unroll
    for (int dd = 0; dd < DD; ++dd) a[dd] = fmaf(sA[r * D + d0 + dd], bv, a[dd]);
  }
#pragma unroll
  for (int dd = 0; dd < DD; ++dd) part[(int64_t)(d0 + dd) * ldo + j] += a[dd];
}

template <bool NL>
__global__ void __launch_bounds__(NT) pool_bwd2_kernel(
    const float* __restrict__ feats, Weights w, const float* __restrict__ m_stat,
    const float* __restrict__ s_stat, const float* __restrict__ db,
    const float* __restrict__ s_red, int n_valid, int K, int C, int tpc,
    float* __restrict__ part, float* __restrict__ df) {
  extern __shared__ float4 smem4[];
  float* sF = reinterpret_cast<float*>(smem4);
  float* sM = sF + T * K;
  float* sH = sM + IC * LDM;
  float* sQ = sH + T * D;
  float* sG = sQ + T * D;
  float* sQm = sG + T * D;
  float* sL = sQm + C * D;
  float* sDl = sL + T * CMAX;
  float* sDB = sDl + T * CMAX;
  const int tid = threadIdx.x;
  const int col = tid % D, r0 = (tid / D) * RPT;
  const float scale = 1.f / sqrtf((float)D);
  const int64_t P = bwd2_partial_size(K, C);
  float* pw0 = part + (int64_t)blockIdx.x * P;
  float* pb0 = pw0 + (int64_t)D * K;
  float* pw2 = pb0 + D;
  float* pb2 = pw2 + D * D;
  float* pqm = pb2 + D;
  for (int64_t e = tid; e < P; e += NT) pw0[e] = 0.f;
  for (int e = tid; e < C * D; e += NT) sQm[e] = w.qm[e];
  for (int e = tid; e < C * K; e += NT) sDB[e] = db[e];
  const Range rg = block_tiles(n_valid, tpc);
  for (int t = rg.t_begin; t < rg.t_end; ++t) {
    const int64_t row0 = (int64_t)t * T;
    const int rows = min(T, (int)(n_valid - row0));
    __syncthreads();
    load_tile(sF, feats, row0, rows, K);
    recompute<NL>(sF, K, w, C, rows, sQm, sH, sQ, sL, sM);
    // A (over sL) and dl = A (f . dB - s_red)
    for (int e = tid; e < T * C; e += NT) {
      const int r = e / C, c = e % C;
      float a = 0.f, dl = 0.f;
      if (r < rows) {
        a = attn_weight(sL[r * CMAX + c], m_stat[c], s_stat[c]);
        float da = 0.f;
        for (int k = 0; k < K; ++k) da = fmaf(sF[r * K + k], sDB[c * K + k], da);
        dl = a * (da - s_red[c]);
      }
      sL[r * CMAX + c] = a;
      sDl[r * CMAX + c] = dl;
    }
    __syncthreads();
    // dq = scale dl q_max; nonlinear: dz2 = dq (1 - q^2) -> sG; linear: dz1 = dq -> sG
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int rr = r0 + r;
      float dq = 0.f;
      for (int c = 0; c < C; ++c) dq = fmaf(sDl[rr * CMAX + c], sQm[c * D + col], dq);
      dq *= scale;
      if (NL) {
        const float q = sQ[rr * D + col];
        dq *= (1.f - q * q);
      }
      sG[rr * D + col] = dq;
    }
    // dq_max += scale dl^T q
    for (int e = tid; e < C * D; e += NT) {
      const int c = e / D, d = e % D;
      float a = 0.f;
      for (int r = 0; r < T; ++r) a = fmaf(sDl[r * CMAX + c], sQ[r * D + d], a);
      pqm[e] += a * scale;
    }
    __syncthreads();
    float* sZ1g = sG;  // dz1
    if (NL) {
      outer_accumulate(pw2, D, sG, sH, D, D, 0);  // dW2 += dz2^T h
      if (tid < D) {
        float a = 0.f;
        for (int r = 0; r < T; ++r) a += sG[r * D + tid];
        pb2[tid] += a;
      }
      float acc[RPT];
      tile_product(acc, sG, D, w.w2, false, D, D, 0, sM);  // dh = dz2 W2
      // dz1 = dh * (z1 > 0) -> sQ (q is no longer read)
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int rr = r0 + r;
        sQ[rr * D + col] = sH[rr * D + col] > 0.f ? acc[r] : 0.f;
      }
      __syncthreads();
      sZ1g = sQ;
    }
    if (tid < D) {
      float a = 0.f;
      for (int r = 0; r < T; ++r) a += sZ1g[r * D + tid];
      pb0[tid] += a;
    }
    for (int j0 = 0; j0 < K; j0 += D) outer_accumulate(pw0, K, sZ1g, sF, K, K, j0);
    // dF = A dB + dz1 W0 for the tile's rows
    for (int j0 = 0; j0 < K; j0 += D) {
      float acc[RPT];
      tile_product(acc, sZ1g, D, w.w0, false, D, K, j0, sM);
      const int k = j0 + col;
      if (k < K) {
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int rr = r0 + r;
          if (rr < rows) {
            float v = acc[r];
            for (int c = 0; c < C; ++c) v = fmaf(sL[rr * CMAX + c], sDB[c * K + k], v);
            df[(row0 + rr) * K + k] = v;
          }
        }
      }
    }
  }
}

size_t smem_bytes(int which, int K, int C) {
  size_t f = (size_t)T * K + IC * LDM + (size_t)C * D + T * CMAX;
  if (which == 1) f += T * D + (size_t)C * K + 3 * CMAX;
  else if (which == 2) f += T * D + (size_t)C * K + CMAX * NT;
  else f += 3 * T * D + T * CMAX + (size_t)C * K;
  return f * sizeof(float);
}

const void* kernel_of(int which, bool nl) {
  if (which == 1) return nl ? (const void*)pool_fwd_kernel<true> : (const void*)pool_fwd_kernel<false>;
  if (which == 2) return nl ? (const void*)pool_bwd1_kernel<true> : (const void*)pool_bwd1_kernel<false>;
  return nl ? (const void*)pool_bwd2_kernel<true> : (const void*)pool_bwd2_kernel<false>;
}

// Checks shared by every entry point; sets the kernel's shared-memory limit.
int prepare(int which, int nonlinear, int n, int n_valid, int K, int C, size_t* smem) {
  if (which < 1 || which > 3 || K <= 0 || K % 4 != 0 || C < 1 || C > CMAX ||
      n_valid < 1 || n_valid > n)
    return (int)cudaErrorInvalidValue;
  *smem = smem_bytes(which, K, C);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (*smem > (size_t)limit) return (int)cudaErrorInvalidValue;
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

}  // namespace

// Number of blocks G to launch for kernel `which` (1 = forward, 2 = backward
// pass 1, 3 = backward pass 2): at most the blocks the card holds at once,
// at most one per tile. Returns G > 0, or -(CUDA error code).
extern "C" int tpumil_attention_pool_grid(int which, int nonlinear, int n, int n_valid,
                                          int K, int C) {
  size_t smem = 0;
  int err = prepare(which, nonlinear, n, n_valid, K, C, &smem);
  if (err != 0) return -err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_of(which, nonlinear != 0), NT, smem);
  if (err != 0) return -err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const int tiles = (n_valid + T - 1) / T;
  const int gmax = per_sm * sms;
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

// Size of K3's per-block partial sums and of its packed gradient output.
extern "C" long long tpumil_attention_pool_bwd2_size(int K, int C) {
  return (long long)bwd2_partial_size(K, C);
}

// K3. part: G * P floats of scratch (P from tpumil_attention_pool_bwd2_size).
// Outputs dF [n, K] (rows >= n_valid set to 0) and grads [P] packed as
// dW0 [D, K] | db0 [D] | dW2 [D, D] | db2 [D] | dq_max [C, D].
extern "C" int tpumil_attention_pool_bwd2(const void* feats, const void* w0, const void* b0,
                                          const void* w2, const void* b2, const void* qm,
                                          const void* m_stat, const void* s_stat,
                                          const void* db, const void* s_red, int n,
                                          int n_valid, int K, int C, int nonlinear, int G,
                                          void* part, void* df, void* grads, void* stream) {
  size_t smem = 0;
  int err = prepare(3, nonlinear, n, n_valid, K, C, &smem);
  if (err != 0 || G < 1) return err != 0 ? err : (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights w = weights(w0, b0, w2, b2, qm);
  const int tpc = tiles_per_block(n_valid, G);
  const float* f = static_cast<const float*>(feats);
  const float* ms = static_cast<const float*>(m_stat);
  const float* ss = static_cast<const float*>(s_stat);
  const float* g = static_cast<const float*>(db);
  const float* sr = static_cast<const float*>(s_red);
  float* p = static_cast<float*>(part);
  float* dff = static_cast<float*>(df);
  if (n > n_valid) {
    err = (int)cudaMemsetAsync(dff + (int64_t)n_valid * K, 0,
                               (size_t)(n - n_valid) * K * sizeof(float), st);
    if (err != 0) return err;
  }
  if (nonlinear)
    pool_bwd2_kernel<true><<<G, NT, smem, st>>>(f, w, ms, ss, g, sr, n_valid, K, C, tpc, p, dff);
  else
    pool_bwd2_kernel<false><<<G, NT, smem, st>>>(f, w, ms, ss, g, sr, n_valid, K, C, tpc, p, dff);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t P = bwd2_partial_size(K, C);
  reduce_partials<<<(unsigned)((P + 255) / 256), 256, 0, st>>>(p, G, P,
                                                               static_cast<float*>(grads));
  return (int)cudaGetLastError();
}
