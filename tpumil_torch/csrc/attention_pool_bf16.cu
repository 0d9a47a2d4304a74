// DSMIL attention pooling of one bag with a bf16 feature stream, for Hopper
// (K1-bf16 of the port: the eval forward only, no backward).
//
// Replaces tpumil/ops/dsmil_pallas.py::fused_attention_pool with
// feats_dtype=bfloat16 (_kernel :39, the casts :155-158, DEFAULT precision
// :143): feats, W0, W2 and q_max arrive in bf16; b0, b2 and every output
// (B [C, K], m [C], s [C], the masked logits [N, C]) are f32.
//
// The numerics follow the JAX package's reference of that kernel (on the CPU,
// a dot of an f32 operand with a bf16 one runs in f32):
//   z1 = f W0^T + b0       products of bf16 values, summed in f32
//   h = relu(z1), q = tanh(h W2^T + b2), l = q q_max^T / sqrt(D)   all f32
//   p = exp(l - m) rounded to bf16 before B = p^T f; s sums the unrounded p.
// The TPU kernel rounds p against the running max after each 1024-row tile;
// here the logits pass finds the global max first, and p is rounded against
// it (attention_pool_bf16_plain with tile_n=None is the same arithmetic).
//
// What bounds it: bytes. At N = 65529, K = 512, C = 2 the bag is 67.1 MB of
// bf16 and the logits 0.52 MB: 0.020 ms at 3.35 TB/s. The q-MLP and logits
// are ~13 GFLOP as bf16 products (the hi/lo split below included): 0.013 ms
// at 989 TFLOP/s. This simple design reads the bag twice (logits pass, pool
// pass), so its floor is about twice the bound.
//
// The design, two passes and a merge, as the f32 K1 (attention_pool.cu):
//  * logits (pool_logits_bf16_kernel, tiles of TR = 128 rows, 8 warps of 16
//    rows): f W0^T on the tensor cores as bf16 mma.sync m16n8k16 with f32
//    accumulation, the feats tile and W0 streamed in K chunks of 64 through a
//    double-buffered cp.async ring; h and q are split into bf16 hi + lo
//    (h = hi + lo to 16 bits) so that h W2^T and q q_max^T, whose second
//    operand is exact in bf16, keep the f32 reference's level at two products
//    each. Each k16 step's products go to a fresh accumulator that an f32
//    add folds in (the tensor core's own accumulation truncates). Writes the
//    masked logits and each CTA's max.
//  * pool (pool_attend_bf16_kernel): m = the max of the CTA maxima, p =
//    exp(l - m) staged per chunk of rows (bf16-rounded for B, unrounded for
//    s), one read of f in 16-byte vectors of 8 bf16, B's columns pooled per
//    thread in f32 FFMA (a bf16 p times a bf16 f is exact in f32).
//  * merge (pool_merge_bf16_kernel): B = sum acc / s, in a fixed order.
// No float atomics: a rerun is bitwise equal. Rows >= n_valid are never read
// by the pool pass; their logits are written as NEG, their weight is 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;                // ATTN_DIM
constexpr int NT = 256;               // threads per block
constexpr int CMAX = 8;               // compile-time bound on classes
constexpr float NEG = -1e30f;
constexpr int TR = 128;               // rows per tile of the logits pass
constexpr int KC = 64;                // depth (halves) of one streamed K chunk
constexpr int LDK = KC + 8;           // row of a staged chunk: 36 words, rows 4 banks apart
constexpr int LDH = D + 8;            // row of h, q, W2, q_max: 68 words
constexpr int STAGE = (TR + D) * LDK; // one stage of the ring: feats rows, then W0 rows
constexpr int PR = NT;                // rows per staged chunk of weights (pool pass)

// Shared memory of the logits pass (bytes): ring 2 STAGE | h/q hi [TR][LDH]
// | h/q lo [TR][LDH] | W2 [D][LDH] (nonlinear only) | q_max [CMAX][LDH] (all
// bf16) | logits [TR][CMAX] f32.
size_t logits_smem_bytes(bool nl) {
  return sizeof(bf16) * (2 * (size_t)STAGE + 2 * (size_t)TR * LDH + (nl ? (size_t)D * LDH : 0) +
                         (size_t)CMAX * LDH) +
         sizeof(float) * (size_t)TR * CMAX;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b over one k16 step, through a fresh accumulator and an f32 add.
__device__ __forceinline__ void mma1(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// d += (a_hi + a_lo) b, the small product first.
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&b)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, al, b);
  mma_bf16(t, ah, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// Fragments of mma.m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4; each
// register packs two consecutive k (the lower k in the low half):
//   A (16 x 16): a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 8), a3 (g + 8, 2t + 8)
//   B (16 x 8):  b0 (k = 2t, n = g), b1 (k = 2t + 8, n = g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A(m, k) = p[m * LD + k] (row-major), B(k, n) = p[n * LD + k] (weights
// stored [n][k]).
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* p) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* q = p + g * LD + 2 * t;
  a[0] = ld32(q);
  a[1] = ld32(q + 8 * LD);
  a[2] = ld32(q + 8);
  a[3] = ld32(q + 8 * LD + 8);
}

template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const bf16* p) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* q = p + g * LD + 2 * t;
  b[0] = ld32(q);
  b[1] = ld32(q + 8);
}

// 16-byte cp.async; src_ok == false fills the 16 bytes with zeros.
__device__ __forceinline__ void cp16(void* smem, const void* src, bool src_ok) {
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

// Stage K chunk [k0, k0 + KC) of the tile's feats rows (rows >= rows and
// columns >= K zero) and of W0's D rows into one ring stage [TR + D][LDK].
__device__ __forceinline__ void stage_chunk(bf16* st, const bf16* __restrict__ feats,
                                            const bf16* __restrict__ w0, int64_t row0, int rows,
                                            int K, int k0) {
  constexpr int V = KC / 8;
  for (int e = threadIdx.x; e < (TR + D) * V; e += NT) {
    const int r = e / V, k = k0 + 8 * (e % V);
    const bool ok = k < K && (r >= TR || r < rows);
    const bf16* src = r < TR ? feats + (row0 + r) * K + k : w0 + (int64_t)(r - TR) * K + k;
    cp16(st + r * LDK + (k - k0), ok ? src : w0, ok);
  }
}

// Split the f32 values v of rows (r, r + 8), columns (d, d + 1) of a C
// fragment into bf16 hi -> sh and lo -> sl.
__device__ __forceinline__ void store_split(bf16* sh, bf16* sl, int r, int d, const float (&v)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float x0 = v[2 * h], x1 = v[2 * h + 1];
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
    const int o = (r + 8 * h) * LDH + d;
    *reinterpret_cast<__nv_bfloat162*>(sh + o) = hi;
    *reinterpret_cast<uint32_t*>(sl + o) =
        pack2(x0 - __low2float(hi), x1 - __high2float(hi));
  }
}

// ------------------------------------------------------------ logits pass ---
template <bool NL>
__global__ void __launch_bounds__(NT, 1) pool_logits_bf16_kernel(
    const bf16* __restrict__ feats, const bf16* __restrict__ w0, const float* __restrict__ b0,
    const bf16* __restrict__ w2, const float* __restrict__ b2, const bf16* __restrict__ qm,
    int n, int n_valid, int K, int C, int tpc, float* __restrict__ logits,
    float* __restrict__ cmax) {
  extern __shared__ uint4 smem16[];
  bf16* ring = reinterpret_cast<bf16*>(smem16);
  bf16* sHh = ring + 2 * STAGE;
  bf16* sHl = sHh + TR * LDH;
  bf16* sW2 = sHl + TR * LDH;
  bf16* sQm = NL ? sW2 + D * LDH : sW2;
  float* sL = reinterpret_cast<float*>(sQm + CMAX * LDH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // this warp's first row of every product
  for (int e = tid; e < CMAX * D; e += NT)
    sQm[(e / D) * LDH + e % D] = e < C * D ? qm[e] : __float2bfloat16(0.f);
  if constexpr (NL)
    for (int e = tid; e < D * D; e += NT) sW2[(e / D) * LDH + e % D] = w2[e];
  const int nch = (K + KC - 1) / KC;
  const float scale = 1.f / sqrtf((float)D);
  float mx = NEG;  // warps c < C: this CTA's max of class c
  const int tiles = (n_valid + TR - 1) / TR;
  const int t_begin = min((int)blockIdx.x * tpc, tiles), t_end = min(t_begin + tpc, tiles);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int64_t row0 = (int64_t)tile * TR;
    const int rows = min(TR, (int)(n_valid - row0));
    __syncthreads();  // the previous tile's ring and sL are consumed

    // z1 = f W0^T, streamed over K
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    stage_chunk(ring, feats, w0, row0, rows, K, 0);
    cp_commit();
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch) {
        stage_chunk(ring + ((ch + 1) & 1) * STAGE, feats, w0, row0, rows, K, (ch + 1) * KC);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const bf16* sF = ring + (ch & 1) * STAGE;
      const bf16* sW = sF + TR * LDK;
#pragma unroll
      for (int ks = 0; ks < KC; ks += 16) {
        uint32_t a[4];
        frag_a<LDK>(a, sF + wr * LDK + ks);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          uint32_t b[2];
          frag_b<LDK>(b, sW + j * 8 * LDK + ks);
          mma1(acc[j], a, b);
        }
      }
      __syncthreads();  // this stage is consumed before it is refilled
    }
    // h = relu(z1 + b0) (nonlinear) or q = z1 + b0 (linear), split -> sHh, sHl.
    // Each warp writes and then reads only its own 16 rows.
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = j * 8 + 2 * t;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float z1 = acc[j][i] + b0[d + (i & 1)];
        v[i] = NL ? fmaxf(z1, 0.f) : z1;
      }
      store_split(sHh, sHl, wr + g, d, v);
    }
    __syncwarp();

    if constexpr (NL) {  // q = tanh(h W2^T + b2) -> sHh, sHl
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < D; ks += 16) {
        uint32_t ah[4], al[4];
        frag_a<LDH>(ah, sHh + wr * LDH + ks);
        frag_a<LDH>(al, sHl + wr * LDH + ks);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          uint32_t b[2];
          frag_b<LDH>(b, sW2 + j * 8 * LDH + ks);
          mma2(acc[j], ah, al, b);
        }
      }
      __syncwarp();  // every lane has read h before q overwrites it
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int d = j * 8 + 2 * t;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = tanhf(acc[j][i] + b2[d + (i & 1)]);
        store_split(sHh, sHl, wr + g, d, v);
      }
      __syncwarp();
    }

    // l = q q_max^T / sqrt(D): one n-tile of 8 columns (the classes; those
    // >= C are zero rows of sQm)
    float lg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < D; ks += 16) {
      uint32_t ah[4], al[4], b[2];
      frag_a<LDH>(ah, sHh + wr * LDH + ks);
      frag_a<LDH>(al, sHl + wr * LDH + ks);
      frag_b<LDH>(b, sQm + ks);
      mma2(lg, ah, al, b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wr + g + (i >> 1) * 8;
      sL[r * CMAX + 2 * t + (i & 1)] = r < rows ? lg[i] * scale : NEG;
    }
    __syncthreads();
    const int stored = (int)min((int64_t)TR, (int64_t)n - row0) * C;
    for (int e = tid; e < stored; e += NT) logits[row0 * C + e] = sL[(e / C) * CMAX + e % C];
    if (warp < C)
      for (int r = lane; r < TR; r += 32) mx = fmaxf(mx, sL[r * CMAX + warp]);
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

// -------------------------------------------------------------- pool pass ---
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// CTA (bx, by) takes rows [bx rpb, + rpb) and 16-byte columns [by NT, + NT)
// of f (8 bf16 each). A row slot of W threads reads one row, thread (slot, x)
// its vector 8 (by NT + x); slots take rows slot, slot + slots, ... Partial
// layout per row block: acc [C][K] | m [CMAX] | s [CMAX].
// Shared memory: sP [PR][CMAX] | sAcc [slots - 1][C][W][2] float4.
__global__ void __launch_bounds__(NT) pool_attend_bf16_kernel(
    const bf16* __restrict__ feats, const float* __restrict__ logits,
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
  const int W = min(K / 8 - (int)blockIdx.y * NT, NT), slots = NT / W;
  const int slot = tid / W, x = tid % W, k8 = blockIdx.y * NT + x;
  const int64_t r_begin = (int64_t)blockIdx.x * rpb;
  const int64_t r_end = min((int64_t)n_valid, r_begin + rpb);
  float acc[CMAX][8], ps[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    ps[c] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[c][i] = 0.f;
  }
  for (int64_t r0 = r_begin; r0 < r_end; r0 += PR) {
    const int nr = (int)min((int64_t)PR, r_end - r0);
    __syncthreads();  // sM is set; the previous chunk's sP is consumed
    if (tid < nr) {
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) {
          const float p = expf(logits[(r0 + tid) * C + c] - sM[c]);
          sP[tid * CMAX + c] = __bfloat162float(__float2bfloat16_rn(p));
          ps[c] += p;
        }
    }
    __syncthreads();
    if (slot < slots) {
      const bf16* f = feats + r0 * K + 8 * k8;
#pragma unroll 4
      for (int r = slot; r < nr; r += slots) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(f + (int64_t)r * K));
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
        float v[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 pr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          v[2 * i] = pr.x;
          v[2 * i + 1] = pr.y;
        }
#pragma unroll
        for (int c = 0; c < CMAX; ++c)
          if (c < C) {
            const float p = sP[r * CMAX + c];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[c][i] = fmaf(p, v[i], acc[c][i]);
          }
      }
    }
  }
  // this CTA's partial: acc summed over the slots in order; s over the
  // threads in a fixed order (written by the first column chunk)
  if (slot >= 1 && slot < slots)
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) {
        float4* o = sAcc + (((slot - 1) * C + c) * W + x) * 2;
        o[0] = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
        o[1] = make_float4(acc[c][4], acc[c][5], acc[c][6], acc[c][7]);
      }
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
        for (int sl = 1; sl < slots; ++sl) {
          const float4* b = sAcc + (((sl - 1) * C + c) * W + x) * 2;
          const float4 b0 = b[0], b1 = b[1];
          acc[c][0] += b0.x;
          acc[c][1] += b0.y;
          acc[c][2] += b0.z;
          acc[c][3] += b0.w;
          acc[c][4] += b1.x;
          acc[c][5] += b1.y;
          acc[c][6] += b1.z;
          acc[c][7] += b1.w;
        }
        float4* o = reinterpret_cast<float4*>(out + (int64_t)c * K + 8 * k8);
        o[0] = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
        o[1] = make_float4(acc[c][4], acc[c][5], acc[c][6], acc[c][7]);
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
__global__ void __launch_bounds__(NT) pool_merge_bf16_kernel(const float* __restrict__ part,
                                                             int G, int K, int C,
                                                             float* __restrict__ out_b,
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

// ------------------------------------------------------------------ host ---
bool bad_args(int n, int n_valid, int K, int C) {
  return K <= 0 || K % 8 != 0 || C < 1 || C > CMAX || n_valid < 1 || n_valid > n;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Launch shapes and scratch (floats): part [G2, C K + 2 CMAX] | cmax [G1, C].
struct Bf16Plan {
  int G1, tpc, G2, rpb, chunks;
  int64_t part, cmax;
  size_t smem1, smem2;
  const void* logits_kernel;
};

int bf16_plan(int nonlinear, int n, int n_valid, int K, int C, Bf16Plan* p) {
  if (bad_args(n, n_valid, K, C)) return (int)cudaErrorInvalidValue;
  const bool nl = nonlinear != 0;
  p->logits_kernel = nl ? (const void*)pool_logits_bf16_kernel<true>
                        : (const void*)pool_logits_bf16_kernel<false>;
  p->smem1 = logits_smem_bytes(nl);
  p->smem2 = ((size_t)PR * CMAX + (size_t)C * NT * 8) * sizeof(float);
  int err = (int)cudaFuncSetAttribute(p->logits_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem1);
  if (err == 0)
    err = (int)cudaFuncSetAttribute((const void*)pool_attend_bf16_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem2);
  if (err != 0) return err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p->logits_kernel, NT,
                                                           p->smem1);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int sms = sm_count();
  const int tiles = (n_valid + TR - 1) / TR;
  const int gmax = per_sm * sms;
  p->tpc = (tiles + gmax - 1) / gmax;
  p->G1 = (tiles + p->tpc - 1) / p->tpc;
  // pool pass: about four CTAs per SM, at least 32 rows each
  const int want = 4 * sms;
  const int per = (n_valid + want - 1) / want;
  p->rpb = per > 32 ? per : 32;
  p->G2 = (n_valid + p->rpb - 1) / p->rpb;
  p->chunks = (K / 8 + NT - 1) / NT;
  p->part = (int64_t)p->G2 * ((int64_t)C * K + 2 * CMAX);
  p->cmax = (int64_t)p->G1 * C;
  return 0;
}

}  // namespace

// Floats of scratch that K1-bf16 needs, or -(CUDA error code).
extern "C" long long tpumil_attention_pool_fwd_bf16_scratch(int nonlinear, int n, int n_valid,
                                                            int K, int C) {
  Bf16Plan p;
  const int err = bf16_plan(nonlinear, n, n_valid, K, C, &p);
  if (err != 0) return -(long long)err;
  return (long long)(p.part + p.cmax);
}

// K1-bf16. feats [n, K], w0 [D, K], w2 [D, D], qm [C, D] bf16; b0, b2 [D]
// f32 (w2, b2 unused for the linear q). scratch:
// tpumil_attention_pool_fwd_bf16_scratch floats. Outputs (f32) B [C, K],
// m [C], s [C] and the masked logits [n, C] (rows >= n_valid at -1e30).
extern "C" int tpumil_attention_pool_fwd_bf16(const void* feats, const void* w0, const void* b0,
                                              const void* w2, const void* b2, const void* qm,
                                              int n, int n_valid, int K, int C, int nonlinear,
                                              void* scratch, void* out_b, void* out_m,
                                              void* out_s, void* logits, void* stream) {
  Bf16Plan p;
  int err = bf16_plan(nonlinear, n, n_valid, K, C, &p);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* f = static_cast<const bf16*>(feats);
  const bf16* w0h = static_cast<const bf16*>(w0);
  const bf16* w2h = static_cast<const bf16*>(w2);
  const bf16* qmh = static_cast<const bf16*>(qm);
  const float* b0f = static_cast<const float*>(b0);
  const float* b2f = static_cast<const float*>(b2);
  float* part = static_cast<float*>(scratch);
  float* cmax = part + p.part;
  float* l = static_cast<float*>(logits);
  if (nonlinear)
    pool_logits_bf16_kernel<true><<<p.G1, NT, p.smem1, st>>>(f, w0h, b0f, w2h, b2f, qmh, n,
                                                              n_valid, K, C, p.tpc, l, cmax);
  else
    pool_logits_bf16_kernel<false><<<p.G1, NT, p.smem1, st>>>(f, w0h, b0f, w2h, b2f, qmh, n,
                                                               n_valid, K, C, p.tpc, l, cmax);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  pool_attend_bf16_kernel<<<dim3(p.G2, p.chunks), NT, p.smem2, st>>>(f, l, cmax, p.G1, n_valid,
                                                                      K, C, p.rpb, part);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  pool_merge_bf16_kernel<<<dim3((K + 31) / 32, C), NT, 0, st>>>(
      part, p.G2, K, C, static_cast<float*>(out_b), static_cast<float*>(out_m),
      static_cast<float*>(out_s));
  return (int)cudaGetLastError();
}
