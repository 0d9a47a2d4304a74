// The ResNet stem for 224^2 NHWC images, for Hopper (K5 of the port): conv
// 7x7/s2/p3 (3 -> 64 channels), InstanceNorm2d(affine=False, eps) over each
// (image, channel) plane of 112x112, ReLU, then max pool 3x3/s2/p1 to
// [B, 56, 56, 64].
//
// Replaces the Pallas TPU kernel tpumil/ops/stem_pallas.py::_stem_kernel
// (entry point fused_stem) and the XLA max pool after it. That kernel keeps
// one image's conv output in VMEM and rewrites the conv as a space-to-depth
// im2col matmul (K = 256, 109 of them zero taps) over a flat layout with
// junk columns, a Mosaic workaround. Here the conv is a direct implicit GEMM
// over the 147 taps (K padded to 152 or 160), and the conv plane never
// reaches device memory.
//
// What bounds it: operations. One batch of 128 is 2 * 128 * 12544 * 64 *
// 147 = 30.2 GFLOP against 180 MB of f32 input and output (128 MB with a
// bf16 output).
//  * f32: true-f32 products, as 3xTF32 on the tensor cores (three TF32
//    products per f32 product, tf32x3.cuh): 3 * 30.2 GFLOP at 495 TFLOP/s =
//    0.183 ms (f32 FFMA on the CUDA cores would be 0.451 ms).
//  * bf16: one bf16 product at 989 TFLOP/s, 0.031 ms, under its 0.038 ms of
//    bytes.
//
// The numerics: operands in the compute dtype (f32 through the 3xTF32
// split, no single-pass TF32), sums in f32, each conv value rounded to the
// compute dtype before the statistics and the pool.
//
// Design: two kernels.
//  1. stem_conv_pool_kernel: persistent CTAs of 7 warps, one per SM, each
//     staging the weights once and then walking the (image, tile of TR = 8
//     conv rows) items; a tile's 21 input rows are loaded with every load
//     in flight before the first store. The tile is an implicit GEMM of
//     M = 8 x 112 pixels, N = 64 channels, K = the taps in kh-major order
//     (HWIO's): for a fixed kernel row kh, the 21 taps (kw, ci) of a pixel
//     are 21 consecutive values of an input row stored [padded column][ci],
//     so the A value of (pixel, tap) is s_in[base(pixel) + off(tap)], with
//     off a compile-time constant of the k step (one select where a step
//     crosses a kernel row).
//       f32:  mma.sync m16n8k8 through mma3, K = 152 (147 taps and 5 of zero
//             weight); the input rows are split into TF32 (hi, lo) once,
//             when they are staged, and the weights once per CTA.
//       bf16: mma.sync m16n8k16, one product; an A register packs two
//             consecutive taps, so each kernel row is padded to 22 taps (the
//             22nd reads an in-bounds value against a zero weight), K = 7 x
//             22 + 6 = 160. Padded taps of either dtype read in-bounds words
//             against zero weights: they add exact zeros.
//     Warp ct holds the rows 2p and 2p + 1 of column tile ct (16 columns)
//     and all 64 channels for p = 0..3, so that each A fragment feeds eight
//     n tiles; its M rows are ordered so that lane group g holds columns 2g
//     (rows g of the fragment) and 2g + 1 (rows g + 8). The epilogue of
//     each pair of rows:
//       - rounds each sum to the compute dtype;
//       - folds the rounded values into the thread's per-channel (mean, M2),
//         two-pass over its 4 values, then Chan's merge;
//       - max-pools the rounded raw values (3x3/s2/p1, -inf padding) in
//         registers: column 2g - 1 comes from lane g - 1 by a shuffle, and
//         for g = 0 from the column tile to the left through shared memory
//         (one barrier per pair of rows); conv row 2p - 1 is the previous
//         pair's, kept in registers;
//       - writes the pooled raw row straight into `out`.
//     Pooling raw values first is exact: normalizing with rsqrt > 0, ReLU
//     and rounding are monotone non-decreasing, so the normalized maximum is
//     the maximum of the normalized values, bit for bit. The first pooled row
//     of a tile also needs conv row r0 - 1, the previous tile's last: each
//     tile writes its last conv row, max-pooled along the row, to a side
//     buffer edge [B, 14, 56, 64] (26 MB in f32 at B = 128), and pass 2
//     folds it in. The statistics go to part [B, 14, 64] (mean, M2), the
//     lanes and then the column tiles merged in a fixed order.
//  2. stem_norm_kernel, one block per (image, pooled row), 16 bytes a
//     thread: merges the 14 tiles' (mean, M2) of each channel in a fixed
//     order, folds in the edge row where the pooled row is a tile's first,
//     then normalizes, applies ReLU and rounds, in place on `out`. The
//     variance is a sum of squares, so it cannot go negative: a constant
//     plane gives exact zeros.
// No float atomics: a rerun is bitwise equal.
//
// Shared memory of pass 1 (bytes): the weights in fragment order (f32: hi
// and lo, 19 k steps x 8 n tiles x 32 lanes x 16 = 77,824; bf16 20,480),
// the 21 staged input rows of 690 padded values (f32 (hi, lo) 115,920; bf16
// 28,980), the pool's column exchange (7,168) and the statistics' merge
// (3,584): 204,496 in f32. One CTA of 224 threads per SM: in f32 its
// shared memory, in either dtype its registers (up to 255 a thread, so that
// the 64 accumulators of a pair of m tiles across eight n tiles need no
// spill) leave no room for a second.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <utility>

#include "tf32x3.cuh"

namespace {

constexpr int H_IN = 224, H_CONV = 112, H_OUT = 56;
constexpr int C_IN = 3, C_OUT = 64, KS = 7, PAD = 3;
constexpr int TR = 8;                          // conv rows per tile
constexpr int TILES = H_CONV / TR;             // 14
constexpr int PAIRS = TR / 2;                  // pooled rows per tile
constexpr int IN_ROWS = 2 * TR + KS - 2;       // 21 input rows per tile
constexpr int ROW = H_IN * C_IN;               // 672 values of an input row
constexpr int LPAD = PAD * C_IN;               // 9 zeros left of a row
constexpr int RS = ROW + 2 * LPAD;             // 690: a padded input row
constexpr int ROW_TAPS = KS * C_IN;            // 21 taps (kw, ci) per kernel row
constexpr int TAPS = KS * ROW_TAPS;            // 147, HWIO order (kh, kw, ci)
constexpr int COLS = H_CONV / 16;              // 7 column tiles of 16 pixels
constexpr int WARPS = COLS;                    // one per column tile
constexpr int THREADS = 32 * WARPS;            // 224
constexpr int NJ = 8;                          // n8 tiles of a warp: all 64 channels
constexpr int N_TILE = TR * H_CONV;            // 896 pixels of a tile
constexpr int N_COL = TR * 16;                 // 128 pixels of a column tile

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch's cast
}

// a value rounded to the compute dtype TC, held as float
template <typename TC> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<TC>(v));
}

// Chan's merge of (count na, mean, M2) with (nb, mean_b, M2_b)
__device__ __forceinline__ void chan_merge(float na, float& mean, float& m2,
                                           float nb, float mean_b, float m2_b) {
  const float n = na + nb;
  const float d = mean_b - mean;
  mean += d * (nb / n);
  m2 += m2_b + d * d * (na * nb / n);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The product of each compute dtype. A "unit" is one column of the A
// fragment: one tap (f32, m16n8k8) or two consecutive taps packed in one
// 32-bit register (bf16, m16n8k16). off(u) is the staged-element offset of
// unit u from a pixel's first tap; tap(u, q) the HWIO tap of element q of
// unit u, -1 where the weight is zero.
//
// Fragments (PTX ISA), g = lane / 4, t = lane % 4: A a0 (row g, unit t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (unit t, n = g), b1
// (unit t + 4, n = g); C c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3
// (g + 8, 2t + 1).
template <typename TC> struct Prod;

template <> struct Prod<float> {
  static constexpr int STEPS = 19;             // K = 152 in k8 steps
  static constexpr int UNIT = 1;               // staged elements per unit
  using In = uint2;                            // (hi, lo) tf32 of an input value
  using WFrag = uint4;                         // (b0 hi, b1 hi, b0 lo, b1 lo)
  __host__ __device__ static constexpr int off(int u) {
    return u < TAPS ? (u / ROW_TAPS) * RS + u % ROW_TAPS : u - TAPS;
  }
  __host__ __device__ static constexpr int tap(int u, int) { return u < TAPS ? u : -1; }
};

template <> struct Prod<__nv_bfloat16> {
  static constexpr int STEPS = 10;             // K = 160 in k16 steps
  static constexpr int UNIT = 2;
  static constexpr int ROW_UNITS = 11;         // 22 taps per kernel row
  static constexpr int UNITS = KS * ROW_UNITS; // 77; units 77..79 are zero
  using In = __nv_bfloat16;
  using WFrag = uint2;                         // (b0, b1), two bf16 each
  __host__ __device__ static constexpr int off(int u) {
    return u < UNITS ? (u / ROW_UNITS) * RS + 2 * (u % ROW_UNITS) : 2 * (u - UNITS);
  }
  __host__ __device__ static constexpr int tap(int u, int q) {
    return u < UNITS && 2 * (u % ROW_UNITS) + q < ROW_TAPS
               ? (u / ROW_UNITS) * ROW_TAPS + 2 * (u % ROW_UNITS) + q
               : -1;
  }
};

// The offset of unit U0 + t (t = 0..3) less UNIT * t, which the thread's
// pixel base holds: a constant c, or c + delta from lane t = tau on where
// the four units cross a kernel row (once at most).
template <typename TC>
__host__ __device__ constexpr int first_jump(int u0) {
  using P = Prod<TC>;
  for (int t = 1; t < 4; ++t)
    if (P::off(u0 + t) - P::UNIT * t != P::off(u0)) return t;
  return 4;
}

template <typename TC>
__host__ __device__ constexpr bool one_jump(int u0) {
  using P = Prod<TC>;
  const int tau = first_jump<TC>(u0);
  for (int t = tau + 1; t < 4; ++t)
    if (P::off(u0 + t) - P::UNIT * t != P::off(u0 + tau) - P::UNIT * tau) return false;
  return true;
}

template <typename TC, int U0>
__device__ __forceinline__ int unit_off(int t) {
  using P = Prod<TC>;
  constexpr int c = P::off(U0);
  constexpr int tau = first_jump<TC>(U0);
  static_assert(one_jump<TC>(U0), "four units cross two kernel rows");
  if constexpr (tau == 4) {
    return c;
  } else {
    constexpr int delta = P::off(U0 + tau) - P::UNIT * tau - c;
    return t >= tau ? c + delta : c;
  }
}

// One k step of a warp's two m16 tiles (conv rows 2p and 2p + 1 of its 16
// columns) against its eight n8 tiles. `a` is the thread's pixel base (row
// g's pixel, unit t), `wb` its lane's weight fragments of n tile 0.
template <int S>
__device__ __forceinline__ void kstep(float (&acc)[2][NJ][4], const uint2* a,
                                      const uint4* wb, int t) {
  const int o0 = unit_off<float, 8 * S>(t), o1 = unit_off<float, 8 * S + 4>(t);
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const uint2* am = a + m * 2 * RS;          // conv row + 1: input rows + 2
    const uint2 v[4] = {am[o0], am[6 + o0], am[o1], am[6 + o1]};  // odd pixel: +6
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[m][e] = v[e].x;
      al[m][e] = v[e].y;
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const uint4 bv = wb[S * 8 * 32 + j * 32];
    const uint32_t bh[2] = {bv.x, bv.y}, bl[2] = {bv.z, bv.w};
#pragma unroll
    for (int m = 0; m < 2; ++m) mma3(acc[m][j], ah[m], al[m], bh, bl);
  }
}

template <int S>
__device__ __forceinline__ void kstep(float (&acc)[2][NJ][4], const __nv_bfloat16* a,
                                      const uint2* wb, int t) {
  const int o0 = unit_off<__nv_bfloat16, 8 * S>(t);
  const int o1 = unit_off<__nv_bfloat16, 8 * S + 4>(t);
  uint32_t av[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const __nv_bfloat16* am = a + m * 2 * RS;
    av[m][0] = *reinterpret_cast<const uint32_t*>(am + o0);
    av[m][1] = *reinterpret_cast<const uint32_t*>(am + 6 + o0);
    av[m][2] = *reinterpret_cast<const uint32_t*>(am + o1);
    av[m][3] = *reinterpret_cast<const uint32_t*>(am + 6 + o1);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const uint2 bv = wb[S * 8 * 32 + j * 32];
    const uint32_t b[2] = {bv.x, bv.y};
#pragma unroll
    for (int m = 0; m < 2; ++m) mma_bf16(acc[m][j], av[m], b);
  }
}

template <typename In, typename WFrag, int... S>
__device__ __forceinline__ void conv_pair(float (&acc)[2][NJ][4], const In* a,
                                          const WFrag* wb, int t,
                                          std::integer_sequence<int, S...>) {
  (kstep<S>(acc, a, wb, t), ...);
}

// An input value as staged: its TF32 (hi, lo) split, or bf16.
__device__ __forceinline__ uint2 stage(float v, uint2) {
  uint2 r;
  split_tf32(v, r.x, r.y);
  return r;
}
__device__ __forceinline__ __nv_bfloat16 stage(float v, __nv_bfloat16) {
  return __float2bfloat16(v);
}

// w[tap][n], 0 for a padded tap
__device__ __forceinline__ float w_at(const float* w, int tap, int n) {
  return tap >= 0 ? __ldg(w + tap * C_OUT + n) : 0.f;
}

// Lane `lane`'s B fragment of k step s, n tile nt: f32 split into TF32
// (hi, lo), or bf16 pairs.
__device__ __forceinline__ uint4 w_frag(const float* w, int s, int nt, int lane, uint4) {
  using P = Prod<float>;
  const int n = nt * 8 + (lane >> 2), u = 8 * s + (lane & 3);
  uint4 r;
  split_tf32(w_at(w, P::tap(u, 0), n), r.x, r.z);
  split_tf32(w_at(w, P::tap(u + 4, 0), n), r.y, r.w);
  return r;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint2 w_frag(const float* w, int s, int nt, int lane, uint2) {
  using P = Prod<__nv_bfloat16>;
  const int n = nt * 8 + (lane >> 2), u = 8 * s + (lane & 3);
  return make_uint2(bf16x2(w_at(w, P::tap(u, 0), n), w_at(w, P::tap(u, 1), n)),
                    bf16x2(w_at(w, P::tap(u + 4, 0), n), w_at(w, P::tap(u + 4, 1), n)));
}

template <typename TC>
struct Smem {
  using P = Prod<TC>;
  static constexpr size_t W = sizeof(typename P::WFrag) * P::STEPS * 8 * 32;
  static constexpr size_t IN = (sizeof(typename P::In) * IN_ROWS * RS + 15) / 16 * 16;
  static constexpr size_t X = sizeof(float) * 2 * COLS * 2 * C_OUT;
  static constexpr size_t ST = sizeof(float2) * COLS * C_OUT;
  static constexpr size_t TOTAL = W + IN + X + ST;
};

// Stage the tile's input rows 2 r0 - 3 .. 2 r0 + 17 of image b (a row of x
// is 672 contiguous values) at padded column 3; rows outside the image are
// zeros. Every load is issued before the first store.
template <typename In>
__device__ __forceinline__ void stage_rows(In* s_in, const float* __restrict__ x, int b,
                                           int r0) {
  constexpr int V4 = IN_ROWS * (ROW / 4), PER = (V4 + THREADS - 1) / THREADS;
  const float* xb = x + (int64_t)b * H_IN * ROW;
  const int gr0 = 2 * r0 - PAD;
  float4 v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = threadIdx.x + k * THREADS;
    const int r = e / (ROW / 4), gr = gr0 + r;
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < V4 && gr >= 0 && gr < H_IN)
      v[k] = __ldg(reinterpret_cast<const float4*>(xb + (int64_t)gr * ROW) + e - r * (ROW / 4));
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = threadIdx.x + k * THREADS;
    if (e < V4) {
      const int r = e / (ROW / 4);
      In* d = s_in + r * RS + LPAD + 4 * (e - r * (ROW / 4));
      d[0] = stage(v[k].x, In{});
      d[1] = stage(v[k].y, In{});
      d[2] = stage(v[k].z, In{});
      d[3] = stage(v[k].w, In{});
    }
  }
}

// grid = a persistent set of CTAs, each walking the (image, tile) items
// blockIdx.x, blockIdx.x + gridDim.x, ...; block = THREADS, dynamic smem =
// Smem<TC>::TOTAL. x [B, 224, 224, 3] f32 (16-byte aligned), w [7, 7, 3, 64]
// f32 HWIO. Writes out [B, 56, 56, 64] (TC) with the max-pooled raw conv
// (a tile's first pooled row without conv row r0 - 1), edge [B, TILES, 56,
// 64] (TC) with each tile's last conv row max-pooled along the row, and
// part [B, TILES, 64] (mean, M2) over each tile's 896 pixels.
template <typename TC>
__global__ void __launch_bounds__(THREADS, 1)
stem_conv_pool_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      TC* __restrict__ out, TC* __restrict__ edge,
                      float2* __restrict__ part, int batch) {
  using P = Prod<TC>;
  using In = typename P::In;
  using WFrag = typename P::WFrag;
  using S = Smem<TC>;
  extern __shared__ __align__(16) unsigned char smem[];
  WFrag* s_w = reinterpret_cast<WFrag*>(smem);                 // [STEPS][8][32]
  In* s_in = reinterpret_cast<In*>(smem + S::W);               // [IN_ROWS][RS]
  float* s_x = reinterpret_cast<float*>(smem + S::W + S::IN);  // [2][COLS][2][64]
  float2* s_st = reinterpret_cast<float2*>(smem + S::W + S::IN + S::X);  // [COLS][64]
  const int tid = threadIdx.x;

  // once per CTA: the weights and the zero padding columns of the rows
  for (int e = tid; e < P::STEPS * 8 * 32; e += THREADS)
    s_w[e] = w_frag(w, e >> 8, (e >> 5) & 7, e & 31, WFrag{});
  for (int e = tid; e < IN_ROWS * 2 * LPAD; e += THREADS) {
    const int r = e / (2 * LPAD), k = e % (2 * LPAD);
    s_in[r * RS + (k < LPAD ? k : ROW + k)] = stage(0.f, In{});
  }

  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int ct = warp;                        // column tile
  const int ch0 = 2 * t;                      // channel of acc[.][j][0]: ch0 + 8 j
  const WFrag* wb = s_w + lane;
  const float neg_inf = __int_as_float(0xff800000);  // the pool's padding

  for (int item = blockIdx.x; item < batch * TILES; item += gridDim.x) {
    const int b = item / TILES, tile = item - b * TILES;
    const int r0 = tile * TR;                   // first conv row of the tile
    __syncthreads();                            // the last item's reads are done
    stage_rows(s_in, x, b, r0);
    __syncthreads();

    float carry[NJ][2];                         // conv row 2p - 1, row-pooled
    float run_mean[NJ][2], run_m2[NJ][2];       // this thread's statistics
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) carry[j][q] = neg_inf;

    for (int p = 0; p < PAIRS; ++p) {
      float acc[2][NJ][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
      // row g of the fragment: pixel 16 ct + 2g of conv row 2p (input row 4p)
      const int base = 4 * p * RS + 6 * (16 * ct + 2 * g) + P::UNIT * t;
      conv_pair(acc, s_in + base, wb, t, std::make_integer_sequence<int, P::STEPS>{});

      // round to the compute dtype, then fold each channel's 4 values into
      // the thread's (mean, M2): two-pass within the group, Chan's merge
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = round_to<TC>(acc[m][j][e]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float v[4] = {acc[0][j][q], acc[0][j][2 + q], acc[1][j][q], acc[1][j][2 + q]};
          const float mean = ((v[0] + v[1]) + (v[2] + v[3])) * 0.25f;
          float m2 = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) m2 = fmaf(v[e] - mean, v[e] - mean, m2);
          if (p == 0) {
            run_mean[j][q] = mean;
            run_m2[j][q] = m2;
          } else {
            chan_merge(4.f * p, run_mean[j][q], run_m2[j][q], 4.f, mean, m2);
          }
        }

      // max pool. Lane group g holds columns 2g (acc[.][.][0..1]) and 2g + 1
      // (acc[.][.][2..3]); pooled column 8 ct + g also takes column 2g - 1:
      // lane g - 1's odd column, or for g = 0 the left column tile's last
      float* xs = s_x + (p & 1) * COLS * 2 * C_OUT;
      if (g == 7)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              xs[(ct * 2 + m) * C_OUT + ch0 + 8 * j + q] = acc[m][j][2 + q];
      __syncthreads();
      float hp[2][NJ][2];                       // conv rows 2p, 2p + 1, row-pooled
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float odd = acc[m][j][2 + q];
            float left = __shfl_up_sync(0xffffffffu, odd, 4);
            if (g == 0)
              left = ct > 0 ? xs[((ct - 1) * 2 + m) * C_OUT + ch0 + 8 * j + q] : neg_inf;
            hp[m][j][q] = fmaxf(fmaxf(left, acc[m][j][q]), odd);
          }
      // pooled row r0 / 2 + p: conv rows 2p - 1, 2p, 2p + 1
      TC* o = out + (((int64_t)b * H_OUT + r0 / 2 + p) * H_OUT + 8 * ct + g) * C_OUT + ch0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        Pack<TC, 2> v;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          v.v[q] = from_f32<TC>(fmaxf(fmaxf(carry[j][q], hp[0][j][q]), hp[1][j][q]));
          carry[j][q] = hp[1][j][q];
        }
        *reinterpret_cast<Pack<TC, 2>*>(o + 8 * j) = v;
      }
    }

    // the tile's last conv row, row-pooled: the next tile's conv row r0 - 1
    if (tile + 1 < TILES) {
      TC* e = edge + (((int64_t)b * TILES + tile) * H_OUT + 8 * ct + g) * C_OUT + ch0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        Pack<TC, 2> v;
#pragma unroll
        for (int q = 0; q < 2; ++q) v.v[q] = from_f32<TC>(carry[j][q]);
        *reinterpret_cast<Pack<TC, 2>*>(e + 8 * j) = v;
      }
    }

    // statistics: the 8 lane groups of each t (same channels, 16 pixels
    // each), then the column tiles, in a fixed order
    float n = 4.f * PAIRS;
#pragma unroll
    for (int s = 4; s < 32; s <<= 1) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float om = __shfl_xor_sync(0xffffffffu, run_mean[j][q], s);
          const float om2 = __shfl_xor_sync(0xffffffffu, run_m2[j][q], s);
          chan_merge(n, run_mean[j][q], run_m2[j][q], n, om, om2);
        }
      n *= 2.f;
    }
    if (g == 0)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          s_st[ct * C_OUT + ch0 + 8 * j + q] = make_float2(run_mean[j][q], run_m2[j][q]);
    __syncthreads();
    if (tid < C_OUT) {
      float mean = s_st[tid].x, m2 = s_st[tid].y;
      for (int c = 1; c < COLS; ++c)
        chan_merge((float)(c * N_COL), mean, m2, (float)N_COL, s_st[c * C_OUT + tid].x,
                   s_st[c * C_OUT + tid].y);
      part[((int64_t)b * TILES + tile) * C_OUT + tid] = make_float2(mean, m2);
    }
  }
}

// values of the compute dtype in one 16-byte vector of pass 2
template <typename TC>
__host__ __device__ constexpr int norm_vec() {
  return 16 / (int)sizeof(TC);
}

// grid = (56, B), block = (64 / VEC, 56): threadIdx.x a group of VEC =
// norm_vec<TC>() channels, threadIdx.y the pooled column. Normalizes out
// [B, 56, 56, 64] (TC) in place; each thread's loads are issued before the
// statistics are merged.
template <typename TC>
__global__ void stem_norm_kernel(TC* __restrict__ out, const TC* __restrict__ edge,
                                 const float2* __restrict__ part, float eps) {
  constexpr int VEC = norm_vec<TC>();
  using PV = Pack<TC, VEC>;
  __shared__ float s_mean[C_OUT], s_inv[C_OUT];
  const int oy = blockIdx.x, b = blockIdx.y;
  const int c0 = threadIdx.x * VEC, ox = threadIdx.y;
  PV* o = reinterpret_cast<PV*>(out + (((int64_t)b * H_OUT + oy) * H_OUT + ox) * C_OUT + c0);
  const PV v = *o;
  float m[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) m[k] = to_f32(v.v[k]);
  if (oy % PAIRS == 0 && oy > 0) {            // a tile's first pooled row
    const PV e = *reinterpret_cast<const PV*>(
        edge + (((int64_t)b * TILES + oy / PAIRS - 1) * H_OUT + ox) * C_OUT + c0);
#pragma unroll
    for (int k = 0; k < VEC; ++k) m[k] = fmaxf(m[k], to_f32(e.v[k]));
  }

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < C_OUT) {
    const float2* p = part + (int64_t)b * TILES * C_OUT + tid;
    float mean = p[0].x, m2 = p[0].y;
#pragma unroll
    for (int t = 1; t < TILES; ++t)
      chan_merge((float)(t * N_TILE), mean, m2, (float)N_TILE, p[t * C_OUT].x,
                 p[t * C_OUT].y);
    const float var = fmaxf(m2 * (1.f / (H_CONV * H_CONV)), 0.f);
    s_mean[tid] = mean;
    s_inv[tid] = rsqrtf(var + eps);
  }
  __syncthreads();
  PV r;
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    r.v[k] = from_f32<TC>(fmaxf((m[k] - s_mean[c0 + k]) * s_inv[c0 + k], 0.f));
  *o = r;
}

// scratch: part [B, TILES, 64] float2, then edge [B, TILES, 56, 64] (TC)
long long scratch_bytes(int batch, size_t elt) {
  return (long long)batch * TILES * C_OUT * (sizeof(float2) + H_OUT * elt);
}

template <typename TC>
int launch(const void* x, const void* w, void* scratch, void* out, int batch,
           float eps, cudaStream_t stream) {
  float2* part = static_cast<float2*>(scratch);
  TC* edge = reinterpret_cast<TC*>(part + (size_t)batch * TILES * C_OUT);
  auto conv = stem_conv_pool_kernel<TC>;
  constexpr int smem = (int)Smem<TC>::TOTAL;
  cudaError_t err =
      cudaFuncSetAttribute(conv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // one CTA per SM (its registers and, in f32, its shared memory leave no
  // room for a second), each walking the items
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int ctas = (int)std::min<long long>((long long)batch * TILES, sms);
  conv<<<ctas, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<TC*>(out),
      edge, part, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_norm_kernel<TC><<<dim3(H_OUT, batch), dim3(C_OUT / norm_vec<TC>(), H_OUT), 0,
                         stream>>>(static_cast<TC*>(out), edge, part, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch the caller allocates for a batch (16-byte aligned);
// negative on a bad argument.
extern "C" long long tpumil_stem_scratch(int batch, int dtype) {
  if (batch < 0 || (dtype != 0 && dtype != 1)) return -(long long)cudaErrorInvalidValue;
  return scratch_bytes(batch, dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16));
}

// x [B, 224, 224, 3] (16-byte aligned) and w HWIO [7, 7, 3, 64] are float32;
// dtype is the compute dtype (0 = float32, 1 = bfloat16) of out. Returns the
// first CUDA error of the two launches (a refused launch never runs and a
// later synchronize would not report it). Launches on `stream` and does not
// synchronize.
extern "C" int tpumil_stem(const void* x, const void* w, void* scratch, void* out,
                           int batch, int dtype, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, scratch, out, batch, eps, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, scratch, out, batch, eps, st);
  return (int)cudaErrorInvalidValue;
}
