// The ResNet stem for 224^2 NHWC images, for Hopper: conv 7x7/s2/p3
// (3 -> 64 channels), InstanceNorm2d(affine=False, eps) over each (image,
// channel) plane of 112x112, ReLU, then max pool 3x3/s2/p1 to [B, 56, 56, 64].
//
// Replaces the Pallas TPU kernel tpumil/ops/stem_pallas.py::_stem_kernel
// (entry point fused_stem). That kernel keeps one image's conv output in
// VMEM and rewrites the conv as a space-to-depth im2col matmul over a flat
// layout with junk columns, a Mosaic workaround; this kernel computes the
// same function, the direct conv with pad 3, without it.
//
// What bounds it: operations. One batch of 128 is 2 * 128 * 12544 * 64 * 147
// = 30.2 GFLOP against 180 MB of f32 input and output, about 170 flop per
// byte, so in true f32 (FFMA; the TPU kernel pins its f32 dot to HIGHEST)
// the card's 67 TFLOP/s bound it at 0.45 ms.
//
// Design (simple first). One image's conv plane is 3.2 MB in f32, against
// 227 KB of shared memory per block, so the work is split in two kernels:
//   1. stem_conv_kernel: one block per (image, tile of TR = 8 conv rows).
//      The block stages its 21 input rows (zero padded, each channel split
//      into even and odd columns so that neighbouring pixels read
//      neighbouring words) and all 147 x 64 weights in shared memory. Each
//      thread owns 8 channels and, in turn, 4 groups of 8 adjacent pixels:
//      64 FFMA accumulators, with the inputs of one (kernel row, channel)
//      held in registers and reused across the 7 kernel columns. The sums
//      are rounded to the compute dtype (bf16: bf16 operands, f32 sums,
//      rounded before the statistics, as the TPU kernel does) and written
//      to a [B, 112, 112, 64] scratch. Per-tile (mean, M2) statistics of
//      the rounded values go beside it: two-pass within each 8-pixel group,
//      then Chan's merge in a fixed order.
//   2. stem_norm_pool_kernel: one block per (image, pooled row). It merges
//      the 14 tile statistics of each channel in a fixed order, then max
//      pools the raw conv values and normalizes the maximum. Normalizing
//      with rsqrt > 0, ReLU and rounding are monotone non-decreasing, so
//      this gives the bits of normalizing first, and each window is read
//      once. The variance is a sum of squares, so it cannot go negative: a
//      constant plane gives exact zeros.
// No float atomics: a rerun is bitwise equal. The scratch costs one extra
// write and read of the conv output (0.8 GB at B = 128 in f32); tensor
// cores (bf16 wgmma), TMA and clusters that keep the plane on chip are the
// work of a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int H_IN = 224, H_CONV = 112, H_OUT = 56;
constexpr int C_IN = 3, C_OUT = 64, KS = 7, PAD = 3;
constexpr int TAPS = KS * KS * C_IN;          // 147, HWIO order (kh, kw, ci)
constexpr int TR = 8;                         // conv rows per block
constexpr int TILES = H_CONV / TR;            // 14
constexpr int IN_ROWS = 2 * TR + KS - 2;      // 21 input rows per tile
constexpr int W_PAD = H_IN + 2 * PAD;         // 230 padded input columns
constexpr int HALF = 116;                     // per parity: 115 used + 1
constexpr int PIX = 8;                        // adjacent pixels per thread
constexpr int CH = 8;                         // channels per thread
constexpr int GROUPS = TR * H_CONV / PIX;     // 112 pixel groups per tile
constexpr int CONV_THREADS = 224;             // 7 warps = 8 ch groups x 28
constexpr int SLOTS = CONV_THREADS / (C_OUT / CH);  // 28 threads per channel
constexpr int ITEMS = GROUPS / SLOTS;         // 4 pixel groups per thread
constexpr size_t CONV_SMEM =
    sizeof(float) * ((size_t)TAPS * C_OUT + (size_t)C_IN * IN_ROWS * 2 * HALF
                     + 2 * (size_t)C_OUT * SLOTS);

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

// grid = (TILES, B), block = CONV_THREADS, dynamic smem = CONV_SMEM.
// x [B, 224, 224, 3] f32, w [7, 7, 3, 64] f32 HWIO, conv [B, 112, 112, 64]
// (TC), part [B, TILES, 64] float2 (mean, M2 over the tile's 896 pixels).
template <typename TC>
__global__ void __launch_bounds__(CONV_THREADS, 2)
stem_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 TC* __restrict__ conv, float2* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                                    // [TAPS][64]
  float* s_in = s_w + TAPS * C_OUT;                     // [3][21][2][HALF]
  float* s_mean = s_in + C_IN * IN_ROWS * 2 * HALF;     // [64][SLOTS]
  float* s_m2 = s_mean + C_OUT * SLOTS;                 // [64][SLOTS]
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int r0 = tile * TR;                   // first conv row of the tile
  const int gr0 = 2 * r0 - PAD;               // input row of local row 0

  for (int e = tid; e < TAPS * C_OUT; e += CONV_THREADS)
    s_w[e] = round_to<TC>(w[e]);
  // input tile, zero padded; e walks (row, padded column, channel) so that
  // neighbouring threads read neighbouring addresses
  const float* xb = x + (int64_t)b * H_IN * H_IN * C_IN;
  for (int e = tid; e < IN_ROWS * W_PAD * C_IN; e += CONV_THREADS) {
    const int ci = e % C_IN;
    const int cp = (e / C_IN) % W_PAD;        // padded column = input col + 3
    const int r = e / (C_IN * W_PAD);
    const int gr = gr0 + r, gc = cp - PAD;
    float v = 0.f;
    if (gr >= 0 && gr < H_IN && gc >= 0 && gc < H_IN)
      v = round_to<TC>(xb[((int64_t)gr * H_IN + gc) * C_IN + ci]);
    s_in[((ci * IN_ROWS + r) * 2 + (cp & 1)) * HALF + (cp >> 1)] = v;
  }
  for (int e = tid; e < C_IN * IN_ROWS * 2; e += CONV_THREADS)
    s_in[e * HALF + HALF - 1] = 0.f;          // the unused last column
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 7;                    // channels cg*8 .. cg*8+7
  const int slot = warp * 4 + (lane >> 3);    // 0 .. SLOTS-1
  const float4* s_w4 = reinterpret_cast<const float4*>(s_w);

  float run_mean[CH], run_m2[CH];             // this thread's statistics
#pragma unroll
  for (int k = 0; k < CH; ++k) { run_mean[k] = 0.f; run_m2[k] = 0.f; }

  for (int it = 0; it < ITEMS; ++it) {
    const int pg = it * SLOTS + slot;         // pixel group in the tile
    const int rl = pg / (H_CONV / PIX);       // local conv row
    const int p0 = (pg % (H_CONV / PIX)) * PIX;  // first conv column
    float acc[PIX][CH];
#pragma unroll
    for (int j = 0; j < PIX; ++j)
#pragma unroll
      for (int k = 0; k < CH; ++k) acc[j][k] = 0.f;

    for (int kh = 0; kh < KS; ++kh) {
#pragma unroll
      for (int ci = 0; ci < C_IN; ++ci) {
        // conv column p, kernel column kw reads padded column 2p + kw:
        // parity kw & 1, index p + kw / 2
        const float* row = s_in + ((ci * IN_ROWS + 2 * rl + kh) * 2) * HALF + p0;
        float ev[PIX + 3], od[PIX + 2];
#pragma unroll
        for (int j = 0; j < PIX + 3; ++j) ev[j] = row[j];
#pragma unroll
        for (int j = 0; j < PIX + 2; ++j) od[j] = row[HALF + j];
#pragma unroll
        for (int kw = 0; kw < KS; ++kw) {
          const int t = (kh * KS + kw) * C_IN + ci;
          const float4 wa = s_w4[t * (C_OUT / 4) + cg * 2];
          const float4 wb = s_w4[t * (C_OUT / 4) + cg * 2 + 1];
          const float wk[CH] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < PIX; ++j) {
            const float a = (kw & 1) ? od[j + kw / 2] : ev[j + kw / 2];
#pragma unroll
            for (int k = 0; k < CH; ++k) acc[j][k] = fmaf(a, wk[k], acc[j][k]);
          }
        }
      }
    }

    // round to the compute dtype, store, and fold into the statistics
    TC* dst = conv + (((int64_t)b * H_CONV + r0 + rl) * H_CONV + p0) * C_OUT
              + cg * CH;
    float mean8[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) mean8[k] = 0.f;
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      Pack<TC, CH> o;
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        o.v[k] = from_f32<TC>(acc[j][k]);
        acc[j][k] = to_f32(o.v[k]);
        mean8[k] += acc[j][k];
      }
      *reinterpret_cast<Pack<TC, CH>*>(dst + (int64_t)j * C_OUT) = o;
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      mean8[k] *= 1.f / PIX;
      float m2 = 0.f;
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
        const float d = acc[j][k] - mean8[k];
        m2 = fmaf(d, d, m2);
      }
      if (it == 0) {
        run_mean[k] = mean8[k];
        run_m2[k] = m2;
      } else {
        chan_merge((float)(it * PIX), run_mean[k], run_m2[k], (float)PIX,
                   mean8[k], m2);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < CH; ++k) {
    s_mean[(cg * CH + k) * SLOTS + slot] = run_mean[k];
    s_m2[(cg * CH + k) * SLOTS + slot] = run_m2[k];
  }
  __syncthreads();
  if (tid < C_OUT) {
    const float n_slot = (float)(ITEMS * PIX);
    float mean = s_mean[tid * SLOTS], m2 = s_m2[tid * SLOTS];
    for (int s = 1; s < SLOTS; ++s)
      chan_merge(s * n_slot, mean, m2, n_slot, s_mean[tid * SLOTS + s],
                 s_m2[tid * SLOTS + s]);
    part[((int64_t)b * TILES + tile) * C_OUT + tid] = make_float2(mean, m2);
  }
}

// grid = (56, B), block = (16, 56): threadIdx.x a group of 4 channels,
// threadIdx.y the pooled column. out [B, 56, 56, 64] (TC).
template <typename TC>
__global__ void stem_norm_pool_kernel(const TC* __restrict__ conv,
                                      const float2* __restrict__ part,
                                      TC* __restrict__ out, float eps) {
  __shared__ float s_mean[C_OUT], s_inv[C_OUT];
  const int oy = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < C_OUT) {
    const float n_tile = (float)(TR * H_CONV);
    const float2* p = part + (int64_t)b * TILES * C_OUT + tid;
    float mean = p[0].x, m2 = p[0].y;
    for (int t = 1; t < TILES; ++t)
      chan_merge(t * n_tile, mean, m2, n_tile, p[t * C_OUT].x, p[t * C_OUT].y);
    const float var = fmaxf(m2 * (1.f / (H_CONV * H_CONV)), 0.f);
    s_mean[tid] = mean;
    s_inv[tid] = rsqrtf(var + eps);
  }
  __syncthreads();

  using P = Pack<TC, 4>;
  const int c4 = threadIdx.x * 4, ox = threadIdx.y;
  const float neg_inf = __int_as_float(0xff800000);  // the pool's padding
  float m[4] = {neg_inf, neg_inf, neg_inf, neg_inf};
  for (int dy = -1; dy <= 1; ++dy) {
    const int y = 2 * oy + dy;
    if (y < 0 || y >= H_CONV) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = 2 * ox + dx;
      if (xx < 0 || xx >= H_CONV) continue;
      const P v = *reinterpret_cast<const P*>(
          conv + (((int64_t)b * H_CONV + y) * H_CONV + xx) * C_OUT + c4);
#pragma unroll
      for (int k = 0; k < 4; ++k) m[k] = fmaxf(m[k], to_f32(v.v[k]));
    }
  }
  P o;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float r = (m[k] - s_mean[c4 + k]) * s_inv[c4 + k];
    o.v[k] = from_f32<TC>(fmaxf(r, 0.f));
  }
  *reinterpret_cast<P*>(out + (((int64_t)b * H_OUT + oy) * H_OUT + ox) * C_OUT
                        + c4) = o;
}

template <typename TC>
int launch(const void* x, const void* w, void* conv, void* part, void* out,
           int batch, float eps, cudaStream_t stream) {
  auto conv_kernel = stem_conv_kernel<TC>;
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CONV_SMEM);
  if (err != cudaSuccess) return (int)err;
  conv_kernel<<<dim3(TILES, batch), CONV_THREADS, CONV_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<TC*>(conv), static_cast<float2*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_norm_pool_kernel<TC><<<dim3(H_OUT, batch), dim3(C_OUT / 4, H_OUT), 0,
                              stream>>>(
      static_cast<const TC*>(conv), static_cast<const float2*>(part),
      static_cast<TC*>(out), eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch sizes the caller allocates: conv holds batch * 112 * 112 * 64
// elements of the compute dtype, part batch * tiles * 64 float2.
extern "C" int tpumil_stem_tiles() { return TILES; }

// x [B, 224, 224, 3] and w HWIO [7, 7, 3, 64] are float32; dtype is the
// compute dtype (0 = float32, 1 = bfloat16) of conv and out. Returns the
// first CUDA error of the two launches (a refused launch never runs and a
// later synchronize would not report it). Launches on `stream` and does not
// synchronize.
extern "C" int tpumil_stem(const void* x, const void* w, void* conv, void* part,
                           void* out, int batch, int dtype, float eps,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, conv, part, out, batch, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, conv, part, out, batch, eps, st);
  return (int)cudaErrorInvalidValue;
}
