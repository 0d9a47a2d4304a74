// InstanceNorm2d(affine=False, eps) (+ReLU) over NHWC memory, for Hopper.
//
// Replaces the Pallas TPU kernel tpumil/ops/in_pallas.py::_kernel (entry
// point fused_instance_norm). Input x is [N, S = H*W, C] contiguous: an NHWC
// tensor, or an NCHW tensor in channels_last format viewed as NHWC. Output y
// has the same layout and dtype (f32 or bf16).
//
// What bounds it: bytes. The IN sites of one f32 ResNet18 batch of 128 at
// 224^2 hold about 1.27 GB of activations against ~2 flops per element, far
// below the card's ~20 flop/byte balance point for f32 CUDA cores, so the
// kernel is bound by device-memory bandwidth.
//
// Design (simple first): one block per (sample, group of channel vectors).
// threadIdx.x walks channel vectors of 16 bytes (4 f32 or 8 bf16 channels),
// so neighbouring threads read neighbouring addresses; threadIdx.y strides
// over the spatial rows. Pass 1 accumulates shifted sums in f32 registers
// (shift = the plane's first value, which keeps E[d^2] - E[d]^2 from
// cancelling when |mean| >> std), reduces them over threadIdx.y in shared
// memory, and clamps the biased variance at >= 0 (the TPU kernel's clamp for
// blank tiles). Pass 2 reads the plane again, normalizes, applies the ReLU and
// stores in the input dtype. At B = 128 an f32 plane group does not fit in
// shared memory, so unlike the TPU kernel the plane is read twice; the second
// read mostly hits the 50 MB L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// blockDim = (G, TY): G channel vectors per block, TY spatial rows in flight
// (TY a power of two). grid = (N, ceil(C / VEC / G)).
// Shared memory: 2 * TY * G * VEC floats (partial sums, then mean / inv).
template <typename T, int VEC>
__global__ void instance_norm_kernel(const T* __restrict__ x, T* __restrict__ y,
                                     int S, int C, float eps, int relu) {
  extern __shared__ float smem[];
  const int G = blockDim.x, TY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int cv = blockIdx.y * G + tx;          // channel-vector index
  const bool active = cv * VEC < C;
  const int64_t base = (int64_t)blockIdx.x * S * C + (int64_t)cv * VEC;
  const int64_t row = C;                       // elements between rows
  using P = Pack<T, VEC>;

  float shift[VEC], sum[VEC], sq[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) { shift[v] = 0.f; sum[v] = 0.f; sq[v] = 0.f; }

  if (active) {
    P p0 = *reinterpret_cast<const P*>(x + base);
#pragma unroll
    for (int v = 0; v < VEC; ++v) shift[v] = to_f32(p0.v[v]);
    int s = ty;
    // four independent loads in flight per thread, then the tail
    for (; s + 3 * TY < S; s += 4 * TY) {
      P a = *reinterpret_cast<const P*>(x + base + (int64_t)s * row);
      P b = *reinterpret_cast<const P*>(x + base + (int64_t)(s + TY) * row);
      P c = *reinterpret_cast<const P*>(x + base + (int64_t)(s + 2 * TY) * row);
      P d = *reinterpret_cast<const P*>(x + base + (int64_t)(s + 3 * TY) * row);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float da = to_f32(a.v[v]) - shift[v], db = to_f32(b.v[v]) - shift[v];
        float dc = to_f32(c.v[v]) - shift[v], dd = to_f32(d.v[v]) - shift[v];
        sum[v] += (da + db) + (dc + dd);
        sq[v] += (da * da + db * db) + (dc * dc + dd * dd);
      }
    }
    for (; s < S; s += TY) {
      P a = *reinterpret_cast<const P*>(x + base + (int64_t)s * row);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float da = to_f32(a.v[v]) - shift[v];
        sum[v] += da;
        sq[v] += da * da;
      }
    }
  }

  // block reduction over ty: red_sum / red_sq are [TY][G * VEC]
  const int width = G * VEC;
  float* red_sum = smem;
  float* red_sq = smem + TY * width;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    red_sum[ty * width + tx * VEC + v] = sum[v];
    red_sq[ty * width + tx * VEC + v] = sq[v];
  }
  __syncthreads();
  for (int half = TY / 2; half > 0; half >>= 1) {
    if (ty < half) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        red_sum[ty * width + tx * VEC + v] += red_sum[(ty + half) * width + tx * VEC + v];
        red_sq[ty * width + tx * VEC + v] += red_sq[(ty + half) * width + tx * VEC + v];
      }
    }
    __syncthreads();
  }
  // row 0 now holds the totals; turn them into (mean, inv) in place
  if (ty == 0) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float inv_count = 1.f / (float)S;
      float md = red_sum[tx * VEC + v] * inv_count;       // E[x - shift]
      float var = fmaxf(red_sq[tx * VEC + v] * inv_count - md * md, 0.f);
      red_sum[tx * VEC + v] = shift[v] + md;               // mean
      red_sq[tx * VEC + v] = rsqrtf(var + eps);            // 1 / std
    }
  }
  __syncthreads();
  if (!active) return;

  float mean[VEC], inv[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    mean[v] = red_sum[tx * VEC + v];
    inv[v] = red_sq[tx * VEC + v];
  }
  for (int s = ty; s < S; s += TY) {
    const int64_t off = base + (int64_t)s * row;
    P a = *reinterpret_cast<const P*>(x + off);
    P o;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float r = (to_f32(a.v[v]) - mean[v]) * inv[v];
      if (relu) r = fmaxf(r, 0.f);
      o.v[v] = from_f32<T>(r);
    }
    *reinterpret_cast<P*>(y + off) = o;
  }
}

template <typename T, int VEC>
void launch(const void* x, void* y, int n, int s, int c, float eps, int relu,
            cudaStream_t stream) {
  const int cvecs = c / VEC;
  const int g = cvecs < 4 ? cvecs : 4;         // channel vectors per block
  int ty = 1;                                  // spatial rows per block
  while (ty < s && ty < 128) ty <<= 1;
  dim3 block(g, ty);
  dim3 grid(n, (cvecs + g - 1) / g);
  size_t smem = 2 * (size_t)ty * g * VEC * sizeof(float);
  instance_norm_kernel<T, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), s, c, eps, relu);
}

template <typename T, int VEC>
void dispatch(const void* x, void* y, int n, int s, int c, float eps, int relu,
              cudaStream_t stream) {
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  if (aligned && c % VEC == 0) {
    launch<T, VEC>(x, y, n, s, c, eps, relu, stream);
  } else {
    launch<T, 1>(x, y, n, s, c, eps, relu, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (a refused launch never runs and a later synchronize would not
// report it). Launches on `stream` and does not synchronize.
extern "C" int tpumil_instance_norm(const void* x, void* y, int n, int s, int c,
                                    int dtype, int relu, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dispatch<float, 4>(x, y, n, s, c, eps, relu, st);
  } else if (dtype == 1) {
    dispatch<__nv_bfloat16, 8>(x, y, n, s, c, eps, relu, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
