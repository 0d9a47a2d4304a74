// InstanceNorm2d(affine=False, eps) (+ReLU) over NHWC memory, for Hopper.
//
// Replaces the Pallas TPU kernel tpumil/ops/in_pallas.py::_kernel (entry
// point fused_instance_norm). Input x is [N, S = H*W, C] contiguous: an NHWC
// tensor, or an NCHW tensor in channels_last format viewed as NHWC. Output y
// has the same layout and dtype (f32 or bf16).
//
// What bounds it: bytes. About 2 flops per element against one read and one
// write, far below the card's balance point, so the least time is the
// plane's bytes read once and written once over the 3.35 TB/s of device
// memory: 0.514 ms in f32 (0.257 ms in bf16) for the 19 IN sites of one
// ResNet18 forward at B = 128, 224^2.
//
// Two routes, chosen by shape alone (ops/instance_norm.py::plan_instance_norm
// passes the plan in `cluster` and `cblock`):
//
// * One read (cluster >= 1), the design of the TPU kernel: the plane of one
//   (sample, block of `cblock` channels) is held on chip while it is
//   normalized. It is spread over a thread-block cluster of `cluster` CTAs;
//   each CTA copies its slice of spatial rows into shared memory (16-byte
//   cp.async, whole 256-byte rows where C >= 64), computes its per-channel
//   (mean, M2) from shared memory (shifted by its own first row, so an
//   exactly constant plane gives exact zeros), reads the other CTAs'
//   partials through distributed shared memory, merges them by Chan's
//   formula in rank order (every CTA merges the same values in the same
//   order: reruns are bitwise equal), then normalizes its slice from shared
//   memory and writes it. Each element is read from device memory once.
//   Small planes take a cluster of one CTA, sized to the rows that exist.
// * Two reads (cluster == 0), for planes too large for a cluster of 8 (the
//   stem of instance-norm nets at inputs other than 224^2): one block per
//   (sample, group of channel vectors), shifted one-pass sums, a block
//   reduction, then a second read to normalize.
//
// Both compute f32 statistics of the stored values, the biased variance
// clamped at >= 0 (the TPU kernel's clamp for blank tiles), eps inside the
// rsqrt, the optional ReLU, and store in the input dtype.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;
constexpr int ONE_READ_THREADS = 256;

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

// ---------------------------------------------------------- two reads ---
// blockDim = (G, TY): G channel vectors per block, TY spatial rows in flight
// (TY a power of two). grid = (N, ceil(C / VEC / G)).
// Shared memory: 2 * TY * G * VEC floats (partial sums, then mean / inv).
template <typename T, int VEC>
__global__ void two_read_instance_norm_kernel(const T* __restrict__ x, T* __restrict__ y,
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
int launch_two_read(const void* x, void* y, int n, int s, int c, float eps, int relu,
                    cudaStream_t stream) {
  const int cvecs = c / VEC;
  const int g = cvecs < 4 ? cvecs : 4;         // channel vectors per block
  int ty = 1;                                  // spatial rows per block
  while (ty < s && ty < 128) ty <<= 1;
  dim3 block(g, ty);
  dim3 grid(n, (cvecs + g - 1) / g);
  size_t smem = 2 * (size_t)ty * g * VEC * sizeof(float);
  two_read_instance_norm_kernel<T, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), s, c, eps, relu);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- one read ---
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows s < cnt with s = a (mod m).
__device__ __forceinline__ float rows_congruent(int cnt, int a, int m) {
  return cnt > a ? (float)((cnt - 1 - a) / m + 1) : 0.f;
}

// (n_a, mean_a, m2_a) <- merged with (n_b, mean_b, m2_b) (Chan et al.).
__device__ __forceinline__ void chan_merge(float n_a, float& mean_a, float& m2_a, float n_b,
                                           float mean_b, float m2_b) {
  if (n_b == 0.f) return;
  if (n_a == 0.f) { mean_a = mean_b; m2_a = m2_b; return; }
  const float n = n_a + n_b, delta = mean_b - mean_a;
  mean_a += delta * (n_b / n);
  m2_a += m2_b + delta * delta * (n_a * n_b / n);
}

// Rows of the plane held by cluster rank r: [r * rows, min(S, (r + 1) * rows)).
__device__ __forceinline__ int rows_of(int r, int rows, int S) {
  return max(0, min(S - r * rows, rows));
}

constexpr int LOAD_GROUPS = 4;  // cp.async groups per thread, consumed in turn

// grid = (N * cluster, ceil(C / cblock)), cluster dims (cluster, 1, 1),
// blockDim = (BX = ceil(cblock / VEC), TY), TY a power of two. Thread
// (tx, ty) copies, reduces and normalizes rows s = ty (mod TY) of its
// channel vector, so its own copies need no barrier before it reads them.
// Shared memory: slice [rows][cblock] T (rounded up to 16 bytes) | mean, M2
// [2][TY][BX * VEC] f32 | stat [2][cblock] f32 (this CTA's mean, M2).
template <typename T, int VEC>
__global__ void __launch_bounds__(ONE_READ_THREADS) one_read_instance_norm_kernel(
    const T* __restrict__ x, T* __restrict__ y, int S, int C, int cblock, int rows,
    float eps, int relu) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int BX = blockDim.x, TY = blockDim.y, tx = threadIdx.x, ty = threadIdx.y;
  const int width = BX * VEC;
  const size_t slice_bytes = ((size_t)rows * cblock * sizeof(T) + 15) / 16 * 16;
  T* slice = reinterpret_cast<T*>(smem4);
  float* red_mean = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + slice_bytes);
  float* red_m2 = red_mean + TY * width;
  float* stat = red_m2 + TY * width;
  using P = Pack<T, VEC>;

  const int sample = blockIdx.x / csize;
  const int cl = tx * VEC;                     // my first channel in the block
  const int ch = blockIdx.y * cblock + cl;     // ... in the tensor
  const bool active = cl < cblock && ch < C;
  const int cnt = rows_of(rank, rows, S);
  const int64_t base = ((int64_t)sample * S + (int64_t)rank * rows) * C + ch;
  const int iters = (rows + TY - 1) / TY;      // row steps of every thread
  const int per_group = (iters + LOAD_GROUPS - 1) / LOAD_GROUPS;

  // 1. my rows into shared memory, one read of device memory, in groups
  for (int gi = 0; gi < LOAD_GROUPS; ++gi) {
    if (active) {
      for (int i = gi * per_group; i < min(iters, (gi + 1) * per_group); ++i) {
        const int s = ty + i * TY;
        if (s >= cnt) break;
        if constexpr (sizeof(P) == 16) {
          cp_async16(slice + s * cblock + cl, x + base + (int64_t)s * C);
        } else {
          *reinterpret_cast<P*>(slice + s * cblock + cl) =
              *reinterpret_cast<const P*>(x + base + (int64_t)s * C);
        }
      }
    }
    if constexpr (sizeof(P) == 16) cp_commit();
  }

  // 2. my rows' mean and M2 per channel, shifted by my first row, each
  //    group as it lands
  float shift[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) { shift[v] = 0.f; s1[v] = 0.f; s2[v] = 0.f; }
#pragma unroll
  for (int gi = 0; gi < LOAD_GROUPS; ++gi) {
    if constexpr (sizeof(P) == 16) {
      if (gi == 0) cp_wait<LOAD_GROUPS - 1>();
      else if (gi == 1) cp_wait<LOAD_GROUPS - 2>();
      else if (gi == 2) cp_wait<LOAD_GROUPS - 3>();
      else cp_wait<0>();
    }
    if (!active) continue;
    for (int i = gi * per_group; i < min(iters, (gi + 1) * per_group); ++i) {
      const int s = ty + i * TY;
      if (s >= cnt) break;
      const P p = *reinterpret_cast<const P*>(slice + s * cblock + cl);
      if (i == 0) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) shift[v] = to_f32(p.v[v]);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float d = to_f32(p.v[v]) - shift[v];
        s1[v] += d;
        s2[v] = fmaf(d, d, s2[v]);
      }
    }
  }
  const float n_me = rows_congruent(cnt, ty, TY);
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float md = n_me > 0.f ? s1[v] / n_me : 0.f;
    red_mean[ty * width + tx * VEC + v] = shift[v] + md;
    red_m2[ty * width + tx * VEC + v] = fmaxf(s2[v] - s1[v] * md, 0.f);
  }
  __syncthreads();
  // 3. merge over ty in a fixed tree: before the level of `half`, node a
  //    holds the rows s = a (mod 2 half)
  for (int half = TY / 2; half > 0; half >>= 1) {
    if (ty < half) {
      const float n_a = rows_congruent(cnt, ty, 2 * half);
      const float n_b = rows_congruent(cnt, ty + half, 2 * half);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int i = ty * width + tx * VEC + v, j = (ty + half) * width + tx * VEC + v;
        float mean = red_mean[i], m2 = red_m2[i];
        chan_merge(n_a, mean, m2, n_b, red_mean[j], red_m2[j]);
        red_mean[i] = mean;
        red_m2[i] = m2;
      }
    }
    __syncthreads();
  }
  if (ty == 0 && active) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      stat[cl + v] = red_mean[tx * VEC + v];
      stat[cblock + cl + v] = red_m2[tx * VEC + v];
    }
  }
  if (csize > 1) cluster.sync(); else __syncthreads();

  // 4. merge every rank's (count, mean, M2) in rank order, one thread per
  //    channel, the remote loads issued together
  if (active) {
    for (int v = ty; v < VEC; v += TY) {
      float r_mean[MAX_CLUSTER], r_m2[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        if (r < csize) {
          const float* st = csize > 1 ? cluster.map_shared_rank(stat, r) : stat;
          r_mean[r] = st[cl + v];
          r_m2[r] = st[cblock + cl + v];
        }
      }
      float n_a = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        if (r < csize) {
          const float n_b = (float)rows_of(r, rows, S);
          chan_merge(n_a, mean, m2, n_b, r_mean[r], r_m2[r]);
          n_a += n_b;
        }
      }
      red_mean[tx * VEC + v] = mean;
      red_m2[tx * VEC + v] = rsqrtf(fmaxf(m2 / (float)S, 0.f) + eps);
    }
  }
  __syncthreads();

  // 5. normalize my rows from shared memory and write them once
  if (active) {
    float mean[VEC], inv[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) { mean[v] = red_mean[tx * VEC + v]; inv[v] = red_m2[tx * VEC + v]; }
    for (int s = ty; s < cnt; s += TY) {
      const P p = *reinterpret_cast<const P*>(slice + s * cblock + cl);
      P o;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float r = (to_f32(p.v[v]) - mean[v]) * inv[v];
        if (relu) r = fmaxf(r, 0.f);
        o.v[v] = from_f32<T>(r);
      }
      *reinterpret_cast<P*>(y + base + (int64_t)s * C) = o;
    }
  }
  // the other ranks may still be reading `stat`
  if (csize > 1) cluster.sync();
}

// Threads (BX, TY) and shared bytes of a one-read launch: at most 256
// threads, and at least MIN_ROWS rows per thread where the slice has them,
// so that a small plane's CTAs are small and many fit on an SM at once.
constexpr int MIN_ROWS = 8;
template <typename T, int VEC>
size_t one_read_shape(int cblock, int rows, dim3* block) {
  const int bx = (cblock + VEC - 1) / VEC;
  int ty = 1;
  while (ty * 2 * MIN_ROWS <= rows && bx * ty * 2 <= ONE_READ_THREADS) ty <<= 1;
  *block = dim3(bx, ty);
  const size_t slice = ((size_t)rows * cblock * sizeof(T) + 15) / 16 * 16;
  return slice + (2 * (size_t)ty * bx * VEC + 2 * (size_t)cblock) * sizeof(float);
}

template <typename T, int VEC>
int launch_one_read(const void* x, void* y, int n, int s, int c, float eps, int relu,
                    int cluster, int cblock, cudaStream_t stream) {
  const int rows = (s + cluster - 1) / cluster;
  dim3 block;
  const size_t smem = one_read_shape<T, VEC>(cblock, rows, &block);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (block.x > (unsigned)ONE_READ_THREADS || smem > (size_t)limit)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(one_read_instance_norm_kernel<T, VEC>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * cluster), (unsigned)((c + cblock - 1) / cblock));
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, one_read_instance_norm_kernel<T, VEC>,
                                static_cast<const T*>(x), static_cast<T*>(y), s, c, cblock,
                                rows, eps, relu);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int dispatch(const void* x, void* y, int n, int s, int c, float eps, int relu, int cluster,
             int cblock, cudaStream_t stream) {
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0) && c % VEC == 0 &&
                   (cluster == 0 || cblock % VEC == 0);
  if (cluster == 0) {
    return vec ? launch_two_read<T, VEC>(x, y, n, s, c, eps, relu, stream)
               : launch_two_read<T, 1>(x, y, n, s, c, eps, relu, stream);
  }
  return vec ? launch_one_read<T, VEC>(x, y, n, s, c, eps, relu, cluster, cblock, stream)
             : launch_one_read<T, 1>(x, y, n, s, c, eps, relu, cluster, cblock, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. cluster: 0 = the two-read route, else
// the one-read route over a cluster of `cluster` CTAs (1, 2, 4 or 8) per
// (sample, block of `cblock` channels). Returns cudaGetLastError() after the
// launch (a refused launch never runs and a later synchronize would not
// report it), or cudaErrorInvalidValue for a plan the kernels do not take.
// Launches on `stream` and does not synchronize.
extern "C" int tpumil_instance_norm(const void* x, void* y, int n, int s, int c, int dtype,
                                    int relu, float eps, int cluster, int cblock,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || s < 1 || c < 1 || cluster < 0 || cluster > MAX_CLUSTER ||
      (cluster & (cluster - 1)) != 0 || (cluster > 0 && (cblock < 1 || cblock > c)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float, 4>(x, y, n, s, c, eps, relu, cluster, cblock, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, 8>(x, y, n, s, c, eps, relu, cluster, cblock, st);
  return (int)cudaErrorInvalidValue;
}
