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
//   p = exp(l - m_run) rounded to bf16 before acc += p^T f; s sums the
//   unrounded p; m_run is the running max after each tile, and acc and s are
//   rescaled by exp(m_old - m_new) (the TPU kernel's online softmax).
// The TPU kernel runs that online softmax over one serial grid of 1024-row
// tiles. Here each CTA runs it over its own contiguous range of 64-row
// tiles, and a fixed-order merge joins the ranges:
//   m = max_g m_g, s = sum_g s_g e^{m_g - m}, B = sum_g acc_g e^{m_g - m} / s.
// attention_pool_bf16_plain(tile_n=64, segment_rows=rows_per_cta) rounds at
// the same points. The wrapper computes rows_per_cta (bf16_partition).
//
// What bounds it: bytes. At N = 65529, K = 512, C = 2 the bag is 67.1 MB of
// bf16 and the logits 0.52 MB: 0.020 ms at 3.35 TB/s. The q-MLP and logits
// are ~13 GFLOP as bf16 products (the hi/lo split below included): 0.013 ms
// at 989 TFLOP/s, so the tensor work has to run beside the stream, not after
// it, and the bag must be read from HBM once. On this design two on-chip
// limits come first: W0 [128, K] (128 KB at K = 512) does not fit in shared
// memory beside a resident tile, so every SM restages it from L2 for each
// 64-row tile, twice the bag's bytes through L2; and one warpgroup runs a
// tile's z1 and then its q epilogue in series (PERF.md has the per-phase
// times).
//
// The design: one persistent CTA per SM over its rows, three roles.
//  * loaders (warp 8): lane 0 issues TMA loads of the feats tile as 2-D
//    boxes of 64 rows x 64 bf16 (128 B, 128B-swizzled) into a ring of S
//    boxes; lane 1 those of W0's K chunks [128 x 64] into a ring of W0R, and
//    W2 [128 x 128] once, which stays resident. Full and empty mbarriers
//    pace each ring.
//  * the q-MLP warpgroup (warps 0-3): z1 = f W0^T as wgmma m64n128k16 with
//    both operands in shared memory and the sum in f32 registers; h =
//    relu(z1 + b0) is split in registers into bf16 hi + lo (h = hi + lo to 16
//    bits) and fed as register A operands to two h W2^T wgmmas; q = tanh(. +
//    b2), split again, and the logits q q_max^T / sqrt(D) on mma.sync
//    m16n8k16 (N = 8 classes). Each sum runs in the wgmma accumulator: a
//    fresh f32 sum per step folded in by FADD left the logits' error against
//    float64 where it was (3.8e-6 of their max, the hi/lo split's), so there
//    is none. It writes the masked logits to global memory and to a
//    double-buffered 64 x 8 tile in shared memory, then goes on to the next
//    tile while
//  * the pool warpgroup (warps 4-7) runs the online softmax on that tile and
//    acc = acc corr + p^T f in f32 FFMA over the CP classes C rounds up to
//    (1, 2, 4 or 8, a template argument), f read from the boxes still in
//    shared memory (a bf16 p times a bf16 f is exact in f32); each CTA's
//    acc lives in its own partial in global memory (L2), read and written
//    once per tile. A box is released when both warpgroups are done with it.
//  * pool_merge_bf16_kernel, a second small kernel: the fixed-order merge.
// A tile's boxes stay in shared memory until the pool is done with them
// while K <= 64 S (S = 17 boxes with the nonlinear q, 21 with the linear:
// K <= 1088 and 1344, so the multiscale K = 1024 too, the next tile's boxes
// overlapping by K box): one HBM read of the bag. Wider rows stream through
// the ring for z1 only, and the pool warpgroup re-reads the tile's rows from
// global memory right after the logits: the CTA has just read them, so they
// hit L2 and the bag still leaves HBM once.
// No float atomics: a rerun is bitwise equal. Rows >= n_valid lie outside
// the feats tensor map (TMA fills them with zeros); their logits are
// written as NEG and their weight is 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;        // ATTN_DIM
constexpr int CMAX = 8;       // compile-time bound on classes
constexpr float NEG = -1e30f;
constexpr int TM = 64;        // rows per tile
constexpr int BK = 64;        // bf16 columns per TMA box (128 B)
constexpr int BOX = TM * BK * 2;       // bytes of one feats box
constexpr int WCH = D * BK * 2;        // bytes of one W0 chunk (and a W2 half)
constexpr int NT = 288;       // q-MLP warpgroup, pool warpgroup, a loader warp
constexpr int SMAX = 32;      // ring depth bound
constexpr int LDQ = D + 8;    // row of q_max in shared memory (bank offset 4 words)
constexpr int SMEM_LIMIT = 232448;
#ifndef K1BF16_W0R
#define K1BF16_W0R 3  // tools/pool_bf16_profile.py --phases times 2 to 5
#endif
constexpr int W0R = K1BF16_W0R;  // depth of the W0 chunk ring

// Shared memory (bytes, each region 1024-aligned where TMA writes it): ring
// S BOX | W0 ring W0R WCH | W2 2 WCH (nonlinear) | q_max [CMAX][LDQ] bf16 |
// b0, b2 [D] f32 | logits 2 [TM][CMAX] f32 | p [TM][CMAX] f32 | reductions
// [2][4][CMAX] f32 | mbarriers.
struct Layout {
  int S;
  uint32_t w0, w2, qm, bias, lbuf, pbuf, red, bars, total;
};

__host__ __device__ inline Layout layout(int S, bool nl) {
  Layout L;
  L.S = S;
  L.w0 = (uint32_t)S * BOX;
  L.w2 = L.w0 + W0R * WCH;
  L.qm = L.w2 + (nl ? 2 * WCH : 0);
  L.bias = L.qm + CMAX * LDQ * 2;
  L.lbuf = L.bias + 2 * D * 4;
  L.pbuf = L.lbuf + 2 * TM * CMAX * 4;
  L.red = L.pbuf + TM * CMAX * 4;
  L.bars = L.red + 2 * 4 * CMAX * 4;
  // full[S], empty[S], w0 full[W0R], w0 empty[W0R], w2 full, logits full[2], empty[2]
  L.total = L.bars + (2 * S + 2 * W0R + 5) * 8 + 1024;  // + slack to align the base
  return L;
}

int ring_depth(bool nl) {
  int S = SMAX;
  while (S > 1 && layout(S, nl).total > (uint32_t)SMEM_LIMIT) --S;
  return S;
}

// Built with -DK1_TRACE (tools/pool_bf16_profile.py --phases), CTAs 0-3
// stamp %globaltimer at each phase of each tile: the q-MLP warpgroup 0: tile
// start, 1: z1 done, 2: q done, 3: logits handed over; the pool warpgroup
// 4: logits taken, 5: softmax done, 6: p^T f done.
#ifdef K1_TRACE
constexpr int TRACE_TILES = 64;
__device__ unsigned long long g_trace[4][TRACE_TILES][8];
__device__ __forceinline__ void stamp(int tile, int phase) {
  if (blockIdx.x < 4 && tile < TRACE_TILES) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[blockIdx.x][tile][phase] = t;
  }
}
#else
__device__ __forceinline__ void stamp(int, int) {}
#endif

// ----------------------------------------------------------- primitives ---
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

// Block until the phase of parity `parity` of barrier b has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// 2-D TMA load of the box at (col, row) of map into dst; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma operand descriptor of a K-major tile in the 128B-swizzled layout TMA
// writes: 8-row groups of 128-byte rows, 1024 bytes apart (SBO); the start
// address advances by 32 bytes (2 in the field) per k16 step.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that an in-flight wgmma reads or writes: the compiler may
// neither reuse nor read them across this point.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

#define ACC_OUT8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC_OUT64                                                                           \
  ACC_OUT8(0), ACC_OUT8(8), ACC_OUT8(16), ACC_OUT8(24), ACC_OUT8(32), ACC_OUT8(40), \
      ACC_OUT8(48), ACC_OUT8(56)
#define ACC_REGS                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B, 64 x 128 x 16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC_OUT64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, 64 x 128 x 16, A in registers (the m16n8k16 A fragment of each
// warp's 16 rows), B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : ACC_OUT64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// tanh(x) = 1 - 2 / (e^{2|x|} + 1), sign restored: within ~3e-7 of tanh in
// absolute terms (ex2.approx and a 2-ulp division), a tenth of tanhf's cost.
__device__ __forceinline__ float tanh_f32(float x) {
  const float e = __expf(2.f * fabsf(x));
  return copysignf(1.f - __fdividef(2.f, e + 1.f), x);
}

// Two f32 -> bf16 (round to nearest even), lo in the low half; and back.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Split a wgmma accumulator (64 rows x 128 columns: d[4j + i] holds row 16w
// + g + 8 (i >> 1), column 8j + 2t + (i & 1) of warp w, lane 4g + t) into
// bf16 hi + lo A fragments of the next product's 8 k16 steps: the
// accumulator layout of columns [16k, 16k + 16) is the A layout of step k.
__device__ __forceinline__ void split_frags(const float (&d)[64], uint32_t (&hi)[8][4],
                                            uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a0: (g, 2t), a1: (g + 8, 2t), a2: (g, 2t + 8), a3: (g + 8, 2t + 8)
      const int j = 2 * k + (i >> 1), r = 2 * (i & 1);
      const float x0 = d[4 * j + r], x1 = d[4 * j + r + 1];
      const uint32_t h = pack2(x0, x1);
      hi[k][i] = h;
      lo[k][i] = pack2(x0 - bf16_lo(h), x1 - bf16_hi(h));
    }
}

// ------------------------------------------------------------ main kernel ---
// CTA g takes rows [g rpc, min((g + 1) rpc, n_valid)) in tiles of TM rows.
// part[g]: acc [C][K] | m [CMAX] | s [CMAX].
template <bool NL, int CP>
__global__ void __launch_bounds__(NT, 1) pool_bf16_kernel(
    const __grid_constant__ CUtensorMap map_f, const __grid_constant__ CUtensorMap map_w0,
    const __grid_constant__ CUtensorMap map_w2, const bf16* __restrict__ feats,
    const float* __restrict__ b0, const float* __restrict__ b2, const bf16* __restrict__ qm,
    int n, int n_valid, int K, int C, int rpc, int S, float* __restrict__ logits,
    float* __restrict__ part) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L = layout(S, NL);
  uint8_t* ring = smem;
  uint8_t* w0r = smem + L.w0;
  uint8_t* w2s = smem + L.w2;
  bf16* sQm = reinterpret_cast<bf16*>(smem + L.qm);
  float* sB0 = reinterpret_cast<float*>(smem + L.bias);
  float* sB2 = sB0 + D;
  float* lbuf = reinterpret_cast<float*>(smem + L.lbuf);
  float* pbuf = reinterpret_cast<float*>(smem + L.pbuf);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + S;
  uint64_t* w0full = empty + S;
  uint64_t* w0empty = w0full + W0R;
  uint64_t* w2full = w0empty + W0R;
  uint64_t* lfull = w2full + 1;
  uint64_t* lempty = lfull + 2;

  const int tid = threadIdx.x;
  const int nb = (K + BK - 1) / BK;            // boxes per tile row
  const bool resident = nb <= S;               // the tile stays for the pool
  const int seg0 = blockIdx.x * rpc;
  const int seg1 = min(seg0 + rpc, n_valid);
  const int tiles = (seg1 - seg0 + TM - 1) / TM;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, resident ? 256 : 128);
    }
    for (int i = 0; i < W0R; ++i) {
      mbar_init(w0full + i, 1);
      mbar_init(w0empty + i, 128);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(lfull + i, 128);
      mbar_init(lempty + i, 128);
    }
    mbar_init(w2full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < CMAX * D; e += NT)
    sQm[(e / D) * LDQ + e % D] = e < C * D ? qm[e] : __float2bfloat16(0.f);
  for (int e = tid; e < TM * CMAX; e += NT) pbuf[e] = 0.f;
  for (int e = tid; e < D; e += NT) {
    sB0[e] = b0[e];
    sB2[e] = NL ? b2[e] : 0.f;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  if (warp >= 8) {
    // ------------------------------------------- loaders: lane 0, lane 1
    if (lane > 1) return;
    if (lane == 0) {  // feats boxes
      for (int i = 0, b = 0; i < tiles; ++i)
        for (int j = 0; j < nb; ++j, ++b) {
          const int slot = b % S, use = b / S;
          if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
          mbar_expect_tx(full + slot, BOX);
          tma_load(ring + slot * BOX, &map_f, full + slot, j * BK, seg0 + i * TM);
        }
    } else {  // W2 once, then W0's chunks for every tile
      if (NL) {
        mbar_expect_tx(w2full, 2 * WCH);
        tma_load(w2s, &map_w2, w2full, 0, 0);
        tma_load(w2s + WCH, &map_w2, w2full, BK, 0);
      }
      for (int i = 0, c = 0; i < tiles; ++i)
        for (int j = 0; j < nb; ++j, ++c) {
          const int slot = c % W0R, use = c / W0R;
          if (use > 0) mbar_wait(w0empty + slot, (use - 1) & 1);
          mbar_expect_tx(w0full + slot, WCH);
          tma_load(w0r + slot * WCH, &map_w0, w0full + slot, j * BK, 0);
        }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  if (warp < 4) {
    // ------------------------------------------------ q-MLP warpgroup
    const int w = warp;
    if (NL) mbar_wait(w2full, 0);
    const float scale = 1.f / sqrtf((float)D);
    for (int i = 0, b = 0; i < tiles; ++i) {
      const int row0 = seg0 + i * TM;
      float acc[64];
      if (tid == 0) stamp(i, 0);
      // z1 = f W0^T over the tile's boxes (W0 chunk b goes with box b); box
      // j is released once the wgmma group after it has been issued and its
      // own has completed
      wg_fence();
      for (int j = 0; j < nb; ++j, ++b) {
        const int slot = b % S;
        mbar_wait(full + slot, (b / S) & 1);
        mbar_wait(w0full + b % W0R, (b / W0R) & 1);
        const uint64_t da = sw128_desc(ring + slot * BOX);
        const uint64_t db = sw128_desc(w0r + (b % W0R) * WCH);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss(acc, da + 2 * kk, db + 2 * kk, j | kk);
        wg_commit();
        if (j > 0) {
          wg_wait<1>();
          mbar_arrive(empty + (b - 1) % S);
          mbar_arrive(w0empty + (b - 1) % W0R);
        }
      }
      wg_wait<0>();
      pin(acc);
      if (tid == 0) stamp(i, 1);
      mbar_arrive(empty + (b - 1) % S);
      mbar_arrive(w0empty + (b - 1) % W0R);

      // h = relu(z1 + b0) (nonlinear) or q = z1 + b0 (linear)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float z = acc[4 * j + e] + sB0[8 * j + 2 * t + (e & 1)];
          acc[4 * j + e] = NL ? fmaxf(z, 0.f) : z;
        }
      uint32_t ahi[8][4], alo[8][4];
      split_frags(acc, ahi, alo);
      if (NL) {  // q = tanh(h W2^T + b2): the small product first, as hi + lo
        wg_fence();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint64_t db = sw128_desc(w2s + (k >> 2) * WCH) + 2 * (k & 3);
          wgmma_rs(acc, alo[k], db, k);
          wgmma_rs(acc, ahi[k], db, 1);
        }
        wg_commit();
        wg_wait<0>();
        pin(acc);
        pin(ahi);
        pin(alo);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * j + e] = tanh_f32(acc[4 * j + e] + sB2[8 * j + 2 * t + (e & 1)]);
        split_frags(acc, ahi, alo);
      }
      if (tid == 0) stamp(i, 2);
      // l = q q_max^T / sqrt(D) on mma.sync: one n-tile of the 8 classes
      // (those >= C are zero rows of sQm), a fresh sum per k16 step
      float lg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bf16* qb = sQm + g * LDQ + 16 * k + 2 * t;
        const uint32_t q0 = *reinterpret_cast<const uint32_t*>(qb);
        const uint32_t q1 = *reinterpret_cast<const uint32_t*>(qb + 8);
        float s4[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(s4, alo[k], q0, q1);
        mma_bf16(s4, ahi[k], q0, q1);
#pragma unroll
        for (int e = 0; e < 4; ++e) lg[e] += s4[e];
      }
      const int buf = i & 1;
      if (i >= 2) mbar_wait(lempty + buf, ((i >> 1) - 1) & 1);
      float* lb = lbuf + buf * TM * CMAX;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * w + g + 8 * (e >> 1), c = 2 * t + (e & 1);
        const float v = row0 + r < n_valid ? lg[e] * scale : NEG;
        lb[r * CMAX + c] = v;
        if (c < C && row0 + r < n) logits[(int64_t)(row0 + r) * C + c] = v;
      }
      mbar_arrive(lfull + buf);
      if (tid == 0) stamp(i, 3);
    }
    return;
  }

  // ---------------------------------------------------------- pool warpgroup
  const int pt = tid - 128, pw = pt >> 5;
  float m_run[CMAX], s_run[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    m_run[c] = NEG;
    s_run[c] = 0.f;
  }
  const int64_t pstride = (int64_t)C * K + 2 * CMAX;
  float* mypart = part + (int64_t)blockIdx.x * pstride;
  const int nx = K / 4;  // 8-byte chunks of a row
  for (int i = 0; i < tiles; ++i) {
    const int row0 = seg0 + i * TM, rows = min(TM, seg1 - row0), buf = i & 1;
    mbar_wait(lfull + buf, (i >> 1) & 1);
    if (pt == 0) stamp(i, 4);
    const float* lb = lbuf + buf * TM * CMAX;
    // the tile's max per class: warp pw takes classes pw and pw + 4
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = pw + 4 * h;
      if (c < C) {
        float v = fmaxf(lb[lane * CMAX + c], lb[(lane + 32) * CMAX + c]);
        for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
        if (lane == 0) red[c] = v;
      }
    }
    named_sync(1, 128);
    float m_new[CMAX], corr[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      m_new[c] = c < C ? fmaxf(m_run[c], red[c]) : NEG;
      corr[c] = c < C ? expf(m_run[c] - m_new[c]) : 0.f;
    }
    // p = exp(l - m_new): thread (row pt % 64, class parity pt / 64); the
    // unrounded p summed per warp in a fixed shuffle order
    {
      const int r = pt & 63, par = pt >> 6;
#pragma unroll
      for (int h = 0; h < CMAX / 2; ++h) {
        const int c = par + 2 * h;
        if (c < C) {
          const float p = expf(lb[r * CMAX + c] - m_new[c]);
          pbuf[r * CMAX + c] = __bfloat162float(__float2bfloat16_rn(p));
          float v = p;
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0) red[CMAX + pw * CMAX + c] = v;
        }
      }
    }
    mbar_arrive(lempty + buf);
    named_sync(1, 128);
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) {
        const int w0 = (c & 1) * 2;  // the two warps that summed class c
        s_run[c] = s_run[c] * corr[c] + (red[CMAX + w0 * CMAX + c] + red[CMAX + (w0 + 1) * CMAX + c]);
        m_run[c] = m_new[c];
      }
    if (pt == 0) stamp(i, 5);
    // acc = acc corr + p^T f over the CP <= 8 classes that C rounds up to
    // (p of classes >= C is 0): thread pt takes the 8-byte column chunks x =
    // pt, pt + 128, ... (4 bf16 each)
    const int b0i = i * nb;
    if (resident)
      for (int j = 0; j < nb; ++j) mbar_wait(full + (b0i + j) % S, ((b0i + j) / S) & 1);
    for (int x = pt; x < nx; x += 128) {
      // the partial so far: loaded first, added last, so that its load
      // overlaps the rows
      float4 old[CP];
      float a[CP][4];
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        old[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i > 0 && c < C) old[c] = *reinterpret_cast<const float4*>(mypart + (int64_t)c * K + 4 * x);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[c][e] = 0.f;
      }
      auto add_row = [&](uint2 u, int r) {
        const float f[4] = {bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y)};
        const float* pr = pbuf + r * CMAX;
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const float p = pr[c];
#pragma unroll
          for (int e = 0; e < 4; ++e) a[c][e] = fmaf(p, f[e], a[c][e]);
        }
      };
      if (resident) {
        const uint8_t* box = ring + ((b0i + x / 16) % S) * BOX + 8 * (x & 1);
        const int cx = (x >> 1) & 7;
#pragma unroll 8
        for (int r = 0; r < rows; ++r)
          add_row(*reinterpret_cast<const uint2*>(box + r * 128 + ((cx ^ (r & 7)) << 4)), r);
      } else {
        const bf16* grow = feats + (int64_t)row0 * K + 4 * x;
#pragma unroll 8
        for (int r = 0; r < rows; ++r)
          add_row(__ldg(reinterpret_cast<const uint2*>(grow + (int64_t)r * K)), r);
      }
#pragma unroll
      for (int c = 0; c < CP; ++c)
        if (c < C)
          *reinterpret_cast<float4*>(mypart + (int64_t)c * K + 4 * x) = make_float4(
              fmaf(old[c].x, corr[c], a[c][0]), fmaf(old[c].y, corr[c], a[c][1]),
              fmaf(old[c].z, corr[c], a[c][2]), fmaf(old[c].w, corr[c], a[c][3]));
    }
    if (resident)
      for (int j = 0; j < nb; ++j) mbar_arrive(empty + (b0i + j) % S);
    named_sync(1, 128);  // pbuf and red are consumed before the next tile
    if (pt == 0) stamp(i, 6);
  }
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C && c == pt) {
      mypart[(int64_t)C * K + c] = m_run[c];
      mypart[(int64_t)C * K + CMAX + c] = s_run[c];
    }
  // rows past the last tile (n > tiles * TM) are padding too
  const int64_t all_tiles = ((int64_t)n_valid + TM - 1) / TM;
  for (int64_t e = all_tiles * TM * C + (int64_t)blockIdx.x * 128 + pt; e < (int64_t)n * C;
       e += (int64_t)gridDim.x * 128)
    logits[e] = NEG;
}

// B = sum_g acc_g e^{m_g - m} / s, m = max_g m_g, s = sum_g s_g e^{m_g - m}
// over the G partials. CTA (bx, c) takes columns [32 bx, + 32) of class c;
// thread (j = tid / 32, x = tid % 32) sums the partials g = j, j + 8, ...
// in order, then thread j = 0 the 8 slices in order.
__global__ void __launch_bounds__(256) pool_merge_bf16_kernel(const float* __restrict__ part,
                                                              int G, int K, int C,
                                                              float* __restrict__ out_b,
                                                              float* __restrict__ out_m,
                                                              float* __restrict__ out_s) {
  constexpr int SL = 8;
  __shared__ float sA[SL][32], sS[SL];
  const int c = blockIdx.y, j = threadIdx.x >> 5, x = threadIdx.x & 31;
  const int k = blockIdx.x * 32 + x;
  const int64_t ps = (int64_t)C * K + 2 * CMAX;
  float m = NEG;
  for (int g = 0; g < G; ++g) m = fmaxf(m, part[g * ps + (int64_t)C * K + c]);
  float a = 0.f, s = 0.f;
  for (int g = j; g < G; g += SL) {
    const float* pg = part + g * ps;
    const float wg = expf(pg[(int64_t)C * K + c] - m);
    if (k < K) a += pg[(int64_t)c * K + k] * wg;
    s += pg[(int64_t)C * K + CMAX + c] * wg;
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
    out_m[c] = m;
    out_s[c] = s;
  }
}

// ------------------------------------------------------------------ host ---
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so that the
// library links against cudart only.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D bf16 map of a row-major [rows, cols] tensor, boxes of box_rows x 64
// columns, 128B-swizzled; out-of-bounds elements read as zero.
int make_map(CUtensorMap* map, const void* ptr, int cols, int rows, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

bool bad_args(int n, int n_valid, int K, int C, int rpc) {
  return K <= 0 || K % 8 != 0 || C < 1 || C > CMAX || n_valid < 1 || n_valid > n || rpc < TM ||
         rpc % TM != 0;
}

int grid_of(int n_valid, int rpc) { return (n_valid + rpc - 1) / rpc; }

}  // namespace

#ifdef K1_TRACE
// The stamps of the last launch: unsigned long long [4][TRACE_TILES][8].
extern "C" int tpumil_attention_pool_bf16_trace(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
#endif

// Bytes of dynamic shared memory of K1-bf16's main kernel.
extern "C" long long tpumil_attention_pool_fwd_bf16_smem(int nonlinear) {
  const bool nl = nonlinear != 0;
  return layout(ring_depth(nl), nl).total;
}

// Floats of scratch that K1-bf16 needs (one partial per CTA), or -(CUDA
// error code). rows_per_cta: a multiple of 64 (bf16_partition).
extern "C" long long tpumil_attention_pool_fwd_bf16_scratch(int nonlinear, int n, int n_valid,
                                                            int K, int C, int rows_per_cta) {
  (void)nonlinear;
  if (bad_args(n, n_valid, K, C, rows_per_cta)) return -(long long)cudaErrorInvalidValue;
  return (long long)grid_of(n_valid, rows_per_cta) * ((long long)C * K + 2 * CMAX);
}

// K1-bf16. feats [n, K], w0 [D, K], w2 [D, D], qm [C, D] bf16, feats, w0 and
// w2 16-byte aligned; b0, b2 [D] f32 (w2, b2 unused for the linear q).
// scratch: tpumil_attention_pool_fwd_bf16_scratch floats. CTA g pools rows
// [g rows_per_cta, (g + 1) rows_per_cta). Outputs (f32) B [C, K], m [C],
// s [C] and the masked logits [n, C] (rows >= n_valid at -1e30).
extern "C" int tpumil_attention_pool_fwd_bf16(const void* feats, const void* w0, const void* b0,
                                              const void* w2, const void* b2, const void* qm,
                                              int n, int n_valid, int K, int C, int nonlinear,
                                              int rows_per_cta, void* scratch, void* out_b,
                                              void* out_m, void* out_s, void* logits,
                                              void* stream) {
  if (bad_args(n, n_valid, K, C, rows_per_cta)) return (int)cudaErrorInvalidValue;
  const bool nl = nonlinear != 0;
  const int S = ring_depth(nl);
  const Layout L = layout(S, nl);
  CUtensorMap mf, mw0, mw2;
  int err = make_map(&mf, feats, K, n_valid, TM);
  if (err == 0) err = make_map(&mw0, w0, K, D, D);
  if (err == 0) err = nl ? make_map(&mw2, w2, D, D, D) : make_map(&mw2, w0, K, D, D);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = grid_of(n_valid, rows_per_cta);
  const int cp = C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : 8;
  const bf16* f = static_cast<const bf16*>(feats);
  const float* b0f = static_cast<const float*>(b0);
  const float* b2f = static_cast<const float*>(b2);
  const bf16* qmh = static_cast<const bf16*>(qm);
  float* part = static_cast<float*>(scratch);
  float* l = static_cast<float*>(logits);
#define K1BF16_LAUNCH(NLV, CPV)                                                                 \
  if (nl == NLV && cp == CPV) {                                                                 \
    err = (int)cudaFuncSetAttribute((const void*)pool_bf16_kernel<NLV, CPV>,                   \
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total); \
    if (err != 0) return err;                                                                   \
    pool_bf16_kernel<NLV, CPV><<<G, NT, L.total, st>>>(mf, mw0, mw2, f, b0f, b2f, qmh, n,       \
                                                       n_valid, K, C, rows_per_cta, S, l, part); \
  }
  K1BF16_LAUNCH(true, 1)
  K1BF16_LAUNCH(true, 2)
  K1BF16_LAUNCH(true, 4)
  K1BF16_LAUNCH(true, 8)
  K1BF16_LAUNCH(false, 1)
  K1BF16_LAUNCH(false, 2)
  K1BF16_LAUNCH(false, 4)
  K1BF16_LAUNCH(false, 8)
#undef K1BF16_LAUNCH
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  pool_merge_bf16_kernel<<<dim3((K + 31) / 32, C), 256, 0, st>>>(
      part, G, K, C, static_cast<float*>(out_b), static_cast<float*>(out_m),
      static_cast<float*>(out_s));
  return (int)cudaGetLastError();
}
