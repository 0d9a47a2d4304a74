// Depthwise convolution over a channels-last grid [rows, cols, C], for
// Hopper: TransMIL's two depthwise sites (models/transmil.py) as one
// operation, forward, input gradient and weight gradient.
//
// Replaces no Pallas kernel: the JAX package has no TransMIL. Added because
// ATen runs an f32 depthwise conv on its native kernels (DepthwiseConv2d.cu,
// not cuDNN), whose weight gradient at batch 1 is one warp per weight
// element walking the whole plane; on the TransMIL bag step those kernels
// took ~5.3 ms of a 16.9 ms step, 25% of the device time in the weight
// gradient alone.
//
// The two sites:
//  * the residual conv of Nystrom attention: a grid of P x 1 over
//    C = heads x 64 channels, 33 taps along the rows, one weight per head
//    (shared by its 64 channels), read straight from the qkv projection's
//    memory (row pitch 3 C), only the last T output rows kept;
//  * the PPEG: a side x side grid over C = 512, dw7(x) + x + dw5(x) +
//    dw3(x), with the cls row in front passed through. Its backward is one
//    merged 7x7 conv: the input gradient through w7 + pad(w5) + pad(w3) +
//    delta, summed as the kernel stages the taps, and one weight gradient
//    whose centre 5x5 and 3x3 crops are w5's and w3's.
//
// The rounding: TransMIL's first gradients amplify f32 rounding (the
// attention's iterative pseudo-inverse), so that two f32 computations of a
// step in another order lie ~1e-6 apart at the largest bags; ATen's
// one-warp weight gradient of the residual conv (two serial sums of P x 64
// products) is itself ~1e-6 from float64. So every pass that the plain
// module computes on ATen's kernels in one order is computed here in that
// order and gives its bits:
//  * forward: each conv one FFMA chain from its bias, taps in (kh, kw)
//    order; the PPEG's three summed as ((dw7 + x) + dw5) + dw3;
//  * the residual conv's input gradient: one chain over the taps in kh
//    order (the PPEG's runs the merged 7x7 in the same order);
//  * the residual conv's weight gradient (dw_wgrad_rows_kernel): per head,
//    tap and lane l, one chain over the rows of dy x v, channels l and l +
//    32 in each row, then the warp's shuffle-down tree, as ATen's kernel.
// Only the PPEG's weight gradient is summed in another (fixed) order.
//
// What bounds it: bytes. A pass reads and writes a few C-wide tensors (14 MB
// each at the cohort's mean bag, 135 MB at the largest), against 33 or 49
// FFMA an element: 2 x 33 / 8 bytes = 8 flop/byte at most, under the card's
// 20 (67 TFLOP/s f32 FFMA over 3.35 TB/s). So each input is read from device
// memory once and each output written once:
//  * a warp spans 32 consecutive channels, so every load and store is 128
//    contiguous bytes;
//  * each thread walks one channel of CW adjacent columns (1 for the
//    residual conv; for the PPEG 2, and 4 for the input gradient) down a
//    band of rows and keeps the kernel's KH input rows in a register ring,
//    unrolled by KH so that every ring index is a compile-time constant: a
//    step loads one new input row (CW + KW - 1 values; the halo columns come
//    from L1) a whole ring ahead of its use, and runs CW x KH x KW FFMA
//    (the PPEG's forward CW x (49 + 25 + 9));
//  * the PPEG's weight gradient accumulates the 49 taps and the bias of its
//    channel in registers over the band, sums them over the CTA's columns
//    through shared memory, and writes one partial per CTA; dw_reduce_kernel
//    sums the partials in a fixed order, so a rerun is bitwise equal (no
//    atomics), and writes every leaf: the 5x5 and 3x3 crops of the merged
//    gradient and the bias gradient three times;
//  * the residual conv's weight gradient is 8 x 33 x 32 serial chains of
//    2 P FFMA: its bound is their latency, not bytes. A thread runs the
//    chains of 3 taps, sharing each row's dy and a 3-row window of v, one
//    warp a CTA on its own SM, with 48 rows in flight by cp.async.
// The rows per CTA come from the wrapper's planner (ops/depthwise.plan),
// from the shape alone. Everything is f32 FFMA: no TF32, no reduced
// precision.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct BandArgs {
  const float* in;  // the grid read by the taps: x (forward, weight
                    // gradient) or dy (input gradient)
  int in_rs, in_cs;  // pitches in floats
  int in_rows;
  const float* dy;  // weight gradient: the output gradient
  float* out;       // forward, input gradient: the result
  int out_rs, out_cs;
  int out_rows;     // rows walked: output rows (or dy rows)
  int cols, channels, group;
  int row_shift;    // the input row of output row r at tap i: r + shift + i - KH/2
  const float* w0;  // [C / group, KH, KW]
  const float* w1;  // the 7x7's centred crops [C, k, k]; null (k 0) else
  int k1;
  const float* w2;
  int k2;
  int delta;        // the forward adds x, the input gradient dy
  const float* b0;  // optional biases, one a weight
  const float* b1;
  const float* b2;
  const float* lead_src;  // lead_n floats copied as they are (PPEG's cls row)
  float* lead_dst;
  int lead_n;
  int band, cb, bc;  // rows, channels and threads across a CTA
  float* part;      // weight gradient: [parts][C][nt]
  int has_bias;     // weight gradient: the bias gradient as tap KH x KW
};

__device__ __forceinline__ float crop_tap(const float* w, int k, int kh, int kw,
                                          int g, int i, int j) {
  const int oi = (kh - k) / 2, oj = (kw - k) / 2;
  const int a = i - oi, b = j - oj;
  return (a >= 0 && a < k && b >= 0 && b < k)
             ? w[(g * k + a) * k + b] : 0.f;
}

// One CTA: channels [blockIdx.x cb, + cb) x columns [blockIdx.y bc CW,
// + bc CW) x rows [blockIdx.z band, + band) of the rows walked; thread t
// holds channel t % cb of the CW columns from (blockIdx.y bc + t / cb) CW.
// MODE 0: forward; 1: input gradient; 2: weight gradient (group 1).
// Offsets are 32-bit (the wrapper keeps every grid under 2^31 floats).
template <int KH, int KW, int CW, int MODE>
__global__ void __launch_bounds__(kThreads)
dw_band_kernel(const BandArgs p) {
  constexpr bool WGRAD = MODE == 2;
  constexpr int PH = KH / 2, NK = KH * KW;
  // the forward's centred crops (the PPEG's 5x5 and 3x3), chained apart
  constexpr int K1 = (MODE == 0 && KW > 1) ? KH - 2 : 0;
  constexpr int K2 = (MODE == 0 && KW > 1) ? KH - 4 : 0;
  constexpr int WW = CW + KW - 1;  // the input columns a thread reads
  const int t = threadIdx.x;
  const int ch = blockIdx.x * p.cb + t % p.cb;
  const int col0 = (blockIdx.y * p.bc + t / p.cb) * CW;
  const bool live = t < p.cb * p.bc && ch < p.channels && col0 < p.cols;
  const int r0 = blockIdx.z * p.band;
  const int r1 = min(r0 + p.band, p.out_rows);

  if (p.lead_n > 0 && (blockIdx.x | blockIdx.y | blockIdx.z) == 0)
    for (int i = t; i < p.lead_n; i += blockDim.x) p.lead_dst[i] = p.lead_src[i];

  // the columns' offsets and bounds, fixed over the band
  int cofs[WW], oofs[CW];
  bool cok[WW], ook[CW];
#pragma unroll
  for (int q = 0; q < WW; ++q) {
    const int c = col0 + q - KW / 2;
    cok[q] = live && c >= 0 && c < p.cols;
    cofs[q] = c * p.in_cs + ch;
  }
#pragma unroll
  for (int q = 0; q < CW; ++q) {
    ook[q] = live && col0 + q < p.cols;
    oofs[q] = (col0 + q) * p.out_cs + ch;
  }
  // one input row's WW values, zero outside the grid (or when !on)
  auto load = [&](float (&dst)[WW], int row, bool on) {
    const bool rok = on && (unsigned)row < (unsigned)p.in_rows;
    const float* base = p.in + row * p.in_rs;
#pragma unroll
    for (int q = 0; q < WW; ++q)
      dst[q] = rok && cok[q] ? __ldg(base + cofs[q]) : 0.f;
  };

  // the forward: each weight as it is, the crops and biases apart; the
  // input gradient: the merged weight, flipped
  float w[NK], w1[K1 * K1 + 1], w2[K2 * K2 + 1];
  float acc[WGRAD ? NK + 1 : 1];
  float bias[3] = {0.f, 0.f, 0.f};
  if constexpr (WGRAD) {
#pragma unroll
    for (int k = 0; k <= NK; ++k) acc[k] = 0.f;
  } else {
    const int g = (live ? ch : 0) / p.group;
#pragma unroll
    for (int i = 0; i < KH; ++i)
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        const int si = MODE == 1 ? KH - 1 - i : i;
        const int sj = MODE == 1 ? KW - 1 - j : j;
        float v = live ? p.w0[(g * KH + si) * KW + sj] : 0.f;
        if (MODE == 1 && live) {
          v += crop_tap(p.w1, p.k1, KH, KW, g, si, sj);
          v += crop_tap(p.w2, p.k2, KH, KW, g, si, sj);
          if (p.delta && si == PH && sj == KW / 2) v += 1.f;
        }
        w[i * KW + j] = v;
      }
#pragma unroll
    for (int k = 0; k < K1 * K1; ++k)
      w1[k] = live ? p.w1[g * K1 * K1 + k] : 0.f;
#pragma unroll
    for (int k = 0; k < K2 * K2; ++k)
      w2[k] = live ? p.w2[g * K2 * K2 + k] : 0.f;
    if (MODE == 0 && live) {
      if (p.b0) bias[0] = p.b0[ch];
      if (p.b1) bias[1] = p.b1[ch];
      if (p.b2) bias[2] = p.b2[ch];
    }
  }

  // the ring: slot (s + i) % KH holds input row r + shift + i - PH at step
  // s; nxt[s] holds the row it takes at step s, fetched a whole ring (KH
  // steps) ahead, so that KH x WW loads (and KH x CW of dy) are in flight
  float win[KH][WW], nxt[KH][WW];
  float gnx[WGRAD ? KH : 1][CW];
#pragma unroll
  for (int k = 0; k < KH - 1; ++k)
    load(win[k], r0 + p.row_shift - PH + k, true);
#pragma unroll
  for (int s = 0; s < KH; ++s) {
    const bool ahead = r0 + s < r1;
    load(nxt[s], r0 + s + p.row_shift + PH, ahead);
    if constexpr (WGRAD) {
      const float* dyr = p.dy + (r0 + s) * p.out_rs;
#pragma unroll
      for (int q = 0; q < CW; ++q)
        gnx[s][q] = ahead && ook[q] ? __ldg(dyr + oofs[q]) : 0.f;
    }
  }

  for (int rb = r0; rb < r1; rb += KH) {
#pragma unroll
    for (int s = 0; s < KH; ++s) {
      const int r = rb + s;
#pragma unroll
      for (int q = 0; q < WW; ++q) win[(s + KH - 1) % KH][q] = nxt[s][q];
      const bool ahead = r + KH < r1;
      load(nxt[s], r + KH + p.row_shift + PH, ahead);
      if constexpr (WGRAD) {
        float g[CW];
        const float* dyr = p.dy + (r + KH) * p.out_rs;
#pragma unroll
        for (int q = 0; q < CW; ++q) {
          g[q] = gnx[s][q];
          gnx[s][q] = ahead && ook[q] ? __ldg(dyr + oofs[q]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < KH; ++i)
#pragma unroll
          for (int j = 0; j < KW; ++j)
#pragma unroll
            for (int q = 0; q < CW; ++q)
              acc[i * KW + j] =
                  fmaf(g[q], win[(s + i) % KH][q + j], acc[i * KW + j]);
#pragma unroll
        for (int q = 0; q < CW; ++q) acc[NK] += g[q];
      } else {
        float* outr = p.out + r * p.out_rs;
#pragma unroll
        for (int q = 0; q < CW; ++q) {
          // one FFMA chain in ATen's tap order: the forward's from the
          // bias over (kh, kw); the input gradient's over kh = KH - 1 - i
          // ascending, i.e. the flipped taps backwards
          float y = bias[0];
#pragma unroll
          for (int ii = 0; ii < KH; ++ii)
#pragma unroll
            for (int jj = 0; jj < KW; ++jj) {
              const int i = MODE == 1 ? KH - 1 - ii : ii;
              const int j = MODE == 1 ? KW - 1 - jj : jj;
              y = fmaf(w[i * KW + j], win[(s + i) % KH][q + j], y);
            }
          if constexpr (K1 > 0) {
            if (p.delta) y += win[(s + PH) % KH][q + KW / 2];
            float y1 = bias[1], y2 = bias[2];
#pragma unroll
            for (int a = 0; a < K1; ++a)
#pragma unroll
              for (int b = 0; b < K1; ++b)
                y1 = fmaf(w1[a * K1 + b],
                          win[(s + a + (KH - K1) / 2) % KH][q + b + (KW - K1) / 2],
                          y1);
#pragma unroll
            for (int a = 0; a < K2; ++a)
#pragma unroll
              for (int b = 0; b < K2; ++b)
                y2 = fmaf(w2[a * K2 + b],
                          win[(s + a + (KH - K2) / 2) % KH][q + b + (KW - K2) / 2],
                          y2);
            y = (y + y1) + y2;
          }
          if (ook[q] && r < r1) outr[oofs[q]] = y;
        }
      }
    }
  }

  if constexpr (WGRAD) {
    // the CTA's sums over its columns, in a fixed order; the shared array
    // is [thread][stride], stride odd, so that neither the writes nor the
    // reads conflict
    extern __shared__ float sh[];
    const int nt = NK + p.has_bias;
    const int stride = nt | 1;
#pragma unroll
    for (int k = 0; k <= NK; ++k)
      if (k < nt) sh[t * stride + k] = acc[k];
    __syncthreads();
    const long long part0 =
        ((long long)blockIdx.z * gridDim.y + blockIdx.y) * p.channels
        + (long long)blockIdx.x * p.cb;
    for (int o = t; o < p.cb * nt; o += blockDim.x) {
      const int c = o / nt, k = o % nt;
      float s = 0.f;
      for (int b = 0; b < p.bc; ++b) s += sh[(b * p.cb + c) * stride + k];
      p.part[(part0 + c) * nt + k] = s;
    }
  }
}

// The residual conv's weight gradient in ATen's order: warp (head h, taps
// k0..k0 + TPT - 1), lane l: for each tap one chain over the dy rows r of
// fma(v[r + shift + k - PH][c], dy[r][c]) for the head's channels c = l,
// l + 32 (zero outside v), then the warp's shuffle-down tree (offsets 16,
// 8, 4, 2, 1); lane 0 writes dw[h, k]. 64 channels a head. A row's 64 v
// and 64 dy values reach shared memory by one 16-byte cp.async a lane, S - 1
// blocks of U rows ahead of their use (v and dy 16-byte aligned, pitches
// multiples of 4 floats).
template <int KH, int TPT>
__global__ void __launch_bounds__(32)
dw_wgrad_rows_kernel(const float* __restrict__ v, int v_rows, int v_rs,
                     const float* __restrict__ dy, int dy_rows, int dy_rs,
                     int heads, int row_shift, float* dw) {
  constexpr int PH = KH / 2, U = 16, S = 4;
  __shared__ __align__(16) float buf[S][U][128];  // a row: v's 64, dy's 64
  const int lane = threadIdx.x;
  const int h = blockIdx.x / (KH / TPT), k0 = blockIdx.x % (KH / TPT) * TPT;
  const bool live = h < heads;
  const int c0 = (live ? h : 0) * 64;
  float acc[TPT], vw[TPT][2];
#pragma unroll
  for (int u = 0; u < TPT; ++u) {
    acc[u] = 0.f;
    // vw[u] holds v row r + shift + k0 + u - PH while dy row r is summed;
    // before row 0 the window is one row back
    const int row = row_shift + k0 + u - 1 - PH;
    const bool ok = live && u > 0 && (unsigned)row < (unsigned)v_rows;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      vw[u][c] = ok ? v[row * v_rs + c0 + lane + 32 * c] : 0.f;
  }
  // lanes 0-15 copy v's row (16 bytes each), lanes 16-31 dy's; a row
  // outside either is zero-filled
  const bool is_v = lane < 16;
  const float* src = is_v ? v + c0 + 4 * lane : dy + c0 + 4 * (lane - 16);
  const int pitch = is_v ? v_rs : dy_rs;
  auto fetch = [&](int st, int rb) {
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int r = rb + s, row = is_v ? r + row_shift + k0 + TPT - 1 - PH : r;
      const bool ok = live && r < dy_rows
          && (!is_v || (unsigned)row < (unsigned)v_rows);
      __pipeline_memcpy_async(&buf[st][s][4 * lane], src + (ok ? row : 0) * pitch,
                              16, ok ? 0 : 16);
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int st = 0; st < S - 1; ++st) fetch(st, st * U);
  for (int rb = 0, st = 0; rb < dy_rows; rb += U, st = (st + 1) % S) {
    __syncwarp();                               // every lane read the block
    fetch((st + S - 1) % S, rb + (S - 1) * U);  // read last
    __pipeline_wait_prior(S - 1);               // block rb has landed
    __syncwarp();
    // the block's values first, so that no chain waits on shared memory
    float vb[U][2], db[U][2];
#pragma unroll
    for (int s = 0; s < U; ++s)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        vb[s][c] = buf[st][s][lane + 32 * c];
        db[s][c] = buf[st][s][64 + lane + 32 * c];
      }
#pragma unroll
    for (int s = 0; s < U; ++s) {
#pragma unroll
      for (int u = 0; u < TPT; ++u)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          vw[u][c] = u + 1 < TPT ? vw[u + 1][c] : vb[s][c];
      // rows past dy's end read zeros, and fma(x, 0, acc) is acc
#pragma unroll
      for (int u = 0; u < TPT; ++u)
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[u] = fmaf(vw[u][c], db[s][c], acc[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < TPT; ++u)
    for (int off = 16; off > 0; off >>= 1)
      acc[u] += __shfl_down_sync(0xffffffffu, acc[u], off);
  if (live && lane == 0)
#pragma unroll
    for (int u = 0; u < TPT; ++u) dw[h * KH + k0 + u] = acc[u];
}

// The PPEG's leaves from the partials [parts][C][nt]: output o = (channel
// c, tap k) sums its parts in a fixed order, `lanes` consecutive threads
// taking every lanes-th part and then a fixed shuffle tree.
__global__ void __launch_bounds__(kThreads)
dw_reduce_kernel(const float* __restrict__ part, int parts, int channels,
                 int kh, int kw, int has_bias, int lanes, float* dw0,
                 float* dw1, int k1, float* dw2, int k2, float* db0,
                 float* db1, float* db2) {
  const int nk = kh * kw, nt = nk + has_bias;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long o = tid / lanes;
  const int lane = (int)(tid % lanes);
  const bool live = o < (long long)channels * nt;
  const int g = live ? (int)(o / nt) : 0, k = live ? (int)(o % nt) : 0;
  float s = 0.f;
  if (live)
    for (int j = lane; j < parts; j += lanes)
      s += part[((long long)j * channels + g) * nt + k];
  for (int m = 1; m < lanes; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (!live || lane != 0) return;
  if (k == nk) {
    db0[g] = s;
    if (db1) db1[g] = s;
    if (db2) db2[g] = s;
    return;
  }
  dw0[(long long)g * nk + k] = s;
  const int i = k / kw, jj = k % kw;
  float* crops[2] = {dw1, dw2};
  const int ks[2] = {k1, k2};
  for (int c = 0; c < 2; ++c) {
    const int a = i - (kh - ks[c]) / 2, b = jj - (kw - ks[c]) / 2;
    if (crops[c] && a >= 0 && a < ks[c] && b >= 0 && b < ks[c])
      crops[c][((long long)g * ks[c] + a) * ks[c] + b] = s;
  }
}

template <int KH, int KW, int CW, int MODE>
int launch_band(const BandArgs& a, dim3 grid, cudaStream_t st) {
  const size_t smem =
      MODE == 2 ? sizeof(float) * kThreads * ((KH * KW + a.has_bias) | 1) : 0;
  dw_band_kernel<KH, KW, CW, MODE><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: forward (out = conv(in) + bias), 1: input gradient (out =
// conv(in = dy) with the taps flipped), 2: weight gradient (partials of
// dy x in, one weight a channel). The grid is [in_rows, cols, channels] with
// channel stride 1 and the given row and column pitches (in floats); the
// taps (kh, kw) are (33, 1), each thread on one column (cw 1; no weight
// gradient: tpumil_depthwise_rows_wgrad) and no crops, or (7, 7) with
// crops w1 of 5 and w2 of 3, on cw = 2 columns (4 for the input
// gradient). Returns the launch's CUDA error; launches on `stream` and does
// not synchronize.
extern "C" int tpumil_depthwise_band(
    int mode, int kh, int kw, int cw, const void* in, int in_rows, int in_rs,
    int in_cs, const void* dy, void* out, int out_rows, int out_rs, int out_cs,
    int cols, int channels, int group, int row_shift, const void* w0,
    const void* w1, int k1, const void* w2, int k2, int delta, const void* b0,
    const void* b1, const void* b2, const void* lead_src, void* lead_dst,
    int lead_n, int band, int cb, int bc, void* part, int has_bias,
    void* stream) {
  if (mode < 0 || mode > 2 || band < 1 || cb < 1 || bc < 1
      || cb * bc > kThreads || channels % cb != 0 || out_rows < 1 || cols < 1
      || (mode == 2 && group != 1))
    return (int)cudaErrorInvalidValue;
  BandArgs a;
  a.in = static_cast<const float*>(in);
  a.in_rs = in_rs; a.in_cs = in_cs; a.in_rows = in_rows;
  a.dy = static_cast<const float*>(dy);
  a.out = static_cast<float*>(out);
  a.out_rs = out_rs; a.out_cs = out_cs; a.out_rows = out_rows;
  a.cols = cols; a.channels = channels; a.group = group;
  a.row_shift = row_shift;
  a.w0 = static_cast<const float*>(w0);
  a.w1 = static_cast<const float*>(w1); a.k1 = k1;
  a.w2 = static_cast<const float*>(w2); a.k2 = k2;
  a.delta = delta;
  a.b0 = static_cast<const float*>(b0);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.lead_src = static_cast<const float*>(lead_src);
  a.lead_dst = static_cast<float*>(lead_dst); a.lead_n = lead_n;
  a.band = band; a.cb = cb; a.bc = bc;
  a.part = static_cast<float*>(part); a.has_bias = has_bias;
  const dim3 grid(channels / cb, (cols + bc * cw - 1) / (bc * cw),
                  (out_rows + band - 1) / band);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kh == 33 && kw == 1 && cw == 1 && w1 == nullptr && w2 == nullptr
      && k1 == 0 && k2 == 0) {
    if (mode == 0) return launch_band<33, 1, 1, 0>(a, grid, st);
    if (mode == 1) return launch_band<33, 1, 1, 1>(a, grid, st);
  }
  if (kh == 7 && kw == 7 && w1 != nullptr && k1 == 5 && w2 != nullptr
      && k2 == 3) {
    if (mode == 0 && cw == 2) return launch_band<7, 7, 2, 0>(a, grid, st);
    if (mode == 1 && cw == 4) return launch_band<7, 7, 4, 1>(a, grid, st);
    if (mode == 2 && cw == 2) return launch_band<7, 7, 2, 2>(a, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The residual conv's weight gradient dw [heads, kh] (kh = 33) from v
// [v_rows, heads x 64] (row pitch v_rs floats) and dy [dy_rows, heads x 64]
// (row pitch dy_rs), dy's row r against v's row r + row_shift + k - kh / 2
// at tap k, in ATen's order (dw_wgrad_rows_kernel).
extern "C" int tpumil_depthwise_rows_wgrad(
    const void* v, int v_rows, int v_rs, const void* dy, int dy_rows, int dy_rs,
    int heads, int kh, int row_shift, void* dw, void* stream) {
  if (kh != 33 || heads < 1 || dy_rows < 1 || v_rows < 1)
    return (int)cudaErrorInvalidValue;
  dw_wgrad_rows_kernel<33, 3><<<heads * 11, 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), v_rows, v_rs, static_cast<const float*>(dy),
      dy_rows, dy_rs, heads, row_shift, static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

// The PPEG's weight gradient's second kernel: partials [parts][channels][kh
// kw + has_bias] to dw0 [channels, kh, kw], its centred crops dw1
// [channels, k1, k1] and dw2 [channels, k2, k2] (each optional), and the
// bias gradient db0 (and its copies db1, db2). `lanes` (1..32, a power of
// two) threads sum each output.
extern "C" int tpumil_depthwise_reduce(
    const void* part, int parts, int channels, int kh, int kw, int has_bias,
    int lanes, void* dw0, void* dw1, int k1, void* dw2, int k2, void* db0,
    void* db1, void* db2, void* stream) {
  if (parts < 1 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1))
      || (has_bias && db0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long threads =
      (long long)channels * (kh * kw + has_bias) * lanes;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  dw_reduce_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), parts, channels, kh, kw, has_bias, lanes,
      static_cast<float*>(dw0), static_cast<float*>(dw1), k1,
      static_cast<float*>(dw2), k2, static_cast<float*>(db0),
      static_cast<float*>(db1), static_cast<float*>(db2));
  return (int)cudaGetLastError();
}
