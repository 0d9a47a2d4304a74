// f32-level products on the tensor cores (3xTF32 on mma.sync), shared by the
// attention-pool kernels (attention_pool.cu) and the ResNet stem (stem.cu).
// Include it at file scope: its functions live in an anonymous namespace,
// internal to each translation unit that includes it.

#pragma once

#include <stdint.h>

namespace {

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

}  // namespace
