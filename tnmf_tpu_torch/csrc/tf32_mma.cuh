// Device helpers shared by the tensor-core kernels (K2 grad_w.cu, K3 mu_h.cu):
// cp.async copies into shared memory, the TF32 rounding and 3xTF32 operand
// split, and the mma.sync m16n8k8 TF32 product.
//
// 3xTF32 (kPasses = 3, the full-float32 precision levels): x is split into
// big = tf32_rna(x) and small = tf32_rna(x - big), so x = big + small + e with
// |e| <= 2^-22 |x|; a product a*b is accumulated as small*big + big*small +
// big*big, within about 3 * 2^-22 of exact.
//
// One pass (kPasses = 1, the TF32 levels 'default' and 'high'): each operand
// is rounded once, big = tf32_rna(x) (within 2^-11 |x|), and a product is
// big*big alone: a third of the tensor-core products and no small halves to
// stage or load.  The product of two TF32 values is exact in float32, so the
// result equals a float32 sum over the rounded operands.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy kVec floats to shared memory, or zeros when !valid
template <int kVec>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const int n = valid ? 4 * kVec : 0;
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::); }

// x rounded to TF32 (round to nearest, ties away from zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t big;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  return big;
}

// x = big + small, both TF32 values (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
