// Float32 products on Hopper's tensor cores by a three-product TF32 split
// ("3xTF32").  The split (split_tf32) serves the float32 bodies of the
// attention forward (attention_fwd.cu) and of the fused MLP's GEMM core
// (wgmma_gemm.cuh); both run the three products of a k-step as wgmmas but
// for the attention forward's body for heads wider than 80, whose
// mma.sync warp-level form (mma_tf32, mma_tf32x3) stays here.
//
// A float32 x splits into hi = x rounded to TF32 (as cvt.rna: 10 mantissa
// bits, round to nearest, ties away from zero) and lo = x - hi, which is
// exact in float32; lo is rounded to TF32 in turn.  Then
//   a . b ~ a_lo . b_hi + a_hi . b_lo + a_hi . b_hi
// with each TF32 product exact in the tensor core; the dropped a_lo . b_lo
// and the rounding of the lo parts are ~2^-21 of |a . b|.  The three
// products of one k-step of 8 are summed on the tensor core from zero,
// small terms first, and that partial sum is added to the float32
// accumulator with one rounded add.  The tensor core's own accumulation
// truncates: a chain of hundreds of truncating adds drifts beyond float32
// accuracy, and even two k-steps a chain (six products) leave a bias toward
// zero that shows, amplified, in gradients taken through the attention
// (chip_smoke.py phase 8); one k-step a chain keeps the results as close to
// the plain float32 version as a correctly rounded product is.  These are not
// TF32 semantics: torch.backends.cuda.matmul.allow_tf32 governs PyTorch's
// products, not these kernels, which stay float32-class whatever it says.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (CUTLASS
// SM80_16x8x8_F32TF32TF32F32_TN), with g = lane / 4 and t = lane % 4:
//   A (16 x 8):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   C (16 x 8):  c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x -> (hi, lo), TF32 operands with hi + lo = x to ~2^-21 relative.  Each
// is cvt.rna.tf32.f32 of finite x, written out: half a TF32 ulp (0x1000)
// added to the bit pattern rounds to nearest with ties away from zero once
// the low 13 bits are dropped, and the tensor core reads only the top 19
// bits of a TF32 operand, so they need clearing only where the value is
// used as a float (x - hi).  ptxas lowers cvt.rna the same way, behind a
// test for inf and NaN that doubles its cost; these operands are finite.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// d (16 x 8, float32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x 8, float32) += a . b over one k-step of 8, by the three
// products of the split summed from zero and added once, rounded
__device__ __forceinline__ void mma_tf32x3(float (&acc)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

}  // namespace
