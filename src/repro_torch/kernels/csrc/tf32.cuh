// 3xTF32 operand split shared by the kernels that run f32 products on the
// tensor cores (autocorr.cu, ssm_scan.cu).
#pragma once
#include <stdint.h>

// x to TF32, rounded to nearest with ties away from zero (cvt.rna's rule)
// by integer operations on the bits
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: hi = rna(x), lo = rna(x - hi) (x - hi is exact),
// so the split keeps ~2^-23 of x
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(x));
  lo = tf32_rna(__float_as_uint(x - __uint_as_float(hi)));
}
