// The softmax forward's division y = e / sum, rounded once: the bits of
// `__fdiv_rn(e, sum)` in three operations where `__fdiv_rn` takes eight
// (its reciprocal again for every element) and, for e = 0, which every
// masked key and every causal zero gives, a call to its slow path.
//
// With r = __frcp_rn(sum), the correctly rounded reciprocal, q0 = e * r is
// within an ulp of e / sum, an FMA gives the residual e - q0 * sum exactly,
// and q0 + residual * r then rounds to e / sum (Markstein's theorem) where
// the residual is a normal number: for a row of the row path, sum in [1,
// 1024] (the row's max scores exp(0) = 1 and no score more), that holds for
// every e in [2^-100, 1]; e = 0 gives +0, as the division does, and NaN
// gives NaN. An e in (0, 2^-100) takes `__fdiv_rn` itself (`div_tiny`).
// tests/test_torch_kernels_cuda.py checks `div_row` against `__fdiv_rn`
// on the card for every fp32 e in [2^-100, 1] at a set of sums.

#pragma once

#include <stdint.h>

namespace softmax_div {

constexpr uint32_t kTinyBits = 0x0d800000u;  // 2^-100

// e in (0, 2^-100): the residual may be subnormal, so the three operations
// need not round as the division does
__device__ __forceinline__ bool div_tiny(float e) {
  return __float_as_uint(e) - 1u < kTinyBits - 1u;
}

// e / sum by __fdiv_rn, out of line: its slow path's registers stay out of
// the kernels that call it (only for div_tiny e, which no model path gives)
static __device__ __noinline__ float div_slow(float e, float sum) {
  return __fdiv_rn(e, sum);
}

// e / sum rounded once, for r = __frcp_rn(sum) and e not div_tiny
__device__ __forceinline__ float div_row(float e, float sum, float r) {
  const float q0 = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q0, sum, e), r, q0);
}

}  // namespace softmax_div
