// The LAMB stage-1 update term, shared by csrc/fused_lamb.cu (the
// two-stage path) and csrc/lamb_segment.cu (the one-pass segment pass).
//
// The math of apex_tpu/multi_tensor/ops.py `fused_lamb_compute_update_term`
// (:300-309) and apex_tpu/multi_tensor/segmented.py `_stage1_math` (:57),
// every operation rounded on its own in the plain PyTorch version's order
// (`__f*_rn`: nvcc cannot contract them into FMAs), so u, m' and v' are
// bitwise those of the plain version:
//   g'   = g / inv_scale          (a division, as the reference's; the
//                                  Adam functor multiplies instead)
//   g_eff = adam_w ? g' : g' + wd * p
//   m'   = b1 * m + beta3 * g_eff
//   v'   = b2 * v + (1 - b2) * g_eff * g_eff
//   u    = (m' / bc1) / (sqrt(v' / bc2) + eps)  [+ wd * p when adam_w]

#pragma once

#include <cuda_runtime.h>

struct LambScalars {
  float b1, b2, beta3, eps, wd, bc1, bc2, lr;
  int adam_w;
};

__device__ __forceinline__ float lamb_stage1_one(float p, float& m, float& v,
                                                 float g, float inv_scale,
                                                 const LambScalars& s) {
  const float gs = __fdiv_rn(g, inv_scale);
  const float g_eff = s.adam_w ? gs : __fadd_rn(gs, __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.beta3, g_eff));
  v = __fadd_rn(__fmul_rn(s.b2, v),
                __fmul_rn(__fmul_rn(__fsub_rn(1.0f, s.b2), g_eff), g_eff));
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  return __fadd_rn(u, s.adam_w ? __fmul_rn(s.wd, p) : 0.0f);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// elements per per-tensor subtile (16 rows x 128 lanes, the flat space's
// alignment) and the float4s a warp's lane takes from one subtile
constexpr int kSubtile = 2048;
constexpr int kSubtileVecsPerLane = kSubtile / 4 / 32;
