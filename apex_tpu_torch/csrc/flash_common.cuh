// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the bf16 tensor-core product on `mma.sync` m16n8k16 fragments, bf16
// packing, and the reference's mask (apex_tpu/ops/attention.py
// `_mask_block`, :59-86).
//
// Fragment layout of m16n8k16 (per warp; g = lane / 4, t = lane % 4):
// A (16 x 16, row-major) a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] =
// (g, 2t+8..), a[3] = (g+8, 2t+8..); B (16 x 8, "col") b0 = rows 2t..2t+1
// of column g, b1 = rows 2t+8..2t+9; C (16 x 8) c[0..1] = (g, 2t..2t+1),
// c[2..3] = (g+8, 2t..2t+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kPad = 8;            // bf16 padding per shared-memory row

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_raw(const __nv_bfloat16* lo,
                                             const __nv_bfloat16* hi) {
  return (uint32_t)__bfloat16_as_ushort(*lo) |
         ((uint32_t)__bfloat16_as_ushort(*hi) << 16);
}

// The reference's additive mask for one score; keys past the end of the
// sequence are excluded outright (they do not exist in the reference).
__device__ __forceinline__ float mask_score(float s, int qi, int kj, int off,
                                            int sk, int causal, int window,
                                            bool has_seg, int qs, int ks) {
  if (kj >= sk) return -INFINITY;
  bool masked = false;
  if (causal && kj > qi + off) masked = true;
  if (window > 0 && kj <= qi + off - window) masked = true;
  if (has_seg && qs != ks) masked = true;
  return masked ? s + kNegInf : s;
}

// A fragment of rows r0, r0 + 8 (r0 = 16-row slab + g) of a row-major
// shared tile with row stride `ld`, k16 step `kk`.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* s,
                                       int r0, int ld, int kk, int t) {
  const __nv_bfloat16* p = s + r0 * ld + kk * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// C += A . B^T where B's 8 columns are rows n0..n0+7 of a row-major
// shared tile (the operand of Q K^T: B's column index is the tile's row).
__device__ __forceinline__ void mma_abt(float* c, const uint32_t* a,
                                        const __nv_bfloat16* s, int n0,
                                        int ld, int kk, int g, int t) {
  const __nv_bfloat16* p = s + (n0 + g) * ld + kk * 16 + 2 * t;
  mma_bf16_16816(c, a, ld32(p), ld32(p + 8));
}

// C += A . B where B is the 16 x 8 block at rows 16 kk.., columns n0.. of
// a row-major shared tile (the operand of P V).
__device__ __forceinline__ void mma_ab(float* c, const uint32_t* a,
                                       const __nv_bfloat16* s, int n0, int ld,
                                       int kk, int g, int t) {
  const __nv_bfloat16* p = s + (kk * 16 + 2 * t) * ld + n0 + g;
  mma_bf16_16816(c, a, pack_raw(p, p + ld), pack_raw(p + 8 * ld, p + 9 * ld));
}

// The A fragment of k16 step `kk` built from fp32 accumulators of two
// adjacent n8 tiles (rounded to bf16): scores become the left operand of
// the next product without leaving registers.
__device__ __forceinline__ void acc_to_a(uint32_t* a, float (*c)[4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Copy `rows` rows of D bf16 (row stride D in global memory) starting at
// row r0 into a shared tile of `tile_rows` rows with stride LD, 16 bytes
// a lane; rows past `rows` are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int tile_rows, int tid,
                                          int nthreads) {
  constexpr int LD = D + kPad, CH = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < tile_rows * CH; i += nthreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

}  // namespace
