// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the bf16 tensor-core product on `mma.sync` m16n8k16 fragments, bf16
// packing, the reference's mask (apex_tpu/ops/attention.py
// `_mask_block`, :59-86) and its dropout keep mask (`_dropout_keep`,
// :89-112).
//
// Fragment layout of m16n8k16 (per warp; g = lane / 4, t = lane % 4):
// A (16 x 16, row-major) a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] =
// (g, 2t+8..), a[3] = (g+8, 2t+8..); B (16 x 8, "col") b0 = rows 2t..2t+1
// of column g, b1 = rows 2t+8..2t+9; C (16 x 8) c[0..1] = (g, 2t..2t+1),
// c[2..3] = (g+8, 2t..2t+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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

// The reference's additive mask for one score. `row` and `col` are what
// the causal and window tests compare: the query and key indices with
// off = sk - sq, or, given global positions (ring and blockwise chunks,
// `_mask_block` :68-73), the two positions with off = 0. A key past the
// end of the sequence (`key_ok` false) is excluded outright: it does not
// exist in the reference.
__device__ __forceinline__ float mask_score(float s, int row, int col, int off,
                                            bool key_ok, int causal, int window,
                                            bool has_seg, int qs, int ks) {
  if (!key_ok) return -INFINITY;
  bool masked = false;
  if (causal && col > row + off) masked = true;
  if (window > 0 && col <= row + off - window) masked = true;
  if (has_seg && qs != ks) masked = true;
  return masked ? s + kNegInf : s;
}

// The additive bias (`bias_ref`, :224-225): element (b, h, q, k) sits at
// b * sb + h * sh + q * sq + k * sk, with stride 0 on each dimension the
// bias broadcasts (size 1; `_bias_index_map` :40-47 and the size-1
// blocks of :303-314). fp32 or bf16, read as fp32 as `bias_ref[0].astype(
// jnp.float32)` does. A null pointer means no bias.
struct Bias {
  const void* p;
  int bf16;
  long long sb, sh, sq, sk;
};

__device__ __forceinline__ float bias_at(const Bias& bs, long long base,
                                         int qi, int kj) {
  const long long i = base + qi * bs.sq + kj * bs.sk;
  return bs.bf16 ? __bfloat162float(
                       static_cast<const __nv_bfloat16*>(bs.p)[i])
                 : static_cast<const float*>(bs.p)[i];
}

// Positions of tile entries i0 .. i0 + 63 (0 past n) into shared `dst`.
__device__ __forceinline__ void load_pos(int* dst, const int* pos, int i0,
                                         int n, int tid, int nthreads) {
  for (int i = tid; i < 64; i += nthreads)
    dst[i] = i0 + i < n ? pos[i0 + i] : 0;
}

// The least and largest of the first `n` (1..64) positions of a tile in
// shared memory; every lane of the calling warp gets both. Zig-zag shards
// are not contiguous, so the bounds come from the positions themselves,
// never from the tile's index.
__device__ __forceinline__ void tile_bounds(const int* p, int n, int lane,
                                            int* lo, int* hi) {
  const bool a = lane < n, b = lane + 32 < n;
  const int mn = min(a ? p[lane] : INT_MAX, b ? p[lane + 32] : INT_MAX);
  const int mx = max(a ? p[lane] : INT_MIN, b ? p[lane + 32] : INT_MIN);
  *lo = __reduce_min_sync(0xffffffffu, mn);
  *hi = __reduce_max_sync(0xffffffffu, mx);
}

// `_block_live_dynamic` (:126-137): whether a (query tile, key tile) pair
// with these position bounds can hold an unmasked score. Positions come
// only with causal masking.
__device__ __forceinline__ bool tile_live(int q_lo, int q_hi, int k_lo,
                                          int k_hi, int window) {
  bool run = q_hi >= k_lo;
  if (window > 0) run = run && k_hi > q_lo - window;
  return run;
}

// The reference's counter-based attention-dropout mask: the murmur3
// finaliser of (seed, flat q-head index b * H + h, global query row,
// global key column), kept where the hash is >= thresh = min(int(rate *
// 2^32), 2^32 - 1) (computed on the host). It hashes global indices, not
// block indices, so any tile shape gives the same mask; the forward and
// both backward kernels regenerate it from the same seed.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh,
                                             uint32_t row, uint32_t col,
                                             uint32_t thresh) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  x ^= bh * 0xC2B2AE3Du;
  x ^= seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thresh;
}

// The dropout arguments of the three kernels: `on` is rate > 0; a kept
// value is divided by `keep` (fp32 1 - rate), as the reference's
// `p / (1.0 - rate)`.
struct Dropout {
  int on;
  uint32_t seed;
  uint32_t thresh;
  float keep;
};

// v dropped at (bh, row, col): kept and divided by 1 - rate, or 0.
__device__ __forceinline__ float dropped(const Dropout& dr, uint32_t bh,
                                         int row, int col, float v) {
  return dropout_keep(dr.seed, bh, (uint32_t)row, (uint32_t)col, dr.thresh)
             ? __fdiv_rn(v, dr.keep)
             : 0.f;
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
