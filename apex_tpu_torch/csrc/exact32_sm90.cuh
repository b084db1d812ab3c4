// Exact fp32 products on Hopper's bf16 `wgmma` (sm_90a), shared by the fp32
// flash forward (flash_fwd32_sm90.cuh) and backward (flash_bwd32_sm90.cuh).
//
// Parts. The split pass (flash_split3.cu) writes each fp32 tensor as three
// bf16 planes, x = hi + mid + lo (`split3`, flash_common.cuh), rows
// zero-padded to the TMA width (a multiple of 8, at least 32): (3,
// batch*heads, rows, W) bf16, so part j of head bh is head j * batch*heads
// + bh of one tensor map, and TMA copies part tiles straight into the
// swizzled layout `wgmma` reads (sm90_common.cuh). Every part tile here has
// 64 rows (`kRows32`) or, for a resident tile, 64 per warpgroup.
//
// Exact products. A product is six bf16 `wgmma`s, the part pairs (i, j)
// with i + j <= 2 (the dropped mid*lo, lo*mid, lo*lo are below 2^-24
// relative), smallest first: index sum 2, then 1, then 0. A score product
// (depth D <= 128) is one chain: the six pair classes over every k16 step,
// smallest first, so the small parts sum among themselves and only the KS
// hi*hi steps add to a partial of the score's size. A product whose A is
// an fp32 accumulator (P, dS) splits it in registers into three A operands
// (`split_a`, `split3` over `acc_to_a`'s layout) and reads B MN-major (the
// transpose bit) from the part tiles.
//
// Summing. The tensor cores' fp32 accumulation does not round to nearest
// (it drifted 1e-5 over 1024 keys on the H100), so no long sum runs inside
// them: a running sum over keys or queries is joined once per k16 step
// (`rs_update`): that step's six part products go into a spare accumulator
// started at 0, the group is waited for, and one __fadd_rn per element adds
// it to the running sum.

#pragma once

#include "sm90_common.cuh"

namespace {

constexpr int kRows32 = 64;   // rows of every streamed part tile

__host__ __device__ constexpr int align16(int x) { return (x + 15) / 16 * 16; }

// the part pairs (A part, B part) of an exact product, smallest first:
// index sums 2, then 1, then 0 (part 0 is the leading one)
__host__ __device__ constexpr int pair_a(int p) {
  return p < 3 ? p : p < 5 ? p - 3 : 0;
}
__host__ __device__ constexpr int pair_b(int p) {
  return p < 3 ? 2 - p : p < 5 ? 4 - p : 0;
}

// c (m64n64, fp32) = A B^T exactly over KS k16 steps, in one group: A rows
// a_r0 .. a_r0 + 63 of an a_rows-row part tile (parts a_part bytes apart),
// B a 64-row part tile (parts b_part apart), both K-major; the six pair
// classes in turn, smallest first, each over every k16 step
template <int KS>
__device__ __forceinline__ void ss_exact(float (*c)[4],
                                         const unsigned char* a, int a_rows,
                                         int a_r0, int a_part,
                                         const unsigned char* b,
                                         int b_part) {
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_bf16_n64(
          c, desc_k_rows(a + pair_a(p) * a_part, a_rows, a_r0, kk),
          desc_k<kRows32>(b + pair_b(p) * b_part, 0, kk), (p | kk) != 0);
}

template <int N>
__device__ __forceinline__ void rs_bf16(float (*d)[4], const uint32_t* a,
                                        uint64_t b, int acc) {
  if constexpr (N == 32) wgmma_rs_bf16_n32(d, a, b, acc);
  if constexpr (N == 64) wgmma_rs_bf16_n64(d, a, b, acc);
  if constexpr (N == 96) wgmma_rs_bf16_n96(d, a, b, acc);
  if constexpr (N == 128) wgmma_rs_bf16_n128(d, a, b, acc);
}

// the three bf16 parts of k16 step kk of fp32 accumulators (two adjacent
// n8 tiles), as register A operands: a[part][4] in `acc_to_a`'s layout
__device__ __forceinline__ void split_a(uint32_t (*a)[4], float (*c)[4],
                                        int kk) {
  uint32_t d[3];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* src = c[2 * kk + (r >> 1)] + 2 * (r & 1);
    split_pair(d, src[0], src[1]);
#pragma unroll
    for (int j = 0; j < 3; ++j) a[j][r] = d[j];
  }
}

// keeps the A registers of an asynchronous wgmma from being reused before
// its group has completed
__device__ __forceinline__ void fence_a(uint32_t (*a)[4]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[j][r])::"memory");
}

// run (m64nD) += src B exactly: src the fp32 accumulators of a 64-wide
// score tile, B a 64-row part tile (MN-major, parts 64 D 2 bytes apart).
// Each k16 step's six part products (smallest first) go into `tmp`
// (started at 0), whose group is waited for and added to `run` with one
// rounded add an element.
template <int D>
__device__ __forceinline__ void rs_update(float (*run)[4], float (*src)[4],
                                          const unsigned char* b) {
  constexpr int PB = kRows32 * D * 2;
  float tmp[D / 8][4];
#pragma unroll
  for (int k0 = 0; k0 < kRows32 / 16; ++k0) {
    uint32_t a[3][4];
    split_a(a, src, k0);
    wg_fence();
#pragma unroll
    for (int p = 0; p < 6; ++p)
      rs_bf16<D>(tmp, a[pair_a(p)],
                 desc_mn<kRows32>(b + pair_b(p) * PB, k0, 0), p != 0);
    wg_commit();
    wg_wait0();
    fence_acc<D / 8>(tmp);
    fence_a(a);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) run[j][i] = __fadd_rn(run[j][i], tmp[j][i]);
  }
}

// the three part tiles of rows row0 .. row0 + R - 1 of head `bh` (planes
// of `heads` heads each) into `dst`
template <int D, int R = kRows32>
__device__ __forceinline__ void tma_parts(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row0, int bh,
                                          int heads) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    tma_tile<D, R>(dst + j * R * D * 2, map, bar, row0, j * heads + bh);
}

// The TMA width of the split pass's planes for a head_dim of dh: a multiple
// of 8 (16-byte rows), at least one 32-column chunk.
__host__ __device__ constexpr int plane_width(int dh) {
  return (dh + 7) / 8 * 8 < kChunk ? kChunk : (dh + 7) / 8 * 8;
}

}  // namespace
