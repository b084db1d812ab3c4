// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the element types and their tensor-core products on `mma.sync` m16n8k16
// fragments, the reference's mask (apex_tpu/ops/attention.py `_mask_block`,
// :59-86) and its dropout keep mask (`_dropout_keep`, :89-112).
//
// Fragment layout of m16n8k16 (per warp; g = lane / 4, t = lane % 4):
// A (16 x 16, row-major) a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] =
// (g, 2t+8..), a[3] = (g+8, 2t+8..); B (16 x 8, "col") b0 = rows 2t..2t+1
// of column g, b1 = rows 2t+8..2t+9; C (16 x 8) c[0..1] = (g, 2t..2t+1),
// c[2..3] = (g+8, 2t..2t+1).
//
// Element types (`Elem<T>`): bf16 and fp16 are one register a fragment
// pair, multiplied by the bf16 or fp16 `mma` (same fragment layout). fp32
// has no exact tensor-core product (TF32 keeps 10 mantissa bits), so an
// fp32 value is split into three bf16 parts, x = hi + mid + lo (8 bits
// each: exact but for the last bit of a few values), and a product is the
// six bf16 products whose parts reach 2^-16 of the leading one, added
// smallest first into the fp32 accumulator: hi*lo + mid*mid + lo*hi +
// hi*mid + mid*hi + hi*hi (the dropped mid*lo, lo*mid, lo*lo are below
// 2^-24 relative). Products are exact; each k16 step's six products sum
// in a fresh accumulator that one rounded fp32 add puts into the running
// sum (the tensor core's own fp32 accumulation does not round to nearest,
// and its errors would grow with the running sum), so the kernels hold
// the plain fp32 version to a few 1e-6. The split happens once, where a tile is copied into
// shared memory: an fp32 tile is stored as three bf16 tiles (its parts,
// `kParts` tiles `part_stride` elements apart), so the inner loops read
// fragments as the bf16 kernels do; only the fp32 scores (P, dS) are split
// in registers. A fragment holds kParts registers per pair: a[4 * kParts]
// and b[2 * kParts], register i of part j at [i * kParts + j]. Every tile
// has 64 rows of D + 8 16-bit elements (16 bytes of padding a row).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ void mma_bf16_16816(float* c, uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16_16816(float* c, uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const uint32_t l = __half_as_ushort(__float2half_rn(lo));
  const uint32_t h = __half_as_ushort(__float2half_rn(hi));
  return l | (h << 16);
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two 16-bit elements at unrelated addresses, as one fragment register
template <typename T>
__device__ __forceinline__ uint32_t pack_raw(const T* lo, const T* hi) {
  return (uint32_t)*reinterpret_cast<const unsigned short*>(lo) |
         ((uint32_t)*reinterpret_cast<const unsigned short*>(hi) << 16);
}

// x split into three bf16 parts (hi, mid, lo as fp32 values): x = hi +
// mid + lo, each residual exact in fp32
__device__ __forceinline__ void split3(float x, float* part) {
  const float hi = __bfloat162float(__float2bfloat16_rn(x));
  const float r = __fsub_rn(x, hi);
  const float mid = __bfloat162float(__float2bfloat16_rn(r));
  part[0] = hi;
  part[1] = mid;
  part[2] = __fsub_rn(r, mid);
}

// d[0..2]: the three parts of (x, y), each pair packed as bf16
__device__ __forceinline__ void split_pair(uint32_t* d, float x, float y) {
  float px[3], py[3];
  split3(x, px);
  split3(y, py);
#pragma unroll
  for (int j = 0; j < 3; ++j) d[j] = pack_bf16(px[j], py[j]);
}

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  using T = __nv_bfloat16;
  using S = __nv_bfloat16;          // shared-memory element
  static constexpr int kParts = 1;
  static constexpr int kCode = 1;   // the launchers' dtype code
  static __device__ __forceinline__ T from_f(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ void from_pair(uint32_t* d, float x,
                                                   float y) {
    d[0] = pack_bf16(x, y);
  }
  static __device__ __forceinline__ void st_pair(T* p, float x, float y) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    mma_bf16_16816(c, a[0], a[1], a[2], a[3], b[0], b[1]);
  }
  static __device__ __forceinline__ float ex(float x) { return __expf(x); }
};

template <>
struct Elem<__half> {
  using T = __half;
  using S = __half;
  static constexpr int kParts = 1;
  static constexpr int kCode = 2;
  static __device__ __forceinline__ T from_f(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ void from_pair(uint32_t* d, float x,
                                                   float y) {
    d[0] = pack_f16(x, y);
  }
  static __device__ __forceinline__ void st_pair(T* p, float x, float y) {
    *reinterpret_cast<uint32_t*>(p) = pack_f16(x, y);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    mma_f16_16816(c, a[0], a[1], a[2], a[3], b[0], b[1]);
  }
  static __device__ __forceinline__ float ex(float x) { return __expf(x); }
};

template <>
struct Elem<float> {
  using T = float;
  using S = __nv_bfloat16;          // three bf16 part tiles
  static constexpr int kParts = 3;
  static constexpr int kCode = 0;
  static __device__ __forceinline__ T from_f(float x) { return x; }
  static __device__ __forceinline__ void from_pair(uint32_t* d, float x,
                                                   float y) {
    split_pair(d, x, y);
  }
  static __device__ __forceinline__ void st_pair(T* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
  // the six part products, smallest first: (a part, b part) with a + b <=
  // 2, into a fresh accumulator that is then added to c with one rounded
  // add: the tensor core's fp32 accumulation does not round to nearest,
  // and over a long accumulator (1024 keys of P.V, of dk and dv) its
  // errors grew to 1e-5 of the result on the H100; per k16 step they stay
  // relative to that step's sum
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    part(t, a, b, 0, 2);
    part(t, a, b, 1, 1);
    part(t, a, b, 2, 0);
    part(t, a, b, 0, 1);
    part(t, a, b, 1, 0);
    part(t, a, b, 0, 0);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], t[i]);
  }
  static __device__ __forceinline__ void part(float* c, const uint32_t* a,
                                              const uint32_t* b, int i,
                                              int j) {
    mma_bf16_16816(c, a[i], a[3 + i], a[6 + i], a[9 + i], b[j], b[3 + j]);
  }
  // fp32 scores take the accurate exp (the fast one is ~1e-6 off)
  static __device__ __forceinline__ float ex(float x) { return expf(x); }
};

constexpr int kPad = 8;        // 16-bit elements of padding a shared row
constexpr int kTileRows = 64;  // rows of every shared tile

// Elements between the parts of one tile (its D + kPad row stride times
// its 64 rows), and the 16-bit elements a tile takes in all.
template <typename T, int D>
__host__ __device__ constexpr int part_stride() {
  return kTileRows * (D + kPad);
}
template <typename T, int D>
__host__ __device__ constexpr int tile_elems() {
  return Elem<T>::kParts * part_stride<T, D>();
}

// The built head widths: a head_dim is zero-padded in shared memory to the
// next of these (zero columns add nothing to q.k and their output columns
// are not stored). 0 past the widest. 256 is built for bf16 and fp16 only.
__host__ __device__ constexpr int built_width(int dh) {
  return dh < 1 ? 0 : dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 96 ? 96
         : dh <= 128 ? 128 : dh <= 256 ? 256 : 0;
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
// blocks of :303-314). fp32, bf16 or fp16 (`dtype` 0, 1, 2), read as fp32
// as `bias_ref[0].astype(jnp.float32)` does. A null pointer means no bias.
struct Bias {
  const void* p;
  int dtype;
  long long sb, sh, sq, sk;
};

__device__ __forceinline__ float bias_at(const Bias& bs, long long base,
                                         int qi, int kj) {
  const long long i = base + qi * bs.sq + kj * bs.sk;
  if (bs.dtype == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(bs.p)[i]);
  if (bs.dtype == 2) return __half2float(static_cast<const __half*>(bs.p)[i]);
  return static_cast<const float*>(bs.p)[i];
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

// the max and the sum over the four lanes of a quad (the lanes that hold one
// accumulator row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a kernel's dynamic shared memory past the default 48 KB allowed
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The kParts registers of a fragment pair: p[0], p[1] of each part (part j
// `PS` elements after part 0), or two elements at unrelated addresses.
template <typename T, int PS, typename S>
__device__ __forceinline__ void ld_pair(uint32_t* d, const S* p) {
#pragma unroll
  for (int j = 0; j < Elem<T>::kParts; ++j) d[j] = ld32(p + j * PS);
}
template <typename T, int PS, typename S>
__device__ __forceinline__ void ld_two(uint32_t* d, const S* p0,
                                       const S* p1) {
#pragma unroll
  for (int j = 0; j < Elem<T>::kParts; ++j)
    d[j] = pack_raw(p0 + j * PS, p1 + j * PS);
}

// A fragment of rows r0, r0 + 8 (r0 = 16-row slab + g) of a row-major
// shared tile with row stride `ld`, k16 step `kk`: a[4 * kParts].
template <typename T, int PS, typename S>
__device__ __forceinline__ void load_a(uint32_t* a, const S* s, int r0,
                                       int ld, int kk, int t) {
  constexpr int P = Elem<T>::kParts;
  const S* p = s + r0 * ld + kk * 16 + 2 * t;
  ld_pair<T, PS>(a, p);
  ld_pair<T, PS>(a + P, p + 8 * ld);
  ld_pair<T, PS>(a + 2 * P, p + 8);
  ld_pair<T, PS>(a + 3 * P, p + 8 * ld + 8);
}

// C += A . B^T where B's 8 columns are rows n0..n0+7 of a row-major
// shared tile (the operand of Q K^T: B's column index is the tile's row).
template <typename T, int PS, typename S>
__device__ __forceinline__ void mma_abt(float* c, const uint32_t* a,
                                        const S* s, int n0, int ld, int kk,
                                        int g, int t) {
  constexpr int P = Elem<T>::kParts;
  const S* p = s + (n0 + g) * ld + kk * 16 + 2 * t;
  uint32_t b[2 * P];
  ld_pair<T, PS>(b, p);
  ld_pair<T, PS>(b + P, p + 8);
  Elem<T>::mma(c, a, b);
}

// C += A . B where B is the 16 x 8 block at rows 16 kk.., columns n0.. of
// a row-major shared tile (the operand of P V).
template <typename T, int PS, typename S>
__device__ __forceinline__ void mma_ab(float* c, const uint32_t* a,
                                       const S* s, int n0, int ld, int kk,
                                       int g, int t) {
  constexpr int P = Elem<T>::kParts;
  const S* p = s + (kk * 16 + 2 * t) * ld + n0 + g;
  uint32_t b[2 * P];
  ld_two<T, PS>(b, p, p + ld);
  ld_two<T, PS>(b + P, p + 8 * ld, p + 9 * ld);
  Elem<T>::mma(c, a, b);
}

// The A fragment of k16 step `kk` built from fp32 accumulators of two
// adjacent n8 tiles (rounded to T, or split into parts for fp32): scores
// become the left operand of the next product without leaving registers.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t* a, float (*c)[4], int kk) {
  constexpr int P = Elem<T>::kParts;
  Elem<T>::from_pair(a, c[2 * kk][0], c[2 * kk][1]);
  Elem<T>::from_pair(a + P, c[2 * kk][2], c[2 * kk][3]);
  Elem<T>::from_pair(a + 2 * P, c[2 * kk + 1][0], c[2 * kk + 1][1]);
  Elem<T>::from_pair(a + 3 * P, c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Copy `rows` rows of a (rows, dh) tensor starting at row r0 into a
// 64-row shared tile of D (the built width >= dh) with stride D + kPad;
// rows past `rows` and columns past dh are zero. 16 bytes a lane where a
// row of dh is a whole number of 16-byte chunks, one element a lane
// otherwise. fp32 is split into its three bf16 parts here, once.
template <typename T, int D>
__device__ __forceinline__ void load_tile(typename Elem<T>::S* dst,
                                          const T* src, int r0, int rows,
                                          int dh, int tid, int nthreads) {
  constexpr int LD = D + kPad, EPC = 16 / (int)sizeof(T);
  constexpr int CH = D / EPC, PS = part_stride<T, D>();
  if (dh % EPC == 0) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kTileRows * CH; i += nthreads) {
      const int r = i / CH, c = (i % CH) * EPC;
      uint4 val = zero;
      if (r0 + r < rows && c < dh)
        val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * dh +
                                              c);
      if constexpr (Elem<T>::kParts == 1) {
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
      } else {
        uint32_t lo[3], hi[3];
        split_pair(lo, __uint_as_float(val.x), __uint_as_float(val.y));
        split_pair(hi, __uint_as_float(val.z), __uint_as_float(val.w));
#pragma unroll
        for (int j = 0; j < 3; ++j)
          *reinterpret_cast<uint2*>(dst + j * PS + r * LD + c) =
              make_uint2(lo[j], hi[j]);
      }
    }
  } else {
    for (int i = tid; i < kTileRows * D; i += nthreads) {
      const int r = i / D, c = i % D;
      const T x = (r0 + r < rows && c < dh) ? src[(size_t)(r0 + r) * dh + c]
                                            : Elem<T>::from_f(0.f);
      if constexpr (Elem<T>::kParts == 1) {
        dst[r * LD + c] = x;
      } else {
        float part[3];
        split3(x, part);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          dst[j * PS + r * LD + c] = __float2bfloat16_rn(part[j]);
      }
    }
  }
}

// Columns c and c + 1 (c even) of an output row of dh: the pair in one
// store where both exist and dh is even (so the pair is aligned), else
// each column that exists on its own.
template <typename T>
__device__ __forceinline__ void store_cols(T* row, int c, int dh, float x,
                                           float y) {
  if (c + 1 < dh && (dh & 1) == 0) {
    Elem<T>::st_pair(row + c, x, y);
  } else {
    if (c < dh) row[c] = Elem<T>::from_f(x);
    if (c + 1 < dh) row[c + 1] = Elem<T>::from_f(y);
  }
}

}  // namespace
