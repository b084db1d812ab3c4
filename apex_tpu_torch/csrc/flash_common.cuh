// Pieces shared by the flash-attention kernels (flash_fwd_sm90.cuh,
// flash_bwd_sm90.cuh, and the fp32 flash_fwd32_sm90.cuh, flash_bwd32_sm90.cuh):
// the element types, the fp32 split into bf16 parts, the reference's mask
// pieces (apex_tpu/ops/attention.py `_mask_block`, :59-86; the bias and the
// live-tile test) and its dropout keep mask (`_dropout_keep`, :89-112).
//
// Element types (`Elem<T>`): bf16 and fp16 are one 32-bit register a pair,
// multiplied by the bf16 or fp16 tensor-core products. fp32 has no exact
// tensor-core product (TF32 keeps 10 mantissa bits), so an fp32 value is
// split into three bf16 parts, x = hi + mid + lo (8 bits each: exact but
// for the last bit of a few values; `split3`), and a product is the six
// bf16 products whose parts reach 2^-16 of the leading one
// (exact32_sm90.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

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
};

template <>
struct Elem<__half> {
  using T = __half;
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
};

template <>
struct Elem<float> {
  using T = float;
  static constexpr int kCode = 0;
  static __device__ __forceinline__ T from_f(float x) { return x; }
  static __device__ __forceinline__ void st_pair(T* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// The built head widths: a head_dim is zero-padded (by TMA, past the rows
// of the tensors or planes the kernels read) to the next of these: zero
// columns add nothing to q.k and their output columns are not stored. 0 past
// the widest. 256 is built for bf16 and fp16 only.
__host__ __device__ constexpr int built_width(int dh) {
  return dh < 1 ? 0 : dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 96 ? 96
         : dh <= 128 ? 128 : dh <= 256 ? 256 : 0;
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

// The A fragment (m16k16: a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] =
// (g, 2t+8..), a[3] = (g+8, 2t+8..); g = lane / 4, t = lane % 4) of k16 step
// `kk` built from the fp32 accumulators of two adjacent n8 tiles (c[0..1]
// = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)), rounded to T (bf16 or
// fp16): scores become the left operand of the next product without
// leaving registers.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t* a, float (*c)[4], int kk) {
  Elem<T>::from_pair(a, c[2 * kk][0], c[2 * kk][1]);
  Elem<T>::from_pair(a + 1, c[2 * kk][2], c[2 * kk][3]);
  Elem<T>::from_pair(a + 2, c[2 * kk + 1][0], c[2 * kk + 1][1]);
  Elem<T>::from_pair(a + 3, c[2 * kk + 1][2], c[2 * kk + 1][3]);
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
