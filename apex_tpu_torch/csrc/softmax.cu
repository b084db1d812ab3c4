// Scaled, causal and masked softmax forward, and their shared backward,
// for Hopper (sm_90a).
//
// Replaces, in apex_tpu/ops/softmax.py:
//   `_scaled_kernel` (:48; `pallas_call` at :122)  -> mode 0, no mask;
//   `_causal_kernel` (:52; `pallas_call` at :163)  -> mode 1, key j > query i
//       masked (the -1e30 fill, whose exp is exactly 0);
//   `_masked_kernel` (:62; `pallas_call` at :215)  -> mode 2, a boolean mask
//       (mb, 1, sq | 1, sk) broadcast over heads (and queries);
//   `_bwd_kernel`    (:71; `pallas_call` at :83)   -> the shared backward.
// Same arithmetic as the reference's `_softmax_rows` (:38): s = x * scale in
// fp32, plus -10000 where the mask is True (added, not substituted: a row
// whose keys are all masked is the softmax of the shifted scores), m = the
// row's max, e = exp(s - m), y = e / sum(e) (a division, not a reciprocal),
// rounded to x's dtype (fp32, bf16 or fp16: the fills are added in fp32
// registers, and -1e30 is never stored). Each product and sum is rounded
// on its own (`__fmul_rn`, `__fadd_rn`), so nothing is contracted into an
// FMA that the plain version does not do. The backward: dot = sum(y * g) in
// fp32, then dx = (scale * y) * (g - dot), rounded to y's dtype.
//
// Bound on the card: memory. The forward reads x once and writes y once
// (plus the mask bytes it reads in mode 2: the unrepeated mask, once, when
// it broadcasts), ~10 fp32 operations per score, ~2.5 per byte of bf16: far
// below the ~20 operations per byte at which the fp32 units (67 TFLOP/s)
// would bound it. The causal forward needs only the lower triangle of x. The
// backward reads y and g and writes dx. Issue slots come close, though: the
// accurate expf is ~8 instructions, and at 512 columns bf16 the SMs have
// ~40 issue slots a score in the time the bytes take. The one-row-a-warp
// design this replaced spent them on `__fdiv_rn`: eight instructions an
// element (its reciprocal again for each) and a call to its slow path for e
// = 0, which every masked key and causal zero gives (on the H100 a multiply
// in its place cut a quarter of that design's time at BERT-Large's masked
// scores).
//
// Forward design against that bound (rows of up to 1024 columns, the model
// paths'):
// - the division in three operations, bitwise `__fdiv_rn` (softmax_div.cuh:
//   the reciprocal once a row, then a product and two FMAs; `__fdiv_rn`
//   itself, out of line, for an e in (0, 2^-100));
// - a group of G lanes owns a row, G = 4, 8, 16 or 32 chosen at launch from
//   the row's width so that a row of up to 256 bf16 columns fills its
//   lanes, with S 16-byte packs a lane (8 bf16 or fp16, or 4 fp32, and 8 or
//   4 mask bytes beside them; one element a pack where the width or the
//   pointers do not allow 16 bytes);
// - a warp's turn is one row a group (32 / G consecutive rows); each lane
//   issues every load of its row, scores and mask bytes, before any of the
//   math, and the row's max and sum reduce through `__shfl_xor_sync` inside
//   the group (more rows a group's turn, and causal rows paired as (q, sq -
//   1 - q), measured no faster at T5's (192, 128, 128) and took more
//   registers);
// - the grid is the blocks resident at once (from the occupancy of the
//   instance launched), each warp walking its turns in a grid stride;
// - in the causal mode a lane reads no pack past the diagonal and writes
//   zeros there, and only the diagonal's pack compares columns;
// - the mask is read through a batch stride and a query stride (0 where it
//   broadcasts): a (b, 1, 1, sk) or (1, 1, sq, sk) mask reaches the kernel
//   as it is, with no copy.
// The pack a lane owns (pack p in lane p % G, slot p / G) and the order of
// its sums are the replaced design's, so the output is bitwise that
// design's. Wider rows take one 256-thread block per row, which re-reads its
// row (from L1/L2) for each of its three passes and reduces through warp
// shuffles and shared memory. The TPU version tiled rows to fit VMEM and
// handed shapes it could not tile to XLA (`_row_tile`, :98-99, :118-120);
// here the grid covers any row count and the loops any width.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "resident.cuh"
#include "softmax_div.cuh"

namespace {

constexpr int kNone = 0, kCausal = 1, kMasked = 2;
constexpr float kMaskFill = -10000.f;

template <typename T>
struct Pack {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte load
};

// n consecutive elements (n = 1 or the 16-byte pack) as one load
template <typename T, int n>
struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Vec<__nv_bfloat16, 1> { using type = __nv_bfloat16; };
template <> struct Vec<__half, 8> { using type = uint4; };
template <> struct Vec<__half, 1> { using type = __half; };

template <typename T, int n>
__device__ __forceinline__ typename Vec<T, n>::type fetch(const T* p) {
  return *reinterpret_cast<const typename Vec<T, n>::type*>(p);
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// One load's elements as fp32.
template <typename T, int n>
__device__ __forceinline__ void unpack(const typename Vec<T, n>::type& r,
                                       float* out);

template <>
__device__ __forceinline__ void unpack<float, 4>(const float4& r,
                                                 float* out) {
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}
template <>
__device__ __forceinline__ void unpack<float, 1>(const float& r, float* out) {
  out[0] = r;
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16, 8>(const uint4& r,
                                                         float* out) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
    out[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
  }
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16, 1>(
    const __nv_bfloat16& r, float* out) {
  out[0] = __bfloat162float(r);
}
template <>
__device__ __forceinline__ void unpack<__half, 8>(const uint4& r, float* out) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __half2float(__ushort_as_half((unsigned short)w[i]));
    out[2 * i + 1] =
        __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
  }
}
template <>
__device__ __forceinline__ void unpack<__half, 1>(const __half& r,
                                                  float* out) {
  out[0] = __half2float(r);
}

// Load n consecutive elements (n = 1 or the 16-byte pack) as fp32.
template <typename T, int n>
__device__ __forceinline__ void load(const T* p, float* out) {
  unpack<T, n>(fetch<T, n>(p), out);
}

template <typename T, int n>
__device__ __forceinline__ void store(T* p, const float* in);

template <>
__device__ __forceinline__ void store<float, 4>(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
template <>
__device__ __forceinline__ void store<float, 1>(float* p, const float* in) {
  *p = in[0];
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16, 8>(__nv_bfloat16* p,
                                                        const float* in) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(in[2 * i]));
    uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(in[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16, 1>(__nv_bfloat16* p,
                                                        const float* in) {
  *p = __float2bfloat16_rn(in[0]);
}
template <>
__device__ __forceinline__ void store<__half, 8>(__half* p, const float* in) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t lo = __half_as_ushort(__float2half_rn(in[2 * i]));
    uint32_t hi = __half_as_ushort(__float2half_rn(in[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
template <>
__device__ __forceinline__ void store<__half, 1>(__half* p, const float* in) {
  *p = __float2half_rn(in[0]);
}

// n mask bytes (one per score; torch.bool is one byte), little-endian, as
// one load
template <int n>
struct MaskVec;
template <> struct MaskVec<1> { using type = uint8_t; };
template <> struct MaskVec<4> { using type = uint32_t; };
template <> struct MaskVec<8> { using type = uint2; };

template <int n>
__device__ __forceinline__ typename MaskVec<n>::type fetch_mask(
    const uint8_t* p) {
  return *reinterpret_cast<const typename MaskVec<n>::type*>(p);
}

__device__ __forceinline__ void unpack_mask(uint8_t w, bool* out) {
  out[0] = w != 0;
}
__device__ __forceinline__ void unpack_mask(uint32_t w, bool* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = ((w >> (8 * i)) & 0xffu) != 0;
}
__device__ __forceinline__ void unpack_mask(uint2 w, bool* out) {
  unpack_mask(w.x, out);
  unpack_mask(w.y, out + 4);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kBlockThreads = 256;

// Sum / max over a kBlockThreads block; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // `red` may still be read from the previous call
  if (lane == 0) red[wid] = v;
  __syncthreads();
  v = lane < (kBlockThreads >> 5) ? red[lane] : 0.f;
  return warp_sum(v);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  v = lane < (kBlockThreads >> 5) ? red[lane] : -INFINITY;
  return warp_max(v);
}

// The mask row of score row `row` of x (b, heads, sq, sk): batch row /
// (heads * sq), query row % sq, through the mask's strides (0 where it
// broadcasts).
__device__ __forceinline__ const uint8_t* mask_row(const uint8_t* mask,
                                                   int64_t row, int sq,
                                                   int heads, int64_t mbs,
                                                   int64_t mqs) {
  return mask + (row / ((int64_t)heads * sq)) * mbs + (row % sq) * mqs;
}

// Where one row's scores and mask start, and how many columns it reads:
// all sk, or the causal row's first q + 1.
struct Row {
  int limit;
  const uint8_t* mask;
};

template <int MODE>
__device__ __forceinline__ Row row_of(int64_t row, int sq, int sk, int heads,
                                      int64_t mbs, int64_t mqs,
                                      const uint8_t* mask) {
  Row r{sk, nullptr};
  if constexpr (MODE == kCausal) {
    const int q = (int)(row % sq);
    r.limit = q + 1 < sk ? q + 1 : sk;
  }
  if constexpr (MODE == kMasked)
    r.mask = mask_row(mask, row, sq, heads, mbs, mqs);
  return r;
}

// The n fp32 scores of columns [c, c + n) of one row from their loads:
// scale * x, plus the fill where masked; -inf past the causal row's limit
// (never summed).
template <typename T, int n, int MODE>
__device__ __forceinline__ void scores_of(
    const typename Vec<T, n>::type& raw,
    const typename MaskVec<n>::type& mraw, int c, int limit, float scale,
    float* s) {
  unpack<T, n>(raw, s);
#pragma unroll
  for (int i = 0; i < n; ++i) s[i] = __fmul_rn(s[i], scale);
  if constexpr (MODE == kMasked) {
    bool mk[n];
    unpack_mask(mraw, mk);
#pragma unroll
    for (int i = 0; i < n; ++i)
      if (mk[i]) s[i] = __fadd_rn(s[i], kMaskFill);
  }
  if constexpr (MODE == kCausal) {
    if (c + n > limit) {  // the diagonal's pack
#pragma unroll
      for (int i = 0; i < n; ++i)
        if (c + i >= limit) s[i] = -INFINITY;
    }
  }
}

template <typename T, int n, int MODE>
__device__ __forceinline__ void scores(const T* xr, const Row& r, int c,
                                       float scale, float* s) {
  typename MaskVec<n>::type mraw{};
  if constexpr (MODE == kMasked) mraw = fetch_mask<n>(r.mask + c);
  scores_of<T, n, MODE>(fetch<T, n>(xr + c), mraw, c, r.limit, scale, s);
}

constexpr int kWarpRowMax = 1024;  // widest row a lane group keeps in registers
constexpr int kRowThreads = 128;   // 4 warps a block on the row path

// A group of G lanes a row, S packs of N elements a lane. A warp's turn is
// one row a group, consecutive rows, so that its loads are contiguous; every
// warp walks its turns in a grid stride.
template <typename T, int N, int MODE, int G, int S>
__global__ void __launch_bounds__(kRowThreads)
    softmax_fwd_rows(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                     T* __restrict__ y, int64_t rows, int sq, int sk,
                     int heads, int64_t mbs, int64_t mqs, float scale) {
  using V = typename Vec<T, N>::type;
  using M = typename MaskVec<N>::type;
  constexpr int kGroups = 32 / G;
  const int lane = threadIdx.x & 31;
  const int gl = lane % G, grp = lane / G;
  const int64_t turns = (rows + kGroups - 1) / kGroups;
  const int64_t warps = (int64_t)gridDim.x * (kRowThreads / 32);
  for (int64_t t = (int64_t)blockIdx.x * (kRowThreads / 32) +
                   (threadIdx.x >> 5);
       t < turns; t += warps) {
    // a group past the last row reads nothing and writes nothing, but
    // takes part in the shuffles
    const int64_t row = t * kGroups + grp;
    const bool live = row < rows;
    int limit = live ? sk : 0;
    if constexpr (MODE == kCausal) {
      const int q = (int)(row % sq);
      if (live && q + 1 < sk) limit = q + 1;
    }
    const T* xr = x + (live ? row : 0) * sk;
    const uint8_t* mr = nullptr;
    if constexpr (MODE == kMasked)
      if (live) mr = mask_row(mask, row, sq, heads, mbs, mqs);
    // every load of the row first
    V raw[S];
    M mraw[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c = (s * G + gl) * N;
      if (c < limit) {
        raw[s] = fetch<T, N>(xr + c);
        if constexpr (MODE == kMasked) mraw[s] = fetch_mask<N>(mr + c);
      }
    }
    float v[S * N];
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c = (s * G + gl) * N;
      if (c < limit) {
        scores_of<T, N, MODE>(raw[s], mraw[s], c, limit, scale, v + s * N);
#pragma unroll
        for (int i = 0; i < N; ++i) mx = fmaxf(mx, v[s * N + i]);
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    bool tiny = false;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c = (s * G + gl) * N;
      if (c < limit) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          // past the causal diagonal s = -inf, and exp gives 0
          const float e = expf(__fsub_rn(v[s * N + i], mx));
          v[s * N + i] = e;
          sum = __fadd_rn(sum, e);
          tiny |= softmax_div::div_tiny(e);
        }
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (!live) continue;
    T* yr = y + row * sk;
    const float r = __frcp_rn(sum);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c = (s * G + gl) * N;
      if (c < sk) {
        float o[N];
        if (c >= limit) {
#pragma unroll
          for (int i = 0; i < N; ++i) o[i] = 0.f;
        } else if (!tiny) {
#pragma unroll
          for (int i = 0; i < N; ++i)
            o[i] = softmax_div::div_row(v[s * N + i], sum, r);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i)
            o[i] = softmax_div::div_slow(v[s * N + i], sum);
        }
        store<T, N>(yr + c, o);
      }
    }
  }
}

// One block per row for rows wider than a lane group holds; each pass
// re-reads the row (it stays in L1/L2 between passes).
template <typename T, int N, int MODE>
__global__ void __launch_bounds__(kBlockThreads)
    softmax_fwd_block(const T* __restrict__ x,
                      const uint8_t* __restrict__ mask, T* __restrict__ y,
                      int64_t rows, int sq, int sk, int heads, int64_t mbs,
                      int64_t mqs, float scale) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;  // the grid is `rows` blocks
  const T* xr = x + row * sk;
  T* yr = y + row * sk;
  const Row r = row_of<MODE>(row, sq, sk, heads, mbs, mqs, mask);
  float s[N];

  float mx = -INFINITY;
  for (int c = threadIdx.x * N; c < r.limit; c += kBlockThreads * N) {
    scores<T, N, MODE>(xr, r, c, scale, s);
#pragma unroll
    for (int i = 0; i < N; ++i) mx = fmaxf(mx, s[i]);
  }
  mx = block_max(mx, red);
  float sum = 0.f;
  for (int c = threadIdx.x * N; c < r.limit; c += kBlockThreads * N) {
    scores<T, N, MODE>(xr, r, c, scale, s);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (!(MODE == kCausal && c + i >= r.limit))
        sum = __fadd_rn(sum, expf(__fsub_rn(s[i], mx)));
  }
  sum = block_sum(sum, red);
  for (int c = threadIdx.x * N; c < sk; c += kBlockThreads * N) {
    if (c < r.limit) {
      scores<T, N, MODE>(xr, r, c, scale, s);
#pragma unroll
      for (int i = 0; i < N; ++i)
        s[i] = (MODE == kCausal && c + i >= r.limit)
                   ? 0.f
                   : __fdiv_rn(expf(__fsub_rn(s[i], mx)), sum);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = 0.f;
    }
    store<T, N>(yr + c, s);
  }
}

constexpr int kRowsPerWarpBlock = 4;  // the backward: one warp a row

// dx = (scale * y) * (g - sum(y * g)), one warp per row.
template <typename T, int N>
__global__ void __launch_bounds__(32 * kRowsPerWarpBlock)
    softmax_bwd_warp(const T* __restrict__ y, const T* __restrict__ g,
                     T* __restrict__ dx, int64_t rows, int sk, float scale) {
  constexpr int kSlots = kWarpRowMax / (32 * N);
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kRowsPerWarpBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* yr = y + row * sk;
  const T* gr = g + row * sk;
  T* dr = dx + row * sk;

  float yv[kSlots * N], gv[kSlots * N];
  float dot = 0.f;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = (s * 32 + lane) * N;
    if (c < sk) {
      load<T, N>(yr + c, yv + s * N);
      load<T, N>(gr + c, gv + s * N);
#pragma unroll
      for (int i = 0; i < N; ++i)
        dot = __fadd_rn(dot, __fmul_rn(yv[s * N + i], gv[s * N + i]));
    }
  }
  dot = warp_sum(dot);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = (s * 32 + lane) * N;
    if (c < sk) {
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        o[i] = __fmul_rn(__fmul_rn(scale, yv[s * N + i]),
                         __fsub_rn(gv[s * N + i], dot));
      store<T, N>(dr + c, o);
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kBlockThreads)
    softmax_bwd_block(const T* __restrict__ y, const T* __restrict__ g,
                      T* __restrict__ dx, int sk, float scale) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const T* yr = y + row * sk;
  const T* gr = g + row * sk;
  T* dr = dx + row * sk;
  float yv[N], gv[N];

  float dot = 0.f;
  for (int c = threadIdx.x * N; c < sk; c += kBlockThreads * N) {
    load<T, N>(yr + c, yv);
    load<T, N>(gr + c, gv);
#pragma unroll
    for (int i = 0; i < N; ++i) dot = __fadd_rn(dot, __fmul_rn(yv[i], gv[i]));
  }
  dot = block_sum(dot, red);
  for (int c = threadIdx.x * N; c < sk; c += kBlockThreads * N) {
    load<T, N>(yr + c, yv);
    load<T, N>(gr + c, gv);
#pragma unroll
    for (int i = 0; i < N; ++i)
      yv[i] = __fmul_rn(__fmul_rn(scale, yv[i]), __fsub_rn(gv[i], dot));
    store<T, N>(dr + c, yv);
  }
}

inline int64_t warp_grid(int64_t rows) {
  return (rows + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock;
}

// The row path's instance for G lanes and S slots.
template <typename T, int N, int MODE, int G, int S>
struct RowCfg {
  static constexpr int kLanes = G, kSlots = S;
  static constexpr int kGroups = 32 / G;
  static constexpr auto kernel = softmax_fwd_rows<T, N, MODE, G, S>;
};

// f(RowCfg<...>{}) for the narrowest group and the fewest slots that hold
// `packs` packs: 4, 8, 16 or 32 lanes of one slot, else 32 lanes of 2, 4,
// ... slots (pack p in lane p % G, slot p / G).
template <typename T, int N, int MODE, int S = 2, typename F>
cudaError_t with_slots(int packs, F&& f) {
  if constexpr (32 * S * N >= kWarpRowMax) {
    return f(RowCfg<T, N, MODE, 32, S>{});
  } else {
    if (packs <= 32 * S) return f(RowCfg<T, N, MODE, 32, S>{});
    return with_slots<T, N, MODE, 2 * S>(packs, f);
  }
}

template <typename T, int N, int MODE, typename F>
cudaError_t with_row_cfg(int sk, F&& f) {
  const int packs = (sk + N - 1) / N;
  if (packs <= 4) return f(RowCfg<T, N, MODE, 4, 1>{});
  if (packs <= 8) return f(RowCfg<T, N, MODE, 8, 1>{});
  if (packs <= 16) return f(RowCfg<T, N, MODE, 16, 1>{});
  if (packs <= 32) return f(RowCfg<T, N, MODE, 32, 1>{});
  return with_slots<T, N, MODE>(packs, f);
}

template <typename T>
using FwdKernel = void (*)(const T*, const uint8_t*, T*, int64_t, int, int,
                           int, int64_t, int64_t, float);

// How the forward runs (rows, sk): its kernel, threads a block and blocks;
// on the row path also the lanes a row, the slots a lane and the blocks
// resident at once (all 0 on the block path).
template <typename T>
struct Plan {
  FwdKernel<T> kernel;
  int threads;
  int64_t blocks;
  int lanes, slots, resident;
};

// Rows of up to kWarpRowMax columns: every warp's turn at once where the
// card holds them, else the resident blocks walking the turns. Wider rows:
// one block a row.
template <typename T, int N, int MODE>
cudaError_t plan_fwd(int64_t rows, int sk, Plan<T>* p) {
  if (sk > kWarpRowMax) {
    if (rows > INT_MAX) return cudaErrorInvalidValue;
    *p = {softmax_fwd_block<T, N, MODE>, kBlockThreads, rows, 0, 0, 0};
    return cudaSuccess;
  }
  return with_row_cfg<T, N, MODE>(sk, [&](auto cfg) -> cudaError_t {
    using Cfg = decltype(cfg);
    cudaError_t err = cudaSuccess;
    const int resident = resident_blocks<Cfg::kernel>(kRowThreads, 0, &err);
    if (err != cudaSuccess) return err;
    const int64_t turns = (rows + Cfg::kGroups - 1) / Cfg::kGroups;
    const int64_t need =
        (turns + kRowThreads / 32 - 1) / (kRowThreads / 32);
    *p = {Cfg::kernel, kRowThreads, need < resident ? need : resident,
          Cfg::kLanes, Cfg::kSlots, resident};
    return cudaSuccess;
  });
}

// Launches the forward; or, where `route` is set, launches nothing and
// writes how it runs: route[7] = {lanes a row, slots a lane, threads a
// block, blocks, resident blocks, registers a thread, local (spilled) bytes
// a thread}.
template <typename T, int N, int MODE>
cudaError_t forward(const void* x, const uint8_t* mask, void* y,
                    int64_t rows, int sq, int sk, int heads, int64_t mbs,
                    int64_t mqs, float scale, cudaStream_t stream,
                    int* route) {
  Plan<T> p;
  cudaError_t err = plan_fwd<T, N, MODE>(rows, sk, &p);
  if (err != cudaSuccess) return err;
  if (route != nullptr) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, p.kernel);
    if (err != cudaSuccess) return err;
    const int vals[7] = {p.lanes, p.slots, p.threads, (int)p.blocks,
                         p.resident, fa.numRegs, (int)fa.localSizeBytes};
    for (int i = 0; i < 7; ++i) route[i] = vals[i];
    return cudaSuccess;
  }
  p.kernel<<<(unsigned)p.blocks, p.threads, 0, stream>>>(
      static_cast<const T*>(x), mask, static_cast<T*>(y), rows, sq, sk, heads,
      mbs, mqs, scale);
  return cudaGetLastError();
}

// forward<T, N, MODE> for the dtype code, the pack (16 bytes, or one
// element where `vec` is false) and the mode.
template <typename T, int MODE, typename... A>
cudaError_t forward_packed(bool vec, A... a) {
  return vec ? forward<T, Pack<T>::N, MODE>(a...) : forward<T, 1, MODE>(a...);
}

template <typename T, typename... A>
cudaError_t forward_mode(int mode, bool vec, A... a) {
  if (mode == kNone) return forward_packed<T, kNone>(vec, a...);
  if (mode == kCausal) return forward_packed<T, kCausal>(vec, a...);
  if (mode == kMasked) return forward_packed<T, kMasked>(vec, a...);
  return cudaErrorInvalidValue;
}

template <typename... A>
cudaError_t forward_any(int dtype, int mode, bool vec, A... a) {
  if (dtype == 0) return forward_mode<float>(mode, vec, a...);
  if (dtype == 1) return forward_mode<__nv_bfloat16>(mode, vec, a...);
  if (dtype == 2) return forward_mode<__half>(mode, vec, a...);
  return cudaErrorInvalidValue;
}

template <typename T, int N>
cudaError_t launch_bwd(const void* y, const void* g, void* dx, int64_t rows,
                       int sk, float scale, cudaStream_t stream) {
  const T* yt = static_cast<const T*>(y);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  if (sk <= kWarpRowMax) {
    const int64_t grid = warp_grid(rows);
    if (grid > INT_MAX) return cudaErrorInvalidValue;
    softmax_bwd_warp<T, N><<<(unsigned)grid, 32 * kRowsPerWarpBlock, 0,
                             stream>>>(yt, gt, dt, rows, sk, scale);
  } else {
    if (rows > INT_MAX) return cudaErrorInvalidValue;
    softmax_bwd_block<T, N><<<(unsigned)rows, kBlockThreads, 0, stream>>>(
        yt, gt, dt, sk, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_packed(bool vec, const void* y, const void* g, void* dx,
                       int64_t rows, int sk, float scale,
                       cudaStream_t stream) {
  return vec ? launch_bwd<T, Pack<T>::N>(y, g, dx, rows, sk, scale, stream)
             : launch_bwd<T, 1>(y, g, dx, rows, sk, scale, stream);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// 16-byte packs need rows that divide into them and 16-byte aligned
// pointers (the mask, a pack's worth of bytes at every row it reads).
inline bool packed(int dtype, int sk, const void* a, const void* b,
                   const void* c, const void* mask, int64_t mbs,
                   int64_t mqs) {
  const int pack = dtype == 0 ? 4 : 8;
  return sk % pack == 0 && aligned(a, 16) && aligned(b, 16) &&
         (c == nullptr || aligned(c, 16)) &&
         (mask == nullptr ||
          (aligned(mask, pack) && mbs % pack == 0 && mqs % pack == 0));
}

}  // namespace

// x, y: contiguous, rows x sk, dtype 0 = fp32, 1 = bf16, 2 = fp16. mode
// 0: no mask; mode 1: causal over (rows / sq, sq, sk); mode 2: x (b, heads,
// sq, sk) under a bool mask (one byte a score, unit stride along the keys)
// whose row for score row r is mask + (r / (heads * sq)) * mask_bstride + (r
// % sq) * mask_qstride: strides in bytes, 0 where the mask broadcasts over
// the batch or the queries. Returns cudaGetLastError() after the launch.
extern "C" int apex_softmax_fwd(const void* x, const void* mask, void* y,
                                int64_t rows, int sq, int sk, int heads,
                                int64_t mask_bstride, int64_t mask_qstride,
                                float scale, int mode, int dtype,
                                void* stream) {
  if (rows == 0 || sk == 0) return (int)cudaGetLastError();
  if (rows < 0 || sk < 0 || sq <= 0 || heads <= 0 || mask_bstride < 0 ||
      mask_qstride < 0 || (mode == kMasked && mask == nullptr))
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = mode == kMasked ? static_cast<const uint8_t*>(mask)
                                     : nullptr;
  const bool vec = packed(dtype, sk, x, y, nullptr, m, mask_bstride,
                          mask_qstride);
  return (int)forward_any(dtype, mode, vec, x, m, y, rows, sq, sk, heads,
                          mask_bstride, mask_qstride, scale,
                          static_cast<cudaStream_t>(stream), (int*)nullptr);
}

// How apex_softmax_fwd runs these arguments (the pointers only for their
// alignment): out[7] = {lanes a row (0 on the block path for rows past
// 1024), slots a lane, threads a block, blocks, blocks resident at once,
// registers a thread, spilled bytes a thread}.
extern "C" int apex_softmax_fwd_route(const void* x, const void* mask,
                                      void* y, int64_t rows, int sq, int sk,
                                      int64_t mask_bstride,
                                      int64_t mask_qstride, int mode,
                                      int dtype, int* out) {
  if (rows <= 0 || sk <= 0 || sq <= 0) return (int)cudaErrorInvalidValue;
  const uint8_t* m = mode == kMasked ? static_cast<const uint8_t*>(mask)
                                     : nullptr;
  const bool vec = packed(dtype, sk, x, y, nullptr, m, mask_bstride,
                          mask_qstride);
  return (int)forward_any(dtype, mode, vec, x, m, y, rows, sq, sk, 1,
                          mask_bstride, mask_qstride, 1.f,
                          (cudaStream_t) nullptr, out);
}

// y, g, dx: contiguous, rows x sk, one dtype (0 = fp32, 1 = bf16, 2 =
// fp16).
// Returns cudaGetLastError() after the launch.
extern "C" int apex_softmax_bwd(const void* y, const void* g, void* dx,
                                int64_t rows, int sk, float scale, int dtype,
                                void* stream) {
  if (rows == 0 || sk == 0) return (int)cudaGetLastError();
  if (rows < 0 || sk < 0) return (int)cudaErrorInvalidValue;
  const bool vec = packed(dtype, sk, y, dx, g, nullptr, 0, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd_packed<float>(vec, y, g, dx, rows, sk, scale, st);
  if (dtype == 1)
    return (int)bwd_packed<__nv_bfloat16>(vec, y, g, dx, rows, sk, scale,
                                          st);
  if (dtype == 2)
    return (int)bwd_packed<__half>(vec, y, g, dx, rows, sk, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* apex_softmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
