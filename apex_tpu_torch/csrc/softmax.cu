// Scaled, causal and masked softmax forward, and their shared backward,
// for Hopper (sm_90a).
//
// Replaces, in apex_tpu/ops/softmax.py:
//   `_scaled_kernel` (:48; `pallas_call` at :122)  -> mode 0, no mask;
//   `_causal_kernel` (:52; `pallas_call` at :163)  -> mode 1, key j > query i
//       masked (the -1e30 fill, whose exp is exactly 0);
//   `_masked_kernel` (:62; `pallas_call` at :215)  -> mode 2, a boolean mask
//       (mb, 1, sq, sk) broadcast over heads, row (i / h) % mb;
//   `_bwd_kernel`    (:71; `pallas_call` at :83)   -> the shared backward.
// Same arithmetic as the reference's `_softmax_rows` (:38): s = x * scale in
// fp32, plus -10000 where the mask is True (added, not substituted: a row
// whose keys are all masked is the softmax of the shifted scores), m = the
// row's max, e = exp(s - m), y = e / sum(e) (a division, not a reciprocal),
// rounded to x's dtype (fp32, bf16 or fp16: the fills are added in fp32
// registers, and -1e30 is never stored). Each product and sum is rounded
// on its own
// (`__fmul_rn`, `__fadd_rn`), so nothing is contracted into an FMA that the
// plain version does not do. The backward: dot = sum(y * g) in fp32, then
// dx = (scale * y) * (g - dot), rounded to y's dtype.
//
// Bound on the card: memory. The forward reads x once and writes y once
// (plus one mask byte per score in mode 2), ~10 fp32 operations per score,
// ~2.5 per byte of bf16: far below the ~20 operations per byte at which the
// fp32 units (67 TFLOP/s) would bound it. The causal forward needs only the
// lower triangle of x. The backward reads y and g and writes dx.
//
// Design against that bound: every score is read from device memory once,
// with 16-byte vector loads and stores (8 bf16 or fp16, or 4 fp32, a lane,
// with 8 or 4 mask bytes beside them) whenever the row width and the
// pointers allow, else one element at a time. For sk <= 1024 one warp owns one row and
// keeps it in registers, so the max, the sum and the output run on
// registers and reduce through warp shuffles; four rows share a 128-thread
// block. Wider rows take one 256-thread block per row, which re-reads its
// row (from L1/L2) for each of its three passes and reduces through warp
// shuffles and shared memory. In the causal mode a lane skips the packs
// past the diagonal: it reads none of them and writes zeros. The TPU
// version tiled rows to fit VMEM and handed shapes it could not tile to
// XLA (`_row_tile`, :98-99, :118-120); here the grid covers any row count
// and the loops any width.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNone = 0, kCausal = 1, kMasked = 2;
constexpr float kMaskFill = -10000.f;

template <typename T>
struct Pack {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte load
};

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// Load n consecutive elements (n = 1 or the 16-byte pack) as fp32.
template <typename T, int n>
__device__ __forceinline__ void load(const T* p, float* out);

template <>
__device__ __forceinline__ void load<float, 4>(const float* p, float* out) {
  float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}
template <>
__device__ __forceinline__ void load<float, 1>(const float* p, float* out) {
  out[0] = *p;
}
template <>
__device__ __forceinline__ void load<__nv_bfloat16, 8>(const __nv_bfloat16* p,
                                                       float* out) {
  uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
    out[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
  }
}
template <>
__device__ __forceinline__ void load<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                       float* out) {
  out[0] = __bfloat162float(*p);
}
template <>
__device__ __forceinline__ void load<__half, 8>(const __half* p, float* out) {
  uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __half2float(__ushort_as_half((unsigned short)w[i]));
    out[2 * i + 1] =
        __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
  }
}
template <>
__device__ __forceinline__ void load<__half, 1>(const __half* p, float* out) {
  out[0] = __half2float(*p);
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

// n mask bytes (one per score; torch.bool is one byte), little-endian.
template <int n>
__device__ __forceinline__ void load_mask(const uint8_t* p, bool* out);

template <>
__device__ __forceinline__ void load_mask<1>(const uint8_t* p, bool* out) {
  out[0] = *p != 0;
}
template <>
__device__ __forceinline__ void load_mask<4>(const uint8_t* p, bool* out) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = ((w >> (8 * i)) & 0xffu) != 0;
}
template <>
__device__ __forceinline__ void load_mask<8>(const uint8_t* p, bool* out) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = ((w.x >> (8 * i)) & 0xffu) != 0;
    out[4 + i] = ((w.y >> (8 * i)) & 0xffu) != 0;
  }
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

// Where one row's scores and mask start, and how many columns it reads:
// all sk, or the causal row's first q + 1.
struct Row {
  int limit;
  const uint8_t* mask;
};

template <int MODE>
__device__ __forceinline__ Row row_of(int64_t row, int sq, int sk, int heads,
                                      int mb, const uint8_t* mask) {
  Row r{sk, nullptr};
  if constexpr (MODE == kCausal) {
    const int q = (int)(row % sq);
    r.limit = q + 1 < sk ? q + 1 : sk;
  }
  if constexpr (MODE == kMasked) {
    const int64_t b = row / ((int64_t)heads * sq);
    const int64_t q = row % sq;
    r.mask = mask + ((b % mb) * sq + q) * (int64_t)sk;
  }
  return r;
}

// The N fp32 scores of columns [c, c + N) of one row: scale * x, plus the
// fill where masked; -inf past the causal row's limit (never summed).
template <typename T, int N, int MODE>
__device__ __forceinline__ void scores(const T* xr, const Row& r, int c,
                                       float scale, float* s) {
  load<T, N>(xr + c, s);
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = __fmul_rn(s[i], scale);
  if constexpr (MODE == kMasked) {
    bool mk[N];
    load_mask<N>(r.mask + c, mk);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (mk[i]) s[i] = __fadd_rn(s[i], kMaskFill);
  }
  if constexpr (MODE == kCausal) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (c + i >= r.limit) s[i] = -INFINITY;
  }
}

constexpr int kWarpRowMax = 1024;  // widest row one warp keeps in registers
constexpr int kRowsPerWarpBlock = 4;

// One warp per row, the row held in registers.
template <typename T, int N, int MODE>
__global__ void __launch_bounds__(32 * kRowsPerWarpBlock)
    softmax_fwd_warp(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                     T* __restrict__ y, int64_t rows, int sq, int sk,
                     int heads, int mb, float scale) {
  constexpr int kSlots = kWarpRowMax / (32 * N);
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kRowsPerWarpBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * sk;
  T* yr = y + row * sk;
  const Row r = row_of<MODE>(row, sq, sk, heads, mb, mask);

  float v[kSlots * N];
  float mx = -INFINITY;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = (s * 32 + lane) * N;
    if (c < r.limit) {
      scores<T, N, MODE>(xr, r, c, scale, v + s * N);
#pragma unroll
      for (int i = 0; i < N; ++i) mx = fmaxf(mx, v[s * N + i]);
    }
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = (s * 32 + lane) * N;
    if (c < r.limit) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float e = (MODE == kCausal && c + i >= r.limit)
                            ? 0.f
                            : expf(__fsub_rn(v[s * N + i], mx));
        v[s * N + i] = e;
        sum = __fadd_rn(sum, e);
      }
    }
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = (s * 32 + lane) * N;
    if (c < sk) {
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        o[i] = c < r.limit ? __fdiv_rn(v[s * N + i], sum) : 0.f;
      store<T, N>(yr + c, o);
    }
  }
}

// One block per row for rows wider than a warp holds; each pass re-reads
// the row (it stays in L1/L2 between passes).
template <typename T, int N, int MODE>
__global__ void __launch_bounds__(kBlockThreads)
    softmax_fwd_block(const T* __restrict__ x,
                      const uint8_t* __restrict__ mask, T* __restrict__ y,
                      int sq, int sk, int heads, int mb, float scale) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * sk;
  T* yr = y + row * sk;
  const Row r = row_of<MODE>(row, sq, sk, heads, mb, mask);
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

template <typename T, int N, int MODE>
cudaError_t launch_fwd(const void* x, const uint8_t* mask, void* y,
                       int64_t rows, int sq, int sk, int heads, int mb,
                       float scale, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (sk <= kWarpRowMax) {
    const int64_t grid = warp_grid(rows);
    if (grid > INT_MAX) return cudaErrorInvalidValue;
    softmax_fwd_warp<T, N, MODE><<<(unsigned)grid,
                                   32 * kRowsPerWarpBlock, 0, stream>>>(
        xt, mask, yt, rows, sq, sk, heads, mb, scale);
  } else {
    if (rows > INT_MAX) return cudaErrorInvalidValue;
    softmax_fwd_block<T, N, MODE><<<(unsigned)rows, kBlockThreads, 0,
                                    stream>>>(xt, mask, yt, sq, sk, heads,
                                              mb, scale);
  }
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t fwd_packed(bool vec, const void* x, const uint8_t* mask, void* y,
                       int64_t rows, int sq, int sk, int heads, int mb,
                       float scale, cudaStream_t stream) {
  return vec ? launch_fwd<T, Pack<T>::N, MODE>(x, mask, y, rows, sq, sk,
                                               heads, mb, scale, stream)
             : launch_fwd<T, 1, MODE>(x, mask, y, rows, sq, sk, heads, mb,
                                      scale, stream);
}

template <typename T>
cudaError_t fwd_mode(int mode, bool vec, const void* x, const uint8_t* mask,
                     void* y, int64_t rows, int sq, int sk, int heads,
                     int mb, float scale, cudaStream_t stream) {
  switch (mode) {
    case kNone:
      return fwd_packed<T, kNone>(vec, x, mask, y, rows, sq, sk, heads, mb,
                                  scale, stream);
    case kCausal:
      return fwd_packed<T, kCausal>(vec, x, mask, y, rows, sq, sk, heads,
                                    mb, scale, stream);
    case kMasked:
      return fwd_packed<T, kMasked>(vec, x, mask, y, rows, sq, sk, heads,
                                    mb, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
// pointers (the mask, a pack's worth of bytes).
inline bool packed(int dtype, int sk, const void* a, const void* b,
                   const void* c, const void* mask) {
  const int pack = dtype == 0 ? 4 : 8;
  return sk % pack == 0 && aligned(a, 16) && aligned(b, 16) &&
         (c == nullptr || aligned(c, 16)) &&
         (mask == nullptr || aligned(mask, pack));
}

}  // namespace

// x, y: contiguous, rows x sk, dtype 0 = fp32, 1 = bf16, 2 = fp16. mode
// 0: no mask; mode 1: causal over (rows / sq, sq, sk); mode 2: mask (mb, sq, sk) bool
// bytes, row r of x (b, heads, sq, sk) reading mask batch
// (r / (heads * sq)) % mb. Returns cudaGetLastError() after the launch.
extern "C" int apex_softmax_fwd(const void* x, const void* mask, void* y,
                                int64_t rows, int sq, int sk, int heads,
                                int mb, float scale, int mode, int dtype,
                                void* stream) {
  if (rows == 0 || sk == 0) return (int)cudaGetLastError();
  if (rows < 0 || sk < 0 || sq <= 0 || heads <= 0 || mb <= 0 ||
      (mode == kMasked && mask == nullptr))
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = mode == kMasked ? static_cast<const uint8_t*>(mask)
                                     : nullptr;
  const bool vec = packed(dtype, sk, x, y, nullptr, m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)fwd_mode<float>(mode, vec, x, m, y, rows, sq, sk, heads, mb,
                                scale, st);
  if (dtype == 1)
    return (int)fwd_mode<__nv_bfloat16>(mode, vec, x, m, y, rows, sq, sk,
                                        heads, mb, scale, st);
  if (dtype == 2)
    return (int)fwd_mode<__half>(mode, vec, x, m, y, rows, sq, sk, heads, mb,
                                 scale, st);
  return (int)cudaErrorInvalidValue;
}

// y, g, dx: contiguous, rows x sk, one dtype (0 = fp32, 1 = bf16, 2 =
// fp16).
// Returns cudaGetLastError() after the launch.
extern "C" int apex_softmax_bwd(const void* y, const void* g, void* dx,
                                int64_t rows, int sk, float scale, int dtype,
                                void* stream) {
  if (rows == 0 || sk == 0) return (int)cudaGetLastError();
  if (rows < 0 || sk < 0) return (int)cudaErrorInvalidValue;
  const bool vec = packed(dtype, sk, y, dx, g, nullptr);
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
