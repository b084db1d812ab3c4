// Fused dropout for Hopper (sm_90a): threefry2x32 bits, compare, select.
//
// Not the port of a TPU kernel: the reference's dropout is flax
// `nn.Dropout` (flax/linen/stochastic.py), which XLA computes as
//   keep = bernoulli(key, 1 - rate, shape)   (threefry2x32 bits, jax.random)
//   y    = select(keep, x / keep_prob, 0)
// with no `pallas_call`. Written out in PyTorch ops the generator costs
// ~160 elementwise passes (apex_tpu_torch/random.py, the plain version),
// so on the card the draw, the compare and the select are one pass.
//
// Per element at flat index i (JAX 0.9.0, jax_threefry_partitionable):
//   (y0, y1) = threefry2x32(k0, k1, hi32(i), lo32(i));  b = y0 ^ y1
//   u = bits_as_float((b >> 9) | 0x3F800000) - 1.0f       (uniform [0, 1))
//   keep = u < keep_p                                      (fp32 1 - rate)
//   y = keep ? round(float(x) / keep_x) : 0
// keep_x is keep_p rounded to x's dtype (flax divides a bf16 input by the
// bf16 keep probability: 0.9 -> 0.8984375), the quotient taken in fp32 and
// rounded once to x's dtype, as XLA computes a bf16 division. The
// backward is the same pass over the gradient (the derivative of
// select(keep, x / c, 0) is select(keep, g / c, 0)), recomputing the mask
// from the key: nothing is saved.
//
// Bound on the card: the generator's integer work. Twenty rounds of
// add, rotate (one funnel shift) and xor plus the key injections are ~78
// integer operations an element, ~84 with the compare and the select,
// against 4 bytes an element for bf16 (read x, write y): at the fp32 rate
// of 67 T operations/s (the H100's 64 INT32 lanes an SM give half of
// that) and 3.35 TB/s the two bounds are within a factor of two, and the
// integer pipe is the likelier limit.
//
// The generator (`threefry_bits`) is csrc/sr_common.cuh's, shared with the
// stochastic-rounding kernels.
//
// Design: a grid-stride loop, one element a thread an iteration, four
// consecutive elements a thread (fp32: one 16-byte load; bf16/fp16 one
// 8-byte load), the key words and thresholds in registers. Each
// element's bits depend only on its flat index, so any schedule gives
// the plain version's bits exactly.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // elements a thread an iteration

__device__ __forceinline__ bool keep_at(uint32_t k0, uint32_t k1, int64_t i,
                                        float keep_p) {
  const uint32_t b = threefry_bits(k0, k1, (uint32_t)((uint64_t)i >> 32),
                                   (uint32_t)(uint64_t)i);
  const float u = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
  return u < keep_p;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ T drop_one(T x, bool keep, float keep_x) {
  return keep ? from_f<T>(__fdiv_rn(to_f(x), keep_x)) : from_f<T>(0.f);
}

// Vector of kVec elements of T, loaded and stored at once.
template <typename T>
struct alignas(sizeof(T) * kVec) Vec {
  T v[kVec];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                   uint32_t k0, uint32_t k1, float keep_p, float keep_x) {
  const int64_t stride = (int64_t)gridDim.x * kThreads * kVec;
  const int64_t n_vec = n - n % kVec;
  for (int64_t base = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kVec;
       base < n_vec; base += stride) {
    Vec<T> in = *reinterpret_cast<const Vec<T>*>(x + base);
    Vec<T> out;
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      out.v[j] = drop_one(in.v[j], keep_at(k0, k1, base + j, keep_p), keep_x);
    *reinterpret_cast<Vec<T>*>(y + base) = out;
  }
  // the tail of fewer than kVec elements, one a thread of the first block
  if (blockIdx.x == 0 && threadIdx.x < n - n_vec) {
    const int64_t i = n_vec + threadIdx.x;
    y[i] = drop_one(x[i], keep_at(k0, k1, i, keep_p), keep_x);
  }
}

template <typename T>
int launch(const void* x, void* y, int64_t n, uint32_t k0, uint32_t k1,
           float keep_p, float keep_x, cudaStream_t stream) {
  const int64_t vecs = (n + kVec - 1) / kVec;
  int64_t blocks = (vecs + kThreads - 1) / kThreads;
  // enough blocks to fill 132 SMs many times over; the loop takes the rest
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  dropout_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, k0, k1, keep_p,
      keep_x);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: n contiguous elements of dtype (0 fp32, 1 bf16, 2 fp16), 16-byte
// aligned (y may be x). key (k0, k1): the threefry key's two words.
// keep_p: the keep probability in fp32; keep_x: it rounded to x's dtype,
// as a float. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another dtype).
extern "C" int apex_dropout(const void* x, void* y, int64_t n, int dtype,
                            uint32_t k0, uint32_t k1, float keep_p,
                            float keep_x, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, y, n, k0, k1, keep_p, keep_x, s);
    case 1:
      return launch<__nv_bfloat16>(x, y, n, k0, k1, keep_p, keep_x, s);
    case 2:
      return launch<__half>(x, y, n, k0, k1, keep_p, keep_x, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* apex_dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
