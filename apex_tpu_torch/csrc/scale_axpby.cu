// Multi-tensor scale and axpby over flat buffers for Hopper (sm_90a).
//
// Replaces: apex_tpu/multi_tensor/engine.py `fused_elementwise` (kernel
// :243, `pallas_call` :400) instantiated with two functors of
// apex_tpu/multi_tensor/ops.py:
//
// - scale, `multi_tensor_scale` (:36-52):
//     out = cast(float(x) * scale)
//   `found` is set over the outputs after the cast, as the reference
//   flags them (an fp16 output that overflows counts);
// - axpby, `multi_tensor_axpby` (:55-71):
//     out = cast(float(x) * a + float(y) * b)
//   `found` is set over x, y or both (`check_x`, `check_y`).
//
// Inputs and outputs are fp32, bf16 or fp16 (dtype codes 0, 1, 2), each
// combination its own instantiation. Every operation is rounded on its
// own (`__fmul_rn`, `__fadd_rn`: nvcc cannot contract `x*a + y*b` into an
// FMA), in the order of the plain PyTorch version, and the casts round to
// nearest even as PyTorch's do, so both kernels are bitwise equal to it.
// The scale, a and b may live in device memory (a clip factor from a
// device norm): the kernel reads them by pointer, so no step waits on the
// host for them.
//
// Bound on the card: memory. scale reads x and writes out: 8 bytes an
// element fp32 -> fp32, 6 fp32 -> bf16; axpby reads x, y and writes out:
// 12 bytes fp32. At GPT-2 345M's 355.05 M elements that is 0.848 / 0.636
// ms and 1.272 ms at 3.35 TB/s, against one or two fp32 operations an
// element.
//
// Design: a grid-stride loop over groups of four elements, each group one
// 16-byte (fp32) or 8-byte (bf16, fp16) load per input and one store, each
// element read and written once; a ragged tail takes scalar loads. The
// grid is the occupancy query's blocks per SM times the SM count. The
// output may alias x (the in-place scale of a gradient). Any writer of the
// found flag stores the same 1.0: no atomics and no ordering.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct alignas(4 * sizeof(T)) Pack4 {
  T v[4];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
    scale_kernel(const In* x, Out* out, float* __restrict__ found, int64_t n,
                 float scale, const float* __restrict__ scale_ptr) {
  if (scale_ptr != nullptr) scale = *scale_ptr;
  bool bad = false;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t start = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = start; i < n4; i += stride) {
    const Pack4<In> xv = reinterpret_cast<const Pack4<In>*>(x)[i];
    Pack4<Out> ov;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ov.v[k] = from_f<Out>(__fmul_rn(to_f(xv.v[k]), scale));
      bad |= !isfinite(to_f(ov.v[k]));
    }
    reinterpret_cast<Pack4<Out>*>(out)[i] = ov;
  }
  for (int64_t i = n4 * 4 + start; i < n; i += stride) {
    const Out o = from_f<Out>(__fmul_rn(to_f(x[i]), scale));
    bad |= !isfinite(to_f(o));
    out[i] = o;
  }
  if (bad) *found = 1.0f;
}

template <typename X, typename Y, typename Out>
__global__ void __launch_bounds__(kThreads)
    axpby_kernel(const X* x, const Y* __restrict__ y, Out* out,
                 float* __restrict__ found, int64_t n, float a, float b,
                 bool check_x, bool check_y, const float* __restrict__ a_ptr,
                 const float* __restrict__ b_ptr) {
  if (a_ptr != nullptr) a = *a_ptr;
  if (b_ptr != nullptr) b = *b_ptr;
  bool bad = false;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t start = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = start; i < n4; i += stride) {
    const Pack4<X> xv = reinterpret_cast<const Pack4<X>*>(x)[i];
    const Pack4<Y> yv = reinterpret_cast<const Pack4<Y>*>(y)[i];
    Pack4<Out> ov;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xf = to_f(xv.v[k]), yf = to_f(yv.v[k]);
      bad |= (check_x && !isfinite(xf)) || (check_y && !isfinite(yf));
      ov.v[k] = from_f<Out>(__fadd_rn(__fmul_rn(xf, a), __fmul_rn(yf, b)));
    }
    reinterpret_cast<Pack4<Out>*>(out)[i] = ov;
  }
  for (int64_t i = n4 * 4 + start; i < n; i += stride) {
    const float xf = to_f(x[i]), yf = to_f(y[i]);
    bad |= (check_x && !isfinite(xf)) || (check_y && !isfinite(yf));
    out[i] = from_f<Out>(__fadd_rn(__fmul_rn(xf, a), __fmul_rn(yf, b)));
  }
  if (bad) *found = 1.0f;
}

template <typename Kernel>
int grid_for(Kernel kernel, int64_t n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t want = (n / 4 + kThreads - 1) / kThreads + 1;
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(want < cap ? want : cap);
}

// Calls f with a value of the C++ type of dtype code 0 (fp32), 1 (bf16)
// or 2 (fp16); any other code is refused.
template <typename F>
int with_dtype(int code, F f) {
  switch (code) {
    case 0:
      return f(float{});
    case 1:
      return f(__nv_bfloat16{});
    case 2:
      return f(__half{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: n elements of dtype x_dtype; out: n of out_dtype, x itself (in
// place, same dtype) or a separate buffer; both 16-byte aligned. found:
// one fp32 the caller zeroed. scale_ptr: the scale in device memory, or
// null to use scale. Returns cudaGetLastError() after the launch.
extern "C" int apex_scale(const void* x, void* out, void* found, int64_t n,
                          int x_dtype, int out_dtype, float scale,
                          const void* scale_ptr, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  return with_dtype(x_dtype, [&](auto xt) {
    using In = decltype(xt);
    return with_dtype(out_dtype, [&](auto ot) {
      using Out = decltype(ot);
      auto kernel = scale_kernel<In, Out>;
      kernel<<<grid_for(kernel, n), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
          static_cast<const In*>(x), static_cast<Out*>(out),
          static_cast<float*>(found), n, scale,
          static_cast<const float*>(scale_ptr));
      return (int)cudaGetLastError();
    });
  });
}

// As apex_scale for out = x * a + y * b; y has n elements of y_dtype;
// check_x / check_y: set found when x / y holds an inf or a nan; a_ptr /
// b_ptr: a and b in device memory, or null.
extern "C" int apex_axpby(const void* x, const void* y, void* out,
                          void* found, int64_t n, int x_dtype, int y_dtype,
                          int out_dtype, float a, float b, const void* a_ptr,
                          const void* b_ptr, int check_x, int check_y,
                          void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  return with_dtype(x_dtype, [&](auto xt) {
    using X = decltype(xt);
    return with_dtype(y_dtype, [&](auto yt) {
      using Y = decltype(yt);
      return with_dtype(out_dtype, [&](auto ot) {
        using Out = decltype(ot);
        auto kernel = axpby_kernel<X, Y, Out>;
        kernel<<<grid_for(kernel, n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const X*>(x), static_cast<const Y*>(y),
            static_cast<Out*>(out), static_cast<float*>(found), n, a, b,
            check_x != 0, check_y != 0, static_cast<const float*>(a_ptr),
            static_cast<const float*>(b_ptr));
        return (int)cudaGetLastError();
      });
    });
  });
}

extern "C" const char* apex_scale_axpby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
