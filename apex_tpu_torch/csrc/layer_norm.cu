// LayerNorm / RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/layer_norm.py `_fwd_kernel` (:45), launched by
// `_fwd_pallas` (:92; `pallas_call` at :101). Same arithmetic: x is
// widened to fp32, the mean is taken first and the variance of the
// centred values second (two passes over data already on chip, never
// E[x^2] - E[x]^2), then rstd = rsqrt(var + eps), y = (x - mean) * rstd
// [* w] [+ b] in fp32, rounded to x's dtype. RMSNorm uses mean = 0. Also
// writes the fp32 per-row mean and rstd the backward reads.
//
// Bound on the card: memory. The kernel reads x once and writes y once,
// 2 * rows * h * sizeof(x) bytes, against ~8 fp32 operations per
// element (4 per byte of bf16) — far below the ~20 operations per byte
// at which the H100's fp32 units (67 TFLOP/s) would be the limit.
//
// Design against that bound: each element is read from device memory
// exactly once, with 16-byte vector loads and stores (8 bf16 or 4 fp32
// per lane) whenever h allows it. For h <= 1024 one warp owns one row
// and keeps the whole row in registers, so both reduction passes run on
// registers and reduce through warp shuffles alone; four rows share a
// 128-thread block. Wider rows take one 256-thread block per row, which
// re-reads its row (from L1/L2, not device memory in practice) for each
// pass and reduces through warp shuffles plus shared memory. Any row
// count works: the TPU version sent row counts that did not tile to XLA
// (`_tileable`, :206); here the grid simply covers every row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over a 256-thread block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // `red` may still be read from the previous call
  if (lane == 0) red[wid] = v;
  __syncthreads();
  v = lane < (blockDim.x >> 5) ? red[lane] : 0.f;
  return warp_sum(v);
}

__device__ __forceinline__ float affine_at(float xhat, const float* w,
                                           const float* b, int i) {
  float y = xhat;
  if (w != nullptr) y *= __ldg(w + i);
  if (b != nullptr) y += __ldg(b + i);
  return y;
}

constexpr int kWarpRowMax = 1024;  // widest row one warp keeps in registers
constexpr int kRowsPerWarpBlock = 4;

// One warp per row, the row held in registers. N elements per load
// (the 16-byte pack, or 1 when h does not divide into packs).
template <typename T, int N>
__global__ void __launch_bounds__(32 * kRowsPerWarpBlock)
    ln_fwd_warp(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ y,
                float* __restrict__ mean_out, float* __restrict__ rstd_out,
                int rows, int h, float eps, int rms) {
  constexpr int kSlots = kWarpRowMax / (32 * N);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerWarpBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * h;
  T* yr = y + (size_t)row * h;

  float v[kSlots * N];
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = (s * 32 + lane) * N;
    if (c < h) {
      load<T, N>(xr + c, v + s * N);
#pragma unroll
      for (int i = 0; i < N; ++i) sum += v[s * N + i];
    }
  }
  const float mean = rms ? 0.f : warp_sum(sum) / (float)h;
  float sq = 0.f;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = (s * 32 + lane) * N;
    if (c < h) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float d = v[s * N + i] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)h + eps);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = (s * 32 + lane) * N;
    if (c < h) {
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        o[i] = affine_at((v[s * N + i] - mean) * rstd, w, b, c + i);
      store<T, N>(yr + c, o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

constexpr int kBlockThreads = 256;

// One block per row for rows wider than a warp holds; each pass re-reads
// the row (it stays in L1/L2 between passes).
template <typename T, int N>
__global__ void __launch_bounds__(kBlockThreads)
    ln_fwd_block(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, T* __restrict__ y,
                 float* __restrict__ mean_out, float* __restrict__ rstd_out,
                 int h, float eps, int rms) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;
  float buf[N];

  float sum = 0.f;
  for (int c = threadIdx.x * N; c < h; c += kBlockThreads * N) {
    load<T, N>(xr + c, buf);
#pragma unroll
    for (int i = 0; i < N; ++i) sum += buf[i];
  }
  const float mean = rms ? 0.f : block_sum(sum, red) / (float)h;
  float sq = 0.f;
  for (int c = threadIdx.x * N; c < h; c += kBlockThreads * N) {
    load<T, N>(xr + c, buf);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float d = buf[i] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) / (float)h + eps);
  for (int c = threadIdx.x * N; c < h; c += kBlockThreads * N) {
    load<T, N>(xr + c, buf);
#pragma unroll
    for (int i = 0; i < N; ++i)
      buf[i] = affine_at((buf[i] - mean) * rstd, w, b, c + i);
    store<T, N>(yr + c, buf);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Dispatch on dtype (0 fp32, 1 bf16) and on whether h divides into
// 16-byte packs: F<T, N>::run(args...), or -1 for an unknown dtype.
template <template <typename, int> class F, typename... A>
int dispatch(int dtype, int h, A... args) {
  if (dtype == 0)
    return h % Pack<float>::N == 0 ? F<float, Pack<float>::N>::run(args...)
                                   : F<float, 1>::run(args...);
  if (dtype == 1)
    return h % Pack<__nv_bfloat16>::N == 0
               ? F<__nv_bfloat16, Pack<__nv_bfloat16>::N>::run(args...)
               : F<__nv_bfloat16, 1>::run(args...);
  return -1;
}

template <typename T, int N>
struct Fwd {
  static int run(const void* x, const float* w, const float* b, void* y,
                 float* mean, float* rstd, int rows, int h, float eps,
                 int rms, cudaStream_t stream) {
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(y);
    if (h <= kWarpRowMax) {
      const int grid = (rows + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock;
      ln_fwd_warp<T, N><<<grid, 32 * kRowsPerWarpBlock, 0, stream>>>(
          xt, w, b, yt, mean, rstd, rows, h, eps, rms);
    } else {
      ln_fwd_block<T, N><<<rows, kBlockThreads, 0, stream>>>(
          xt, w, b, yt, mean, rstd, h, eps, rms);
    }
    return 0;
  }
};

// ---- backward ------------------------------------------------------------
//
// Replaces: apex_tpu/ops/layer_norm.py `_bwd_kernel` (:67), launched by
// `_bwd_pallas` (:124; `pallas_call` at :130). Same arithmetic, in fp32
// from the forward's saved mean and rstd: xhat = (x - mean) * rstd,
// wg = g * w (g without affine), c1 = mean(wg), c2 = mean(wg * xhat),
// dx = rstd * (wg - c1 - xhat * c2) (RMSNorm: c1 = 0), written in x's
// dtype; dw = sum over rows of g * xhat and db = sum of g, as per-block
// fp32 partials (blocks, h) that the caller sums afterwards, as the
// reference sums its per-tile partials in XLA (:152). No atomics, so the
// result is the same from run to run on a given card.
//
// Bound on the card: memory. It reads x and g and writes dx once
// (3 * rows * h * sizeof(x) bytes, ~50 MB at (8192, 1024) bf16, ~15 us
// at 3.35 TB/s); the partials add 2 * blocks * h * 4 bytes, written once
// and summed once.
//
// Design: the forward's row-per-warp scheme for h <= 1024. A block of
// eight warps walks rows with a grid stride; each lane keeps its columns'
// x-hat, w*g and its running dw/db partials in registers, so each row is
// read from device memory once and reduced by warp shuffles alone. At
// the end the eight warps add their partials into shared memory in a
// fixed order and the block writes one partial row. Wider rows take one
// 256-thread block per row at a time; each thread owns fixed columns of
// dw/db accumulators in shared memory (8 h bytes, so h up to 29,056).
// The grid is sized to the blocks the card keeps resident
// (`apex_ln_bwd_grid`), which bounds the partials' size.

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdMaxH = 29056;  // 8 h bytes of shared accumulators

template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads)
    ln_bwd_warp(const T* __restrict__ x, const T* __restrict__ g,
                const float* __restrict__ w, const float* __restrict__ mean,
                const float* __restrict__ rstd, T* __restrict__ dx,
                float* __restrict__ dw_part, float* __restrict__ db_part,
                int rows, int h, int rms) {
  constexpr int kSlots = kWarpRowMax / (32 * N);
  __shared__ float red_w[kWarpRowMax], red_b[kWarpRowMax];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float dw_acc[kSlots * N], db_acc[kSlots * N];
#pragma unroll
  for (int i = 0; i < kSlots * N; ++i) dw_acc[i] = db_acc[i] = 0.f;

  for (int row = blockIdx.x * kBwdWarps + warp; row < rows;
       row += gridDim.x * kBwdWarps) {
    const T* xr = x + (size_t)row * h;
    const T* gr = g + (size_t)row * h;
    const float mu = mean[row], rs = rstd[row];
    float xh[kSlots * N], wg[kSlots * N];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = (s * 32 + lane) * N;
      if (c < h) {
        float xv[N], gv[N];
        load<T, N>(xr + c, xv);
        load<T, N>(gr + c, gv);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int k = s * N + i;
          xh[k] = (xv[i] - mu) * rs;
          wg[k] = w != nullptr ? gv[i] * __ldg(w + c + i) : gv[i];
          s1 += wg[k];
          s2 += wg[k] * xh[k];
          dw_acc[k] += gv[i] * xh[k];
          db_acc[k] += gv[i];
        }
      }
    }
    const float c1 = rms ? 0.f : warp_sum(s1) / (float)h;
    const float c2 = warp_sum(s2) / (float)h;
    T* dr = dx + (size_t)row * h;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = (s * 32 + lane) * N;
      if (c < h) {
        float o[N];
#pragma unroll
        for (int i = 0; i < N; ++i)
          o[i] = rs * (wg[s * N + i] - c1 - xh[s * N + i] * c2);
        store<T, N>(dr + c, o);
      }
    }
  }

  // the warps' partials into shared memory, one warp after another
  for (int wi = 0; wi < kBwdWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = (s * 32 + lane) * N;
        if (c < h) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const int k = s * N + i;
            red_w[c + i] = wi == 0 ? dw_acc[k] : red_w[c + i] + dw_acc[k];
            red_b[c + i] = wi == 0 ? db_acc[k] : red_b[c + i] + db_acc[k];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < h; c += kBwdThreads) {
    dw_part[(size_t)blockIdx.x * h + c] = red_w[c];
    db_part[(size_t)blockIdx.x * h + c] = red_b[c];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kBlockThreads)
    ln_bwd_block(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ w, const float* __restrict__ mean,
                 const float* __restrict__ rstd, T* __restrict__ dx,
                 float* __restrict__ dw_part, float* __restrict__ db_part,
                 int rows, int h, int rms) {
  extern __shared__ float acc[];  // dw: [0, h), db: [h, 2h)
  __shared__ float red[32];
  float xb[N], gb[N];
  for (int c = threadIdx.x * N; c < h; c += kBlockThreads * N) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[c + i] = acc[h + c + i] = 0.f;
  }

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + (size_t)row * h;
    const T* gr = g + (size_t)row * h;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x * N; c < h; c += kBlockThreads * N) {
      load<T, N>(xr + c, xb);
      load<T, N>(gr + c, gb);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xh = (xb[i] - mu) * rs;
        const float wg = w != nullptr ? gb[i] * __ldg(w + c + i) : gb[i];
        s1 += wg;
        s2 += wg * xh;
        acc[c + i] += gb[i] * xh;
        acc[h + c + i] += gb[i];
      }
    }
    const float c1 = rms ? 0.f : block_sum(s1, red) / (float)h;
    const float c2 = block_sum(s2, red) / (float)h;
    T* dr = dx + (size_t)row * h;
    for (int c = threadIdx.x * N; c < h; c += kBlockThreads * N) {
      load<T, N>(xr + c, xb);
      load<T, N>(gr + c, gb);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xh = (xb[i] - mu) * rs;
        const float wg = w != nullptr ? gb[i] * __ldg(w + c + i) : gb[i];
        xb[i] = rs * (wg - c1 - xh * c2);
      }
      store<T, N>(dr + c, xb);
    }
  }
  // each thread wrote only its own columns of acc: no barrier needed
  for (int c = threadIdx.x * N; c < h; c += kBlockThreads * N) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      dw_part[(size_t)blockIdx.x * h + c + i] = acc[c + i];
      db_part[(size_t)blockIdx.x * h + c + i] = acc[h + c + i];
    }
  }
}

// Blocks the backward launches for (rows, h): what the card keeps
// resident, at most one per row (block path) or per eight rows.
template <typename T, int N>
struct BwdGrid {
  static int run(int rows, int h, cudaError_t* err) {
    int dev = 0, sms = 0, per_sm = 0;
    *err = cudaGetDevice(&dev);
    if (*err == cudaSuccess)
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
    if (*err != cudaSuccess) return 0;
    int work;
    if (h <= kWarpRowMax) {
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ln_bwd_warp<T, N>, kBwdThreads, 0);
      work = (rows + kBwdWarps - 1) / kBwdWarps;
    } else {
      const int bytes = 8 * h;
      *err = cudaFuncSetAttribute(ln_bwd_block<T, N>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bytes);
      if (*err == cudaSuccess)
        *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ln_bwd_block<T, N>, kBlockThreads, bytes);
      work = rows;
    }
    const int cap = sms * (per_sm > 0 ? per_sm : 1);
    return work < cap ? work : cap;
  }
};

template <typename T, int N>
struct Bwd {
  static int run(const void* x, const void* g, const float* w,
                 const float* mean, const float* rstd, void* dx,
                 float* dw_part, float* db_part, int blocks, int rows, int h,
                 int rms, cudaStream_t stream) {
    const T* xt = static_cast<const T*>(x);
    const T* gt = static_cast<const T*>(g);
    T* dt = static_cast<T*>(dx);
    if (h <= kWarpRowMax) {
      ln_bwd_warp<T, N><<<blocks, kBwdThreads, 0, stream>>>(
          xt, gt, w, mean, rstd, dt, dw_part, db_part, rows, h, rms);
    } else {
      ln_bwd_block<T, N><<<blocks, kBlockThreads, 8 * h, stream>>>(
          xt, gt, w, mean, rstd, dt, dw_part, db_part, rows, h, rms);
    }
    return 0;
  }
};

}  // namespace

// x, y: (rows, h) contiguous, dtype 0 = fp32, 1 = bf16. w, b: (h,) fp32
// or null (no affine / no bias). mean, rstd: (rows,) fp32. Pointers must
// be 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b,
                           void* y, void* mean, void* rstd, int rows, int h,
                           float eps, int rms, int dtype, void* stream) {
  if (rows == 0 || h == 0) return (int)cudaGetLastError();
  const int r = dispatch<Fwd>(
      dtype, h, x, static_cast<const float*>(w),
      static_cast<const float*>(b), y, static_cast<float*>(mean),
      static_cast<float*>(rstd), rows, h, eps, rms,
      static_cast<cudaStream_t>(stream));
  if (r < 0) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* apex_ln_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The number of blocks `apex_ln_bwd` launches for (rows, h, dtype): the
// caller allocates (blocks, h) fp32 partials for dw and for db. Returns
// a negative CUDA error code on failure (-1, cudaErrorInvalidValue, for
// an unknown dtype).
extern "C" int apex_ln_bwd_grid(int rows, int h, int dtype) {
  if (rows <= 0 || h <= 0 || h > kBwdMaxH) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int blocks = dispatch<BwdGrid>(dtype, h, rows, h, &err);
  if (err != cudaSuccess) return -(int)err;
  return blocks;
}

// x, g, dx: (rows, h) contiguous, dtype 0 = fp32, 1 = bf16. w: (h,) fp32
// or null (no affine). mean, rstd: (rows,) fp32 from the forward.
// dw_part, db_part: (blocks, h) fp32, blocks from apex_ln_bwd_grid.
// Returns cudaGetLastError() after the launch.
extern "C" int apex_ln_bwd(const void* x, const void* g, const void* w,
                           const void* mean, const void* rstd, void* dx,
                           void* dw_part, void* db_part, int blocks, int rows,
                           int h, int rms, int dtype, void* stream) {
  if (rows == 0 || h == 0) return (int)cudaGetLastError();
  if (blocks <= 0 || h > kBwdMaxH) return (int)cudaErrorInvalidValue;
  const int r = dispatch<Bwd>(
      dtype, h, x, g, static_cast<const float*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(rstd), dx,
      static_cast<float*>(dw_part), static_cast<float*>(db_part), blocks,
      rows, h, rms, static_cast<cudaStream_t>(stream));
  if (r < 0) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
