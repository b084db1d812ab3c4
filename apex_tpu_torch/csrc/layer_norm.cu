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
// exactly once, with 16-byte vector loads and stores (8 bf16 or fp16, or
// 4 fp32, per lane) whenever h allows it. For h <= 1024 rows stream through
// warps: the grid is sized to the warps the card keeps resident (not to
// the rows), and each warp walks rows at a stride of all of them, the
// whole row in registers, so both reduction passes run on registers and
// reduce through warp shuffles alone. A lane's columns are the same in
// every row, so it loads its gamma and beta once, as float4, into
// registers; and it issues the next row's 16-byte loads before this row's
// two reductions, so that every warp keeps a row's bytes in flight while
// it computes (a warp that loaded, reduced and stored one row and exited
// left device memory idle while all warps of a wave reduced at once). The
// arithmetic is the one-row-a-warp kernel's that this replaced: each lane's
// elements, the summing order and `warp_sum` unchanged, and the affine step
// rounded as two operations (the plain version's, never one fma): on the
// H100 its outputs are bitwise the one-row-a-warp kernel's. ptxas gives the
// 16-bit packs 127 registers (two 256-thread blocks an SM; 60 bytes of spill
// stores), fp32 rows 156 and single elements up to 243 (one block). Wider
// rows take one 256-thread block per row, which re-reads its row (from
// L1/L2, not device memory in practice) for each pass, reads gamma and beta
// as float4 and reduces through warp shuffles plus shared memory. Any row
// count works: the TPU version sent row counts that did not tile to XLA
// (`_tileable`, :206); here the grid covers every row.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "resident.cuh"

namespace {

template <typename T>
struct Pack {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte load
};

// n consecutive elements as they sit in memory: one 16-byte pack, or one
// element where h does not divide into packs
template <typename T, int n>
struct Raw {
  using type = uint4;
};
template <typename T>
struct Raw<T, 1> {
  using type = T;
};

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// n consecutive elements (n = 1 or the 16-byte pack) as loaded, widened to
// fp32.
template <typename T, int n>
__device__ __forceinline__ void unpack(const typename Raw<T, n>::type& r,
                                       float* out);

template <>
__device__ __forceinline__ void unpack<float, 4>(const uint4& r, float* out) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
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
__device__ __forceinline__ void unpack<__half, 8>(const uint4& r,
                                                  float* out) {
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

// the raw elements at p (one pack, or one element)
template <typename T, int n>
__device__ __forceinline__ typename Raw<T, n>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename Raw<T, n>::type*>(p);
}

// Load n consecutive elements (n = 1 or the 16-byte pack) as fp32.
template <typename T, int n>
__device__ __forceinline__ void load(const T* p, float* out) {
  unpack<T, n>(load_raw<T, n>(p), out);
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

// n (1 or a multiple of 4) consecutive fp32 weights, 16 bytes a load
template <int n>
__device__ __forceinline__ void load_w(const float* p, float* out) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n; i += 4) load<float, 4>(p + i, out + i);
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) out[i] = p[i];
  }
}

// x-hat [* w] [+ b], each factor present or not, each operation rounded on
// its own as the plain version's (never one fma)
__device__ __forceinline__ float affine(float xhat, const float* w,
                                        const float* b, float wv, float bv) {
  float y = xhat;
  if (w != nullptr) y = __fmul_rn(y, wv);
  if (b != nullptr) y = __fadd_rn(y, bv);
  return y;
}

constexpr int kWarpRowMax = 1024;  // widest row one warp keeps in registers
constexpr int kFwdWarps = 8;       // warps a block of the streaming forward

// Blocks of the streaming forward an SM should hold: two (128 registers a
// thread) for 16-bit packs, whose rows are half as many bytes, so that
// twice the warps keep as many bytes in flight; one for fp32 rows and for
// rows of single elements, whose registers do not fit in 128.
template <typename T, int N>
constexpr int fwd_min_blocks() {
  return sizeof(T) == 2 && N == Pack<T>::N ? 2 : 1;
}

// Rows streamed through warps: warp i of the grid takes rows i, i + W, i +
// 2W, ... (W the grid's warps), each row held in registers, the next row's
// loads issued once this row is unpacked, before its reductions. N
// elements per load (the 16-byte pack, or 1 when h does not divide into
// packs).
template <typename T, int N>
__global__ void __launch_bounds__(32 * kFwdWarps, fwd_min_blocks<T, N>())
    ln_fwd_warp(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ y,
                float* __restrict__ mean_out, float* __restrict__ rstd_out,
                int rows, int h, float eps, int rms) {
  constexpr int kSlots = kWarpRowMax / (32 * N);
  using R = typename Raw<T, N>::type;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kFwdWarps;
  int row = blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (row >= rows) return;

  // this lane's gamma and beta: its columns are the same in every row
  float wr[kSlots * N] = {}, br[kSlots * N] = {};
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = (s * 32 + lane) * N;
    if (c < h) {
      if (w != nullptr) load_w<N>(w + c, wr + s * N);
      if (b != nullptr) load_w<N>(b + c, br + s * N);
    }
  }
  // the raw packs of the row on its way
  R raw[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = (s * 32 + lane) * N;
    if (c < h) raw[s] = load_raw<T, N>(x + (size_t)row * h + c);
  }
  for (; row < rows; row += stride) {
    float v[kSlots * N];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = (s * 32 + lane) * N;
      if (c < h) unpack<T, N>(raw[s], v + s * N);
    }
    // the next row's bytes on their way before this row's reductions
    const int next = row + stride;
    if (next < rows) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = (s * 32 + lane) * N;
        if (c < h) raw[s] = load_raw<T, N>(x + (size_t)next * h + c);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = (s * 32 + lane) * N;
      if (c < h) {
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
    T* yr = y + (size_t)row * h;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = (s * 32 + lane) * N;
      if (c < h) {
        float o[N];
#pragma unroll
        for (int i = 0; i < N; ++i)
          o[i] = affine((v[s * N + i] - mean) * rstd, w, b, wr[s * N + i],
                        br[s * N + i]);
        store<T, N>(yr + c, o);
      }
    }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
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
    float wv[N] = {}, bv[N] = {};
    if (w != nullptr) load_w<N>(w + c, wv);
    if (b != nullptr) load_w<N>(b + c, bv);
    load<T, N>(xr + c, buf);
#pragma unroll
    for (int i = 0; i < N; ++i)
      buf[i] = affine((buf[i] - mean) * rstd, w, b, wv[i], bv[i]);
    store<T, N>(yr + c, buf);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Dispatch on dtype (0 fp32, 1 bf16, 2 fp16) and on whether h divides
// into 16-byte packs: F<T, N>::run(args...), or -1 for an unknown dtype
// (-2 from Fwd where the card's occupancy could not be read).
template <template <typename, int> class F, typename... A>
int dispatch(int dtype, int h, A... args) {
  if (dtype == 0)
    return h % Pack<float>::N == 0 ? F<float, Pack<float>::N>::run(args...)
                                   : F<float, 1>::run(args...);
  if (dtype == 1)
    return h % Pack<__nv_bfloat16>::N == 0
               ? F<__nv_bfloat16, Pack<__nv_bfloat16>::N>::run(args...)
               : F<__nv_bfloat16, 1>::run(args...);
  if (dtype == 2)
    return h % Pack<__half>::N == 0 ? F<__half, Pack<__half>::N>::run(args...)
                                    : F<__half, 1>::run(args...);
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
      // one warp a row up to what the card keeps resident; past it each
      // warp streams rows
      cudaError_t err = cudaSuccess;
      const int resident =
          resident_blocks<ln_fwd_warp<T, N>>(32 * kFwdWarps, 0, &err);
      if (resident <= 0) return -2;
      const int need = (rows + kFwdWarps - 1) / kFwdWarps;
      ln_fwd_warp<T, N><<<need < resident ? need : resident,
                          32 * kFwdWarps, 0, stream>>>(
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
// `_bwd_pallas` (:124; `pallas_call` at :130), and the sum of its per-tile
// dw/db partials that follows in XLA (:152). Same arithmetic, in fp32 from
// the forward's saved mean and rstd: xhat = (x - mean) * rstd, wg = g * w
// (g without affine), c1 = mean(wg), c2 = mean(wg * xhat), dx = rstd * (wg -
// c1 - xhat * c2) (RMSNorm: c1 = 0), written in x's dtype; dw = sum over
// rows of g * xhat and db = sum of g, fp32. No atomics: a call's results
// are the same from run to run on a given card.
//
// Bound on the card: memory. It reads x and g and writes dx once (3 * rows
// * h * sizeof(x) bytes: 50 MB at (8192, 1024) bf16, 15 us at 3.35 TB/s)
// against ~13 fp32 operations an element.
//
// Design: two kernels, launched one after the other on the caller's stream
// by `apex_ln_bwd`, and no PyTorch reduction after them.
//
// `ln_bwd_warp` (h <= 1024): a grid of the blocks the card keeps resident,
// each of eight warps walking rows at a stride of all of the grid's warps.
// A lane's columns are the same in every row, so it loads its gamma once,
// as float4, into registers, and keeps its columns' dw and db sums in
// registers across rows. Rows stream through a ring of kStages row
// buffers a warp in shared memory (4 for 16-bit rows, 3 for fp32: 136 and
// 198 KB a block, one block an SM): each lane copies its own 16-byte packs
// of x and g, and the row's mean and rstd, with `cp.async`, so kStages - 1
// rows of each warp are on their way while it reduces and writes another
// (device memory does not idle through the reductions), and no register is
// held by a byte in flight (gamma, the dw/db sums, x-hat and w * g take
// ~160 a lane, which leaves no room for a next row). A lane reads
// back only what it copied itself, so completion is per thread
// (`cp.async.wait_group`) and no lane waits on another. Rows whose h does
// not divide into 16-byte packs (one element a load) read device memory
// directly. At the end the block's eight warps join their dw/db sums in
// shared memory by a fixed tree, ((w0 + w4) + (w2 + w6)) + ((w1 + w5) +
// (w3 + w7)), three barriers deep, and warp 0 writes the block's partial
// row.
//
// `ln_bwd_block` (h > 1024): one 256-thread block a row at a time, each
// thread owning fixed columns of the dw/db sums in shared memory (8 h
// bytes, so h up to 29,056), gamma read as float4 once a pass.
//
// `ln_bwd_finish`: dw and db from the blocks' partial rows, each column
// summed in block order by one lane, from 32-column tiles that a block
// stages in shared memory with all of its loads in flight (a lane reading
// device memory row after row would wait on each load in turn). No
// PyTorch reduction follows the call.
//
// Bits: dx is bitwise the kernel's that this replaced. Each lane has the
// same columns, sums its slots in the same order and reduces by the same
// `warp_sum`, and every operation is written as that kernel's SASS did it
// (nvcc 12.8, sm_90a): FADD and FMUL for xhat, FMUL for wg, FADD into the
// wg sum, FFMA into the wg * xhat sum, and dx as FADD (wg - c1), FFMA (-
// xhat * c2 + that) and FMUL by rstd; the means are IEEE divisions. dw and
// db are summed in another order than before (rows per warp, the tree,
// blocks in order): not bitwise the old ones, but the same on every call.
//
// ptxas (-Xptxas -v, nvcc 12.8, sm_90a), registers a thread: before,
// `ln_bwd_warp` 158 (bf16 packs), 163 (fp16 packs), 161 (fp32 packs), 182-184
// (single elements) and `ln_bwd_block` 32-40, no spill. Now `ln_bwd_warp` 212
// (bf16 and fp16 packs), 219 (fp32 packs), 198-201 (single elements), no
// spill (one block an SM: the ring's shared memory allows no second);
// `ln_bwd_block` 32-48, no spill but for fp16 packs (12 bytes of spill
// stores); `ln_bwd_finish` 32 and 16 KB of shared memory.

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdMaxH = 29056;  // 8 h bytes of shared accumulators
constexpr int kFinishThreads = 256;
constexpr int kFinishRows = 128;  // partial rows a block stages at a time

// Rows a warp's ring holds (kStages - 1 on their way): more for 16-bit rows,
// whose buffers are half the size, so that a block's ring fits in 227 KB.
template <typename T>
__host__ __device__ constexpr int bwd_stages() {
  return sizeof(T) == 2 ? 4 : 3;
}

// Whether (T, N) rows stream through the ring: 16-byte packs only.
template <typename T, int N>
__host__ __device__ constexpr bool bwd_ring() {
  return N * sizeof(T) == 16;
}

// One ring stage: a row of x, a row of g, and each lane's copy of the
// row's mean and rstd.
template <typename T>
__host__ __device__ constexpr int bwd_stage_bytes() {
  return 2 * kWarpRowMax * (int)sizeof(T) + 32 * 2 * 4;
}

// The warp path's dynamic shared memory: the ring, or (without one, and
// after the rows either way) four warps' dw and db sums for the tree.
template <typename T, int N>
__host__ __device__ constexpr int bwd_warp_smem() {
  constexpr int tree = kBwdWarps / 2 * 2 * kWarpRowMax * 4;
  constexpr int ring =
      bwd_ring<T, N>() ? kBwdWarps * bwd_stages<T>() * bwd_stage_bytes<T>()
                       : 0;
  return ring > tree ? ring : tree;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n of this thread's copy groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// n (1 or a multiple of 4) consecutive fp32 values, 16 bytes a store
template <int n>
__device__ __forceinline__ void store_f(float* p, const float* v) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n; i += 4) store<float, 4>(p + i, v + i);
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) p[i] = v[i];
  }
}

// The element's x-hat and w * g, as the kernel this replaced rounded them.
__device__ __forceinline__ float bwd_xhat(float x, float mu, float rs) {
  return __fmul_rn(__fsub_rn(x, mu), rs);
}
__device__ __forceinline__ float bwd_dx(float xh, float wg, float c1,
                                        float c2, float rs) {
  return __fmul_rn(rs, __fmaf_rn(xh, -c2, __fsub_rn(wg, c1)));
}

// One row on one warp: this lane's columns of x and g at xr and gr (shared
// or device memory), its gamma in wr; adds g * x-hat and g to the lane's
// dw and db sums and writes its columns of dx at dr.
template <typename T, int N>
__device__ __forceinline__ void bwd_row(const T* xr, const T* gr, T* dr,
                                        const float* wr, bool affine,
                                        float mu, float rs, int lane, int h,
                                        int rms, float* dw_acc,
                                        float* db_acc) {
  constexpr int kSlots = kWarpRowMax / (32 * N);
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
        xh[k] = bwd_xhat(xv[i], mu, rs);
        wg[k] = affine ? __fmul_rn(gv[i], wr[k]) : gv[i];
        s1 = __fadd_rn(s1, wg[k]);
        s2 = __fmaf_rn(xh[k], wg[k], s2);
        dw_acc[k] = __fmaf_rn(gv[i], xh[k], dw_acc[k]);
        db_acc[k] = __fadd_rn(db_acc[k], gv[i]);
      }
    }
  }
  const float c1 = rms ? 0.f : __fdiv_rn(warp_sum(s1), (float)h);
  const float c2 = __fdiv_rn(warp_sum(s2), (float)h);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = (s * 32 + lane) * N;
    if (c < h) {
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        o[i] = bwd_dx(xh[s * N + i], wg[s * N + i], c1, c2, rs);
      store<T, N>(dr + c, o);
    }
  }
}

// Rows streamed through warps (warp i of the grid takes rows i, i + W, i +
// 2W, ..., W the grid's warps), then the block's partial row of dw | db
// into part[blockIdx.x] (2 h floats). N elements a load (the 16-byte pack,
// or 1 where h does not divide into packs).
template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ln_bwd_warp(const T* __restrict__ x, const T* __restrict__ g,
                const float* __restrict__ w, const float* __restrict__ mean,
                const float* __restrict__ rstd, T* __restrict__ dx,
                float* __restrict__ part, int rows, int h, int rms) {
  constexpr int kSlots = kWarpRowMax / (32 * N);
  constexpr int kStages = bwd_stages<T>();
  constexpr int kStageBytes = bwd_stage_bytes<T>();
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kBwdWarps;
  const int first = blockIdx.x * kBwdWarps + warp;

  // this lane's gamma: its columns are the same in every row
  float wr[kSlots * N] = {};
  float dw_acc[kSlots * N], db_acc[kSlots * N];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = (s * 32 + lane) * N;
    if (c < h && w != nullptr) load_w<N>(w + c, wr + s * N);
  }
#pragma unroll
  for (int k = 0; k < kSlots * N; ++k) dw_acc[k] = db_acc[k] = 0.f;

  if constexpr (bwd_ring<T, N>()) {
    unsigned char* ring = bwd_smem + warp * kStages * kStageBytes;
    // this lane's packs of row r, and the row's statistics, into stage st
    // (an empty group past the last row, so that every row is one group)
    auto fetch = [&](int r, int st) {
      if (r < rows) {
        T* sx = reinterpret_cast<T*>(ring + st * kStageBytes);
        T* sg = sx + kWarpRowMax;
        float* ss = reinterpret_cast<float*>(sg + kWarpRowMax) + 2 * lane;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int c = (s * 32 + lane) * N;
          if (c < h) {
            cp_async16(sx + c, x + (size_t)r * h + c);
            cp_async16(sg + c, g + (size_t)r * h + c);
          }
        }
        cp_async4(ss, mean + r);
        cp_async4(ss + 1, rstd + r);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) fetch(first + st * stride, st);
    int st = 0;
    for (int row = first; row < rows; row += stride) {
      // the stage read last (its values are used: nothing reads it now)
      // takes the row kStages - 1 strides ahead
      fetch(row + (kStages - 1) * stride, st == 0 ? kStages - 1 : st - 1);
      cp_async_wait<kStages - 1>();  // this row's group has landed
      const T* sx = reinterpret_cast<const T*>(ring + st * kStageBytes);
      const T* sg = sx + kWarpRowMax;
      const float* ss =
          reinterpret_cast<const float*>(sg + kWarpRowMax) + 2 * lane;
      bwd_row<T, N>(sx, sg, dx + (size_t)row * h, wr, w != nullptr, ss[0],
                    ss[1], lane, h, rms, dw_acc, db_acc);
      st = st + 1 == kStages ? 0 : st + 1;
    }
    cp_async_wait<0>();
  } else {
    for (int row = first; row < rows; row += stride)
      bwd_row<T, N>(x + (size_t)row * h, g + (size_t)row * h,
                    dx + (size_t)row * h, wr, w != nullptr, mean[row],
                    rstd[row], lane, h, rms, dw_acc, db_acc);
  }

  // the warps' sums by a fixed tree: warps [half, 2 half) hand theirs to
  // warps [0, half) through shared memory (the ring, now read)
  float* red = reinterpret_cast<float*>(bwd_smem);
#pragma unroll
  for (int half = kBwdWarps / 2; half >= 1; half >>= 1) {
    __syncthreads();
    if (warp >= half && warp < 2 * half) {
      float* o = red + (warp - half) * 2 * kWarpRowMax;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = (s * 32 + lane) * N;
        if (c < h) {
          store_f<N>(o + c, dw_acc + s * N);
          store_f<N>(o + kWarpRowMax + c, db_acc + s * N);
        }
      }
    }
    __syncthreads();
    if (warp < half) {
      const float* o = red + warp * 2 * kWarpRowMax;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = (s * 32 + lane) * N;
        if (c < h) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const int k = s * N + i;
            dw_acc[k] = __fadd_rn(dw_acc[k], o[c + i]);
            db_acc[k] = __fadd_rn(db_acc[k], o[kWarpRowMax + c + i]);
          }
        }
      }
    }
  }
  if (warp == 0) {
    float* pw = part + (size_t)blockIdx.x * 2 * h;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = (s * 32 + lane) * N;
      if (c < h) {
        store_f<N>(pw + c, dw_acc + s * N);
        store_f<N>(pw + h + c, db_acc + s * N);
      }
    }
  }
}

// One block a row at a time for rows wider than a warp holds; each pass
// re-reads the row (it stays in L1/L2 between passes).
template <typename T, int N>
__global__ void __launch_bounds__(kBlockThreads)
    ln_bwd_block(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ w, const float* __restrict__ mean,
                 const float* __restrict__ rstd, T* __restrict__ dx,
                 float* __restrict__ part, int rows, int h, int rms) {
  extern __shared__ float acc[];  // dw: [0, h), db: [h, 2h)
  __shared__ float red[32];
  float xb[N], gb[N], wv[N];
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
      if (w != nullptr) load_w<N>(w + c, wv);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xh = bwd_xhat(xb[i], mu, rs);
        const float wg = w != nullptr ? __fmul_rn(gb[i], wv[i]) : gb[i];
        s1 = __fadd_rn(s1, wg);
        s2 = __fmaf_rn(xh, wg, s2);
        acc[c + i] = __fmaf_rn(gb[i], xh, acc[c + i]);
        acc[h + c + i] = __fadd_rn(acc[h + c + i], gb[i]);
      }
    }
    const float c1 = rms ? 0.f : __fdiv_rn(block_sum(s1, red), (float)h);
    const float c2 = __fdiv_rn(block_sum(s2, red), (float)h);
    T* dr = dx + (size_t)row * h;
    for (int c = threadIdx.x * N; c < h; c += kBlockThreads * N) {
      load<T, N>(xr + c, xb);
      load<T, N>(gr + c, gb);
      if (w != nullptr) load_w<N>(w + c, wv);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float wg = w != nullptr ? __fmul_rn(gb[i], wv[i]) : gb[i];
        xb[i] = bwd_dx(bwd_xhat(xb[i], mu, rs), wg, c1, c2, rs);
      }
      store<T, N>(dr + c, xb);
    }
  }
  // each thread wrote only its own columns of acc: no barrier needed
  float* pw = part + (size_t)blockIdx.x * 2 * h;
  for (int c = threadIdx.x * N; c < h; c += kBlockThreads * N) {
    store_f<N>(pw + c, acc + c);
    store_f<N>(pw + h + c, acc + h + c);
  }
}

// dw[c] and db[c] = the sums of part[b][c] and part[b][h + c] over the
// blocks b = 0, 1, ..., in that order (cols = 2 h columns of the row
// kernel's partial rows). A block
// takes 32 columns: its eight warps stage up to 128 partial rows of them
// in shared memory at a time, all loads in flight at once, and one warp
// then adds them up a column a lane, row after row.
__global__ void __launch_bounds__(kFinishThreads)
    ln_bwd_finish(const float* __restrict__ part, float* __restrict__ dw,
                  float* __restrict__ db, int blocks, int h) {
  const int cols = 2 * h;
  __shared__ float tile[kFinishRows][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float sum = 0.f;
  for (int b0 = 0; b0 < blocks; b0 += kFinishRows) {
    const int n = blocks - b0 < kFinishRows ? blocks - b0 : kFinishRows;
    __syncthreads();  // the last chunk's rows are summed
    if (c < cols) {
#pragma unroll 16
      for (int r = wid; r < n; r += kFinishThreads / 32)
        tile[r][lane] = part[(size_t)(b0 + r) * cols + c];
    }
    __syncthreads();
    if (wid == 0 && c < cols) {
      int r = 0;
      if (b0 == 0) sum = tile[r++][lane];
      for (; r < n; ++r) sum = __fadd_rn(sum, tile[r][lane]);
    }
  }
  if (wid == 0 && c < cols) (c < h ? dw[c] : db[c - h]) = sum;
}

// Blocks the backward launches for (rows, h): what the card keeps
// resident, at most one per row (block path) or per eight rows.
template <typename T, int N>
struct BwdGrid {
  static int run(int rows, int h, cudaError_t* err) {
    if (h <= kWarpRowMax) {
      const int work = (rows + kBwdWarps - 1) / kBwdWarps;
      const int cap = resident_blocks<ln_bwd_warp<T, N>>(
          kBwdThreads, bwd_warp_smem<T, N>(), err);
      return work < cap ? work : cap;
    }
    const int cap = resident_blocks<ln_bwd_block<T, N>>(kBlockThreads, 8 * h,
                                                        err);
    return rows < cap ? rows : cap;
  }
};

template <typename T, int N>
struct Bwd {
  static int run(const void* x, const void* g, const float* w,
                 const float* mean, const float* rstd, void* dx, float* part,
                 float* dw, float* db, int blocks, int rows, int h, int rms,
                 cudaStream_t stream) {
    const T* xt = static_cast<const T*>(x);
    const T* gt = static_cast<const T*>(g);
    T* dt = static_cast<T*>(dx);
    if (h <= kWarpRowMax) {
      ln_bwd_warp<T, N><<<blocks, kBwdThreads, bwd_warp_smem<T, N>(),
                          stream>>>(xt, gt, w, mean, rstd, dt, part, rows, h,
                                    rms);
    } else {
      ln_bwd_block<T, N><<<blocks, kBlockThreads, 8 * h, stream>>>(
          xt, gt, w, mean, rstd, dt, part, rows, h, rms);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ln_bwd_finish<<<(2 * h + 31) / 32, kFinishThreads, 0, stream>>>(
        part, dw, db, blocks, h);
    return 0;
  }
};

}  // namespace

// x, y: (rows, h) contiguous, dtype 0 = fp32, 1 = bf16, 2 = fp16. w, b:
// (h,) fp32 or null (no affine / no bias). mean, rstd: (rows,) fp32.
// Pointers must be 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b,
                           void* y, void* mean, void* rstd, int rows, int h,
                           float eps, int rms, int dtype, void* stream) {
  if (rows == 0 || h == 0) return (int)cudaGetLastError();
  const int r = dispatch<Fwd>(
      dtype, h, x, static_cast<const float*>(w),
      static_cast<const float*>(b), y, static_cast<float*>(mean),
      static_cast<float*>(rstd), rows, h, eps, rms,
      static_cast<cudaStream_t>(stream));
  if (r == -2) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorUnknown);
  }
  if (r < 0) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* apex_ln_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The number of blocks `apex_ln_bwd` launches for (rows, h, dtype): the
// caller allocates (blocks, 2, h) fp32 partials. Returns a negative CUDA
// error code on failure (-1, cudaErrorInvalidValue, for an unknown dtype).
extern "C" int apex_ln_bwd_grid(int rows, int h, int dtype) {
  if (rows <= 0 || h <= 0 || h > kBwdMaxH) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int blocks = dispatch<BwdGrid>(dtype, h, rows, h, &err);
  if (err != cudaSuccess) return -(int)err;
  return blocks;
}

// x, g, dx: (rows, h) contiguous, dtype 0 = fp32, 1 = bf16, 2 = fp16. w:
// (h,) fp32 or null (no affine). mean, rstd: (rows,) fp32 from the forward.
// part: (blocks, 2, h) fp32 scratch, blocks from apex_ln_bwd_grid; dw,
// db: (h,) fp32. Launches the row kernel and `ln_bwd_finish`
// on stream. Returns cudaGetLastError() after the launches.
extern "C" int apex_ln_bwd(const void* x, const void* g, const void* w,
                           const void* mean, const void* rstd, void* dx,
                           void* part, void* dw, void* db, int blocks,
                           int rows, int h, int rms, int dtype,
                           void* stream) {
  if (rows == 0 || h == 0) return (int)cudaGetLastError();
  if (blocks <= 0 || h > kBwdMaxH) return (int)cudaErrorInvalidValue;
  const int r = dispatch<Bwd>(
      dtype, h, x, g, static_cast<const float*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(rstd), dx,
      static_cast<float*>(part), static_cast<float*>(dw),
      static_cast<float*>(db), blocks, rows, h, rms,
      static_cast<cudaStream_t>(stream));
  if (r < 0) return (int)cudaErrorInvalidValue;
  if (r > 0) return r;
  return (int)cudaGetLastError();
}
