// Softmax cross-entropy with label smoothing, forward and backward, for
// Hopper (sm_90a).
//
// Replaces, in apex_tpu/ops/xentropy.py:
//   `_fwd_kernel` (:32; `pallas_call` at :71)  -> apex_xentropy_fwd: per row
//       of (T, K) logits, in fp32, lse = max + log(sum(exp(x - max))) and
//       loss = lse - (1 - s) * x[y] - s * mean(x); writes only loss and lse;
//   `_bwd_kernel` (:47; `pallas_call` at :100) -> apex_xentropy_bwd:
//       dx = g * (exp(x - lse) - (1 - s) * onehot(y) - s / K), recomputed
//       from the saved lse, rounded to the logits' dtype.
// A label outside [0, K) picks x[y] = 0 and a zero one-hot, as the Pallas
// kernels' column compare does.
//
// Bound on the card: memory. The forward reads the logits once (1.65 GB at
// GPT-2's (8192, 50304) in fp32) and does ~6 fp32 operations and one exp
// per logit; the backward reads them once and writes dx once. Both sit
// far below the ~20 operations per byte at which the fp32 units would
// bound them (67 TFLOP/s against 3.35 TB/s: the H100 SXM data sheet, at
// its full 700 W power limit).
//
// Design against that bound. The TPU kernel holds a (tile, K) block in
// VMEM and makes four passes over it (max, exp-sum, target pick, mean).
// Here the forward reads each row once: one 256-thread block per row,
// every thread walking the row in 16-byte packs (4 fp32 or 8 bf16/fp16
// values), four packs in flight, keeping an online logsumexp (a running
// max and a sum rescaled when the max grows) and the running sum of x.
// The (max, sum) pairs and the sums of x are combined across the block in
// a fixed order (warp shuffles, then warp 0 over the eight warps), so the
// result does not change from run to run; x[y] is one load by thread 0.
// Rows whose start is not 16-byte aligned (K not a multiple of the pack)
// take their head and tail elements one at a time. The backward is
// elementwise: a grid of (row, chunk of 4 packs a thread) blocks, 16-byte
// loads and stores, the same head/tail split. Its operations follow the
// plain version's order, each rounded on its own (`__fsub_rn`,
// `__fmul_rn`; `expf`, not `__expf`), with (1 - s) and s / K rounded to
// fp32 once on the host: given the same lse, fp32 dx is bitwise the plain
// version's on the card.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // packs a thread has in flight

template <typename T>
struct Pack {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte load
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ void load_pack(const T* p, float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < Pack<T>::N; ++i) out[i] = to_float(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_pack(T* p, const float* in) {
  uint4 r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < Pack<T>::N; ++i) e[i] = from_float<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = r;
}

// Where a row's 16-byte packs start: `head` elements before the first
// aligned address, then `body` whole packs, then the tail.
template <typename T>
struct Split {
  int head, body, tail_start;
  __device__ __forceinline__ Split(const T* row, int k) {
    const int mis = (int)(reinterpret_cast<uintptr_t>(row) & 15u);
    head = mis == 0 ? 0 : (16 - mis) / (int)sizeof(T);
    if (head > k) head = k;
    body = (k - head) / Pack<T>::N;
    tail_start = head + body * Pack<T>::N;
  }
};

// Online logsumexp: fold n values into (m, s) — the running max and the
// sum of exp(x - m) — and their plain sum into sx.
template <int n>
__device__ __forceinline__ void fold(float& m, float& s, float& sx,
                                     const float* v) {
  float vm = v[0];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    sx = __fadd_rn(sx, v[i]);
    vm = fmaxf(vm, v[i]);
  }
  const float nm = fmaxf(m, vm);
  if (nm == -INFINITY) return;  // every value so far is -inf
  float acc = m == -INFINITY ? 0.f : __fmul_rn(s, expf(__fsub_rn(m, nm)));
#pragma unroll
  for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, expf(__fsub_rn(v[i], nm)));
  s = acc;
  m = nm;
}

// (m, s) of two disjoint parts of a row.
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float nm = fmaxf(m, m2);
  if (nm == -INFINITY) {
    m = nm;
    s = 0.f;
    return;
  }
  const float a = m == -INFINITY ? 0.f : __fmul_rn(s, expf(__fsub_rn(m, nm)));
  const float b =
      m2 == -INFINITY ? 0.f : __fmul_rn(s2, expf(__fsub_rn(m2, nm)));
  s = __fadd_rn(a, b);
  m = nm;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xentropy_fwd(const T* __restrict__ x, const int* __restrict__ labels,
                 float* __restrict__ loss, float* __restrict__ lse, int k,
                 float one_minus_s, float s, int smooth) {
  constexpr int N = Pack<T>::N;
  __shared__ float red_m[kWarps], red_s[kWarps], red_x[kWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * k;
  const Split<T> sp(xr, k);
  const int tid = threadIdx.x;

  float m = -INFINITY, sm = 0.f, sx = 0.f;
  if (tid < sp.head) {
    const float v = to_float(xr[tid]);
    fold<1>(m, sm, sx, &v);
  }
  const T* body = xr + sp.head;
  int p = tid;
  for (; p + (kUnroll - 1) * kThreads < sp.body; p += kUnroll * kThreads) {
    float v[kUnroll * N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_pack<T>(body + (int64_t)(p + u * kThreads) * N, v + u * N);
    fold<kUnroll * N>(m, sm, sx, v);
  }
  for (; p < sp.body; p += kThreads) {
    float v[N];
    load_pack<T>(body + (int64_t)p * N, v);
    fold<N>(m, sm, sx, v);
  }
  if (sp.tail_start + tid < k) {
    const float v = to_float(xr[sp.tail_start + tid]);
    fold<1>(m, sm, sx, &v);
  }

  // fixed-order combination: down the warp, then warp 0 over the warps
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_down_sync(0xffffffffu, m, o);
    const float s2 = __shfl_down_sync(0xffffffffu, sm, o);
    const float x2 = __shfl_down_sync(0xffffffffu, sx, o);
    combine(m, sm, m2, s2);
    sx = __fadd_rn(sx, x2);
  }
  const int lane = tid & 31, wid = tid >> 5;
  if (lane == 0) {
    red_m[wid] = m;
    red_s[wid] = sm;
    red_x[wid] = sx;
  }
  __syncthreads();
  if (tid == 0) {
    m = red_m[0];
    sm = red_s[0];
    sx = red_x[0];
    for (int w = 1; w < kWarps; ++w) {
      combine(m, sm, red_m[w], red_s[w]);
      sx = __fadd_rn(sx, red_x[w]);
    }
    const float l = __fadd_rn(logf(sm), m);
    const int y = labels[row];
    const float xt = (y >= 0 && y < k) ? to_float(xr[y]) : 0.f;
    float out = __fsub_rn(l, __fmul_rn(one_minus_s, xt));
    if (smooth) out = __fsub_rn(out, __fmul_rn(s, __fdiv_rn(sx, (float)k)));
    loss[row] = out;
    lse[row] = l;
  }
}

// One element of dx, in the plain version's order of operations.
__device__ __forceinline__ float dx_of(float v, int col, int y, float l,
                                       float g, float one_minus_s,
                                       float s_over_k) {
  const float p = expf(__fsub_rn(v, l));
  const float hot = col == y ? one_minus_s : 0.f;  // (1 - s) * onehot
  return __fmul_rn(g, __fsub_rn(__fsub_rn(p, hot), s_over_k));
}

constexpr int kBwdPacks = kThreads * kUnroll;  // packs a block covers

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xentropy_bwd(const T* __restrict__ x, const int* __restrict__ labels,
                 const float* __restrict__ lse, const float* __restrict__ g,
                 T* __restrict__ dx, int k, float one_minus_s,
                 float s_over_k) {
  constexpr int N = Pack<T>::N;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * k;
  T* dr = dx + row * k;
  const Split<T> sp(xr, k);
  const int y = labels[row];
  const float l = lse[row];
  const float gr = g[row];
  const int tid = threadIdx.x;

  if (blockIdx.y == 0) {
    if (tid < sp.head)
      dr[tid] = from_float<T>(dx_of(to_float(xr[tid]), tid, y, l, gr,
                                    one_minus_s, s_over_k));
    const int c = sp.tail_start + tid;
    if (c < k)
      dr[c] = from_float<T>(
          dx_of(to_float(xr[c]), c, y, l, gr, one_minus_s, s_over_k));
  }
  const int first = blockIdx.y * kBwdPacks + tid;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = first + u * kThreads;
    if (p >= sp.body) break;
    const int c0 = sp.head + p * N;
    float v[N];
    load_pack<T>(xr + c0, v);
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = dx_of(v[i], c0 + i, y, l, gr, one_minus_s, s_over_k);
    store_pack<T>(dr + c0, v);
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const int* labels, float* loss,
                       float* lse, int64_t rows, int k, float one_minus_s,
                       float s, int smooth, cudaStream_t stream) {
  if (rows > INT_MAX) return cudaErrorInvalidValue;
  xentropy_fwd<T><<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), labels, loss, lse, k, one_minus_s, s, smooth);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const int* labels, const float* lse,
                       const float* g, void* dx, int64_t rows, int k,
                       float one_minus_s, float s_over_k,
                       cudaStream_t stream) {
  if (rows > INT_MAX) return cudaErrorInvalidValue;
  const int packs = k / Pack<T>::N + 1;  // at most this many in the body
  const int chunks = (packs + kBwdPacks - 1) / kBwdPacks;
  if (chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)rows, (unsigned)chunks);
  xentropy_bwd<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), labels, lse, g, static_cast<T*>(dx), k,
      one_minus_s, s_over_k);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous (rows, k) logits, dtype 0 = fp32, 1 = bf16, 2 = fp16, 16-byte
// aligned; labels: (rows,) int32; loss, lse: (rows,) fp32. one_minus_s and s
// are fp32(1 - smoothing) and fp32(smoothing); the mean term is taken only
// when smooth != 0. Returns cudaGetLastError() after the launch.
extern "C" int apex_xentropy_fwd(const void* x, const int* labels, float* loss,
                                 float* lse, int64_t rows, int k,
                                 float one_minus_s, float s, int smooth,
                                 int dtype, void* stream) {
  if (rows == 0) return (int)cudaGetLastError();
  if (rows < 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_fwd<float>(x, labels, loss, lse, rows, k,
                                    one_minus_s, s, smooth, st);
    case 1:
      return (int)launch_fwd<__nv_bfloat16>(x, labels, loss, lse, rows, k,
                                            one_minus_s, s, smooth, st);
    case 2:
      return (int)launch_fwd<__half>(x, labels, loss, lse, rows, k,
                                     one_minus_s, s, smooth, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x, dx: contiguous (rows, k), one dtype (as above), 16-byte aligned;
// labels (rows,) int32; lse, g: (rows,) fp32. one_minus_s and s_over_k are
// fp32(1 - smoothing) and fp32(smoothing / k), each rounded once from
// double. Returns cudaGetLastError() after the launch.
extern "C" int apex_xentropy_bwd(const void* x, const int* labels,
                                 const float* lse, const float* g, void* dx,
                                 int64_t rows, int k, float one_minus_s,
                                 float s_over_k, int dtype, void* stream) {
  if (rows == 0) return (int)cudaGetLastError();
  if (rows < 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_bwd<float>(x, labels, lse, g, dx, rows, k,
                                    one_minus_s, s_over_k, st);
    case 1:
      return (int)launch_bwd<__nv_bfloat16>(x, labels, lse, g, dx, rows, k,
                                            one_minus_s, s_over_k, st);
    case 2:
      return (int)launch_bwd<__half>(x, labels, lse, g, dx, rows, k,
                                     one_minus_s, s_over_k, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* apex_xentropy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
