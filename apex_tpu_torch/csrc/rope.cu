// Rotary positional embedding, forward and backward, for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/rope.py `_rope_kernel` (:58; reached through
// `_rope_pallas` :72, `pallas_call` at :91): over positions n of t (n,
// rows, d), out = t_rot * cos + rotate_half(t_rot) * sin in fp32 on the
// first rot channels (the halves split, not interleaved: rotate_half(t) =
// [-t2, t1]), the remaining d - rot channels copied, the result rounded to
// t's dtype. The backward is the same rotation with -sin (`_rope_cached_bwd`
// :129-133): a flag negates sin in the kernel, bitwise the same as passing
// -sin. cos and sin are fp32 tables read through element strides: a
// position stride and one per middle dimension of t, 0 where the table
// broadcasts (the reference sends tables that vary beyond the position
// axis to XLA, `_rope_any` :110-116; here the same kernel reads them, as
// the flash bias is read); for the packed
// varlen (thd) layout the kernel finds each token's position itself, by a
// binary search of cu_seqlens (the reference's searchsorted, :171-174),
// and reads that row of the cos(freqs) and sin(freqs) tables, which is
// bitwise the reference's cos(freqs[pos]) without a (tokens, rot) table.
//
// Bound on the card: memory. t is read once and written once (134 MB at
// Llama-2-7B's (4096, 2, 32, 128) in bf16), plus the tables; three fp32
// operations per channel.
//
// Design against that bound. One block row per position (grid.x), the
// position's rows split over grid.y: cos and sin of a position are read
// through L1 (__ldg) and reused by every (batch, head) row of it (a table
// that varies along a middle dimension is offset per row). Each
// thread owns V channel pairs (i, i + rot/2) of one row, loaded as two
// vectors of up to 16 bytes, so rotate_half happens in registers; the
// pass-through channels are copied V at a time as raw bytes. V is the
// largest of 8, 4, 2, 1 that the dtype's 16 bytes, rot/2 and d allow.
// Each product and sum is rounded on its own (`__fmul_rn`, `__fadd_rn`),
// in the plain version's order, so fp32 output is bitwise the plain
// version's on the card.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 2;  // work items a thread takes, on average

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

// An unsigned type of `bytes` bytes, for one vector load or store.
template <int bytes>
struct Raw;
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<16> {
  using type = uint4;
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float* out) {
  using R = typename Raw<(int)(V * sizeof(T))>::type;
  const R r = *reinterpret_cast<const R*>(p);
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_float(e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* in) {
  using R = typename Raw<(int)(V * sizeof(T))>::type;
  R r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_float<T>(in[i]);
  *reinterpret_cast<R*>(p) = r;
}

template <typename T, int V>
__device__ __forceinline__ void copy_raw(const T* src, T* dst) {
  using R = typename Raw<(int)(V * sizeof(T))>::type;
  *reinterpret_cast<R*>(dst) = *reinterpret_cast<const R*>(src);
}

// V fp32 table values through the read-only cache.
template <int V>
__device__ __forceinline__ void load_table(const float* p, float* out) {
  if constexpr (V == 1) {
    out[0] = __ldg(p);
  } else if constexpr (V == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = a.x;
    out[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
      out[i] = a.x;
      out[i + 1] = a.y;
      out[i + 2] = a.z;
      out[i + 3] = a.w;
    }
  }
}

// The table row of token n: n itself, or (thd) n's offset in its
// sequence — seq = (number of cu_seqlens entries <= n) - 1, wrapping to
// the last entry when negative, as the reference's indexing does; a row
// outside the table wraps when negative and is then clamped, as a JAX
// gather index is.
__device__ __forceinline__ int table_row(int n, const int* cu, int nseq,
                                         int rows_in_table) {
  if (cu == nullptr) return n;
  int lo = 0, hi = nseq + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cu + mid) <= n)
      lo = mid + 1;
    else
      hi = mid;
  }
  int seq = lo - 1;
  if (seq < 0) seq += nseq + 1;
  int pos = n - __ldg(cu + seq);
  if (pos < 0) pos += rows_in_table;
  return pos < 0 ? 0 : (pos >= rows_in_table ? rows_in_table - 1 : pos);
}

// The tables' element strides: along positions (`pos`), and along up to
// three middle dimensions of t (sizes `size`, row-major, the last fastest;
// 0 where the table broadcasts). `nmid` = 0: every row reads one table row.
struct Strides {
  long long pos;
  int nmid;
  int size[3];
  long long mid[3];
};

// The table offset of row r of t's flattened middle dimensions.
__device__ __forceinline__ long long mid_offset(const Strides& ts, int r) {
  long long o = 0;
  for (int i = ts.nmid - 1; i >= 0; --i) {
    o += (long long)(r % ts.size[i]) * ts.mid[i];
    r /= ts.size[i];
  }
  return o;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const T* __restrict__ t, const float* __restrict__ cos_t,
                const float* __restrict__ sin_t, const int* __restrict__ cu,
                int nseq, int table_rows, Strides ts, T* __restrict__ out,
                int rows, int d, int rot, int negate) {
  const int n = blockIdx.x;
  const int pos = table_row(n, cu, nseq, table_rows);
  const float* cs0 = cos_t + (int64_t)pos * ts.pos;
  const float* sn0 = sin_t + (int64_t)pos * ts.pos;
  const int half = rot >> 1;
  const int rot_items = half / V;
  const int items = rot_items + (d - rot) / V;
  const int64_t total = (int64_t)rows * items;
  const int64_t base = (int64_t)n * rows * d;
  for (int64_t w = (int64_t)blockIdx.y * kThreads + threadIdx.x; w < total;
       w += (int64_t)gridDim.y * kThreads) {
    const int r = (int)(w / items);
    const int i = (int)(w - (int64_t)r * items);
    const T* src = t + base + (int64_t)r * d;
    T* dst = out + base + (int64_t)r * d;
    if (i < rot_items) {
      const int j = i * V;
      const long long mo = ts.nmid ? mid_offset(ts, r) : 0;
      const float* cs = cs0 + mo;
      const float* sn = sn0 + mo;
      float x1[V], x2[V], c1[V], c2[V], s1[V], s2[V];
      load<T, V>(src + j, x1);
      load<T, V>(src + half + j, x2);
      load_table<V>(cs + j, c1);
      load_table<V>(cs + half + j, c2);
      load_table<V>(sn + j, s1);
      load_table<V>(sn + half + j, s2);
      float o1[V], o2[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float a1 = negate ? -s1[e] : s1[e];
        const float a2 = negate ? -s2[e] : s2[e];
        // first half: x1 * c + (-x2) * s; second half: x2 * c + x1 * s
        o1[e] = __fadd_rn(__fmul_rn(x1[e], c1[e]), __fmul_rn(-x2[e], a1));
        o2[e] = __fadd_rn(__fmul_rn(x2[e], c2[e]), __fmul_rn(x1[e], a2));
      }
      store<T, V>(dst + j, o1);
      store<T, V>(dst + half + j, o2);
    } else {
      const int j = rot + (i - rot_items) * V;
      copy_raw<T, V>(src + j, dst + j);
    }
  }
}

template <typename T, int V>
cudaError_t launch(const void* t, const float* cos_t, const float* sin_t,
                   const int* cu, int nseq, int table_rows,
                   const Strides& ts, void* out, int64_t n, int rows, int d,
                   int rot, int negate, cudaStream_t stream) {
  if (n > INT_MAX) return cudaErrorInvalidValue;
  const int items = rot / 2 / V + (d - rot) / V;
  const int64_t per_block = (int64_t)kThreads * kItemsPerThread;
  int64_t gy = ((int64_t)rows * items + per_block - 1) / per_block;
  if (gy < 1) gy = 1;
  if (gy > 65535) gy = 65535;
  const dim3 grid((unsigned)n, (unsigned)gy);
  rope_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(t), cos_t, sin_t, cu, nseq, table_rows, ts,
      static_cast<T*>(out), rows, d, rot, negate);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(const void* t, const float* cos_t,
                       const float* sin_t, const int* cu, int nseq,
                       int table_rows, const Strides& ts, void* out,
                       int64_t n, int rows, int d, int rot, int negate,
                       cudaStream_t stream) {
  constexpr int kMax = 16 / sizeof(T);
  const int half = rot / 2;
  // a vector of V table values must stay aligned at every table offset
  auto strides_fit = [&](int v) {
    bool ok = ts.pos % v == 0;
    for (int i = 0; i < ts.nmid; ++i) ok = ok && ts.mid[i] % v == 0;
    return ok;
  };
  auto fits = [&](int v) {
    return v <= kMax && half % v == 0 && d % v == 0 && strides_fit(v);
  };
  if constexpr (kMax >= 8) {
    if (fits(8))
      return launch<T, 8>(t, cos_t, sin_t, cu, nseq, table_rows, ts, out,
                          n, rows, d, rot, negate, stream);
  }
  if (fits(4))
    return launch<T, 4>(t, cos_t, sin_t, cu, nseq, table_rows, ts, out, n,
                        rows, d, rot, negate, stream);
  if (fits(2))
    return launch<T, 2>(t, cos_t, sin_t, cu, nseq, table_rows, ts, out, n,
                        rows, d, rot, negate, stream);
  return launch<T, 1>(t, cos_t, sin_t, cu, nseq, table_rows, ts, out, n,
                      rows, d, rot, negate, stream);
}

}  // namespace

// t, out: contiguous (n, rows, d), dtype 0 = fp32, 1 = bf16, 2 = fp16,
// 16-byte aligned; cos_t, sin_t: fp32 tables, 16-byte aligned, with one
// layout: element (position p, middle index r, channel c) at p * tsn +
// mid_offset(r) + c, where r runs over nmid (0-3) middle dimensions of t
// of sizes m0, m1, m2 (their product is rows) with table strides st0,
// st1, st2 (0 where the table broadcasts); rot even and <= d. cu: null
// (position n reads table row n, or row 0 everywhere with tsn = 0) or
// (nseq + 1,) int32 cumulative sequence starts (thd; table_rows rows).
// negate != 0 rotates by -sin (the backward). Returns cudaGetLastError()
// after the launch.
extern "C" int apex_rope(const void* t, const float* cos_t,
                         const float* sin_t, const int* cu, int nseq,
                         int table_rows, long long tsn, int nmid, int m0,
                         int m1, int m2, long long st0, long long st1,
                         long long st2, void* out, int64_t n, int rows,
                         int d, int rot, int negate, int dtype,
                         void* stream) {
  if (n == 0 || rows == 0 || d == 0) return (int)cudaGetLastError();
  if (n < 0 || rows < 0 || d < 0 || rot < 0 || rot > d || rot % 2 ||
      table_rows <= 0 || (cu != nullptr && nseq < 0) || nmid < 0 ||
      nmid > 3 || tsn < 0 || st0 < 0 || st1 < 0 || st2 < 0)
    return (int)cudaErrorInvalidValue;
  const Strides ts{tsn, nmid, {m0, m1, m2}, {st0, st1, st2}};
  for (int i = 0; i < nmid; ++i)
    if (ts.size[i] <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_vec<float>(t, cos_t, sin_t, cu, nseq, table_rows,
                                    ts, out, n, rows, d, rot, negate, st);
    case 1:
      return (int)launch_vec<__nv_bfloat16>(t, cos_t, sin_t, cu, nseq,
                                            table_rows, ts, out, n, rows, d,
                                            rot, negate, st);
    case 2:
      return (int)launch_vec<__half>(t, cos_t, sin_t, cu, nseq, table_rows,
                                     ts, out, n, rows, d, rot, negate, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* apex_rope_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
