// The optimizer engine's bandwidth ladder for Hopper (sm_90a).
//
// Replaces the five `pallas_call` sites of tools/tpu_kprobe.py: `copy_call`
// (:93), `multi_call` (:108), `adam_call` (:134), `adamf_call` (:163) and
// `adama_call` (:180). Each rung adds one factor to the one before it, so
// the fused engine's distance from the card's byte rate (csrc/fused_adam.cu,
// 3.51 ms against its 2.97 ms bound at GPT-2 345M) splits into stream
// count, arithmetic and the finite check:
//   copy1       one stream in, one out: o = p * 1.0000001      (:90-91)
//   multi7      four in, three out, no arithmetic: p * 1.0000001,
//               m * 1.0000001, v + g                         (:103-106)
//   adam_math   `adam_body`'s arithmetic and constants       (:121-126):
//               m2 = 0.9 m + 0.1 g;  v2 = 0.999 v + (0.001 g) g;
//               up = m2 / (sqrt(v2) + 1e-8) + 0.01 p;  p2 = p - 1e-3 up
//   adam_found  plus found = 1 when any g is not finite, over all blocks
//               (:147-160; a plain store of 1 by any thread that sees one)
//   adam_alias  adam_math written in place into p, m and v: CUDA's
//               counterpart of `input_output_aliases` (:180-186), the
//               same kernel with the outputs pointing at the inputs.
// Every operation is written `__fmul_rn`, `__fadd_rn`, `__fdiv_rn` or
// `__fsqrt_rn` in the formula's order, so nvcc contracts nothing into an
// FMA and each rung is bitwise its plain PyTorch version
// (`apex_tpu_torch/tools/kprobe.py`).
//
// Bound on the card: memory, every rung. copy1 moves 8 bytes an element,
// the others 28; at 64 M elements 0.153 and 0.535 ms at 3.35 TB/s. The
// arithmetic (~10 fp32 operations and one sqrt an element) is far below
// the fp32 rate.
//
// Design: fused_adam.cu's, so the ladder measures its shape: a grid-stride
// loop of 16-byte (float4) loads and stores, each element read and written
// once, a scalar tail for n % 4. No pointer is `__restrict__`, since
// adam_alias passes the same buffers in and out.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCopy1 = 0, kMulti7 = 1, kAdamMath = 2, kAdamFound = 3;

__device__ __forceinline__ void adam_body(float p, float m, float v, float g,
                                          float* p2, float* m2, float* v2) {
  const float mm = __fadd_rn(__fmul_rn(0.9f, m), __fmul_rn(0.1f, g));
  const float vv =
      __fadd_rn(__fmul_rn(0.999f, v), __fmul_rn(__fmul_rn(0.001f, g), g));
  const float up = __fadd_rn(__fdiv_rn(mm, __fadd_rn(__fsqrt_rn(vv), 1e-8f)),
                             __fmul_rn(0.01f, p));
  *p2 = __fsub_rn(p, __fmul_rn(1e-3f, up));
  *m2 = mm;
  *v2 = vv;
}

template <int R>
__device__ __forceinline__ void one(const float* p, const float* m,
                                    const float* v, const float* g,
                                    float* po, float* mo, float* vo,
                                    bool* bad, int64_t i) {
  if (R == kCopy1) {
    po[i] = __fmul_rn(p[i], 1.0000001f);
  } else if (R == kMulti7) {
    po[i] = __fmul_rn(p[i], 1.0000001f);
    mo[i] = __fmul_rn(m[i], 1.0000001f);
    vo[i] = __fadd_rn(v[i], g[i]);
  } else {
    const float gi = g[i];
    if (R == kAdamFound && !isfinite(gi)) *bad = true;
    float a, b, c;
    adam_body(p[i], m[i], v[i], gi, &a, &b, &c);
    po[i] = a;
    mo[i] = b;
    vo[i] = c;
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    rung_kernel(const float* p, const float* m, const float* v,
                const float* g, float* po, float* mo, float* vo,
                float* found, int64_t n) {
  bool bad = false;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t n4 = n / 4;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 pv = reinterpret_cast<const float4*>(p)[i];
    if (R == kCopy1) {
      reinterpret_cast<float4*>(po)[i] = make_float4(
          __fmul_rn(pv.x, 1.0000001f), __fmul_rn(pv.y, 1.0000001f),
          __fmul_rn(pv.z, 1.0000001f), __fmul_rn(pv.w, 1.0000001f));
      continue;
    }
    const float4 mv = reinterpret_cast<const float4*>(m)[i];
    const float4 vv = reinterpret_cast<const float4*>(v)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
    const float ma[4] = {mv.x, mv.y, mv.z, mv.w};
    const float va[4] = {vv.x, vv.y, vv.z, vv.w};
    const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
    float a[4], b[4], c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (R == kMulti7) {
        a[e] = __fmul_rn(pa[e], 1.0000001f);
        b[e] = __fmul_rn(ma[e], 1.0000001f);
        c[e] = __fadd_rn(va[e], ga[e]);
      } else {
        if (R == kAdamFound && !isfinite(ga[e])) bad = true;
        adam_body(pa[e], ma[e], va[e], ga[e], &a[e], &b[e], &c[e]);
      }
    }
    reinterpret_cast<float4*>(po)[i] = make_float4(a[0], a[1], a[2], a[3]);
    reinterpret_cast<float4*>(mo)[i] = make_float4(b[0], b[1], b[2], b[3]);
    reinterpret_cast<float4*>(vo)[i] = make_float4(c[0], c[1], c[2], c[3]);
  }
  for (int64_t i = n4 * 4 + (int64_t)blockIdx.x * kThreads + threadIdx.x;
       i < n; i += stride)
    one<R>(p, m, v, g, po, mo, vo, &bad, i);
  if (R == kAdamFound && bad) *found = 1.0f;
}

template <int R>
cudaError_t launch(const float* p, const float* m, const float* v,
                   const float* g, float* po, float* mo, float* vo,
                   float* found, int64_t n, cudaStream_t stream) {
  int64_t blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride over 132 SMs
  rung_kernel<R><<<(unsigned)blocks, kThreads, 0, stream>>>(
      p, m, v, g, po, mo, vo, found, n);
  return cudaGetLastError();
}

}  // namespace

// rung: 0 copy1 (p -> po), 1 multi7, 2 adam_math (also adam_alias, with
// po, mo, vo equal to p, m, v), 3 adam_found (found: one fp32 in device
// memory, set to 1 when any g is not finite; the caller zeroes it). All
// buffers n fp32, 16-byte aligned. Returns cudaGetLastError() after the
// launch.
extern "C" int apex_kprobe(int rung, const void* p, const void* m,
                           const void* v, const void* g, void* po, void* mo,
                           void* vo, void* found, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const float *pp = static_cast<const float*>(p),
              *mp = static_cast<const float*>(m),
              *vp = static_cast<const float*>(v),
              *gp = static_cast<const float*>(g);
  float *pop = static_cast<float*>(po), *mop = static_cast<float*>(mo),
        *vop = static_cast<float*>(vo), *fp = static_cast<float*>(found);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rung) {
    case kCopy1:
      return (int)launch<kCopy1>(pp, mp, vp, gp, pop, mop, vop, fp, n, st);
    case kMulti7:
      return (int)launch<kMulti7>(pp, mp, vp, gp, pop, mop, vop, fp, n, st);
    case kAdamMath:
      return (int)launch<kAdamMath>(pp, mp, vp, gp, pop, mop, vop, fp, n,
                                    st);
    case kAdamFound:
      if (found == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch<kAdamFound>(pp, mp, vp, gp, pop, mop, vop, fp, n,
                                     st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* apex_kprobe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
