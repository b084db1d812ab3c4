// Fused Adam / AdamW step over flat fp32 buffers for Hopper (sm_90a).
//
// Replaces: apex_tpu/multi_tensor/engine.py `fused_elementwise` (kernel
// :243, `pallas_call` :400) instantiated with the Adam functor of
// apex_tpu/multi_tensor/ops.py `fused_adam_update` (:161-173), with
// `check_finite=(3,)` and p, m, v aliased to their outputs. Same
// arithmetic in the same order, every operation rounded on its own
// (`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`, `__fsqrt_rn`: nvcc cannot
// contract them into FMAs), so the result is bitwise that of the plain
// PyTorch version, which runs one elementwise op at a time:
//   g'   = g * inv_scale;  g_eff = adam_w ? g' : g' + wd * p
//   m'   = b1 * m + (1 - b1) * g_eff
//   v'   = b2 * v + (1 - b2) * g_eff * g_eff
//   upd  = (m' / bc1) / (sqrt(v' / bc2) + eps)  [+ wd * p when adam_w]
//   p'   = p - lr * upd
// and sets *found to 1 when any g is inf or nan (the raw g, as the
// reference checks its input). Outputs may alias their inputs (the
// in-place update) or be separate buffers (the skip-on-overflow path).
//
// Bound on the card: memory. Per element it reads p, m, v, g and writes
// p, m, v: 28 bytes against ~15 fp32 operations. GPT-2 345M (354,871,296
// parameters plus alignment padding) moves ~9.94 GB, ~2.97 ms at
// 3.35 TB/s.
//
// Design: a grid-stride loop of 16-byte (float4) loads and stores, each
// element read and written exactly once; a tail of n % 4 elements takes
// scalar loads. The found flag is a plain store of 1.0 by any thread
// that saw a non-finite gradient (every writer stores the same value, so
// no atomics and no ordering).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct AdamScalars {
  float lr, b1, b2, eps, wd, bc1, bc2, inv_scale;
  bool adam_w;
};

__device__ __forceinline__ float adam_one(float p, float& m, float& v,
                                          float g, const AdamScalars& s) {
  const float gs = __fmul_rn(g, s.inv_scale);
  const float g_eff = s.adam_w ? gs : __fadd_rn(gs, __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.b1, m),
                __fmul_rn(__fsub_rn(1.0f, s.b1), g_eff));
  v = __fadd_rn(__fmul_rn(s.b2, v),
                __fmul_rn(__fmul_rn(__fsub_rn(1.0f, s.b2), g_eff), g_eff));
  const float mhat = __fdiv_rn(m, s.bc1);
  const float vhat = __fdiv_rn(v, s.bc2);
  float upd = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), s.eps));
  upd = __fadd_rn(upd, s.adam_w ? __fmul_rn(s.wd, p) : 0.0f);
  return __fsub_rn(p, __fmul_rn(s.lr, upd));
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const float* p, const float* m, const float* v,
                const float* __restrict__ g, float* p_out, float* m_out,
                float* v_out, float* __restrict__ found, int64_t n,
                AdamScalars s) {
  bool bad = false;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t start = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = start; i < n4; i += stride) {
    const float4 pv = reinterpret_cast<const float4*>(p)[i];
    float4 mv = reinterpret_cast<const float4*>(m)[i];
    float4 vv = reinterpret_cast<const float4*>(v)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    bad |= !isfinite(gv.x) || !isfinite(gv.y) || !isfinite(gv.z) ||
           !isfinite(gv.w);
    float4 po;
    po.x = adam_one(pv.x, mv.x, vv.x, gv.x, s);
    po.y = adam_one(pv.y, mv.y, vv.y, gv.y, s);
    po.z = adam_one(pv.z, mv.z, vv.z, gv.z, s);
    po.w = adam_one(pv.w, mv.w, vv.w, gv.w, s);
    reinterpret_cast<float4*>(p_out)[i] = po;
    reinterpret_cast<float4*>(m_out)[i] = mv;
    reinterpret_cast<float4*>(v_out)[i] = vv;
  }
  for (int64_t i = n4 * 4 + start; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    const float gi = g[i];
    bad |= !isfinite(gi);
    p_out[i] = adam_one(p[i], mi, vi, gi, s);
    m_out[i] = mi;
    v_out[i] = vi;
  }
  if (bad) *found = 1.0f;
}

}  // namespace

// p, m, v, g: n fp32 each, 16-byte aligned; p_out, m_out, v_out: n fp32,
// each either its input (in place) or a separate buffer. found: one fp32
// the caller zeroed. adam_w: 1 = decoupled weight decay (AdamW), 0 = L2.
// Returns cudaGetLastError() after the launch.
extern "C" int apex_adam(const void* p, const void* m, const void* v,
                         const void* g, void* p_out, void* m_out, void* v_out,
                         void* found, int64_t n, float lr, float b1, float b2,
                         float eps, float wd, float bc1, float bc2,
                         float inv_scale, int adam_w, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n / 4 + kThreads - 1) / kThreads + 1;
  const int grid = (int)(want < (int64_t)sms * 8 ? want : (int64_t)sms * 8);
  AdamScalars s{lr, b1, b2, eps, wd, bc1, bc2, inv_scale, adam_w != 0};
  adam_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(m),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<float*>(p_out), static_cast<float*>(m_out),
      static_cast<float*>(v_out), static_cast<float*>(found), n, s);
  return (int)cudaGetLastError();
}

extern "C" const char* apex_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
