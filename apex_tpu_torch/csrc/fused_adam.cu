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
// A bf16 master (the reference's `sr_outputs=(0,)` with a bf16 p,
// ops.py:182): the same fp32 arithmetic on p read as bf16, p' written with
// stochastic rounding through csrc/sr_common.cuh (the threefry stream of
// the engine's xla path, keyed on the host); bitwise the plain version's
// `stochastic_round_cast`. 24 bytes an element (2.54 ms at GPT-2 345M)
// against the fp32 work plus ~84 integer operations of threefry (~0.45 ms
// at 67 T/s, ~0.9 ms at the integer pipe's half rate): the memory sweep
// and the hash take comparable time, and this simple kernel does not
// overlap them beyond what the warps' interleaving gives.
//
// Design: a grid-stride loop of 16-byte (float4) loads and stores, each
// element read and written exactly once; a tail of n % 4 elements takes
// scalar loads. The found flag is a plain store of 1.0 by any thread
// that saw a non-finite gradient (every writer stores the same value, so
// no atomics and no ordering).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sr_common.cuh"

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

// TP: the parameter buffer's type, float (the fp32 master) or
// __nv_bfloat16 (a bf16 master, p' written with stochastic rounding
// through `key`; m and v stay fp32)
template <typename TP>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(const TP* p, const float* m, const float* v,
                const float* __restrict__ g, TP* p_out, float* m_out,
                float* v_out, float* __restrict__ found, int64_t n,
                AdamScalars s, const float* __restrict__ inv_ptr, SrKey key) {
  if (inv_ptr != nullptr) s.inv_scale = *inv_ptr;
  bool bad = false;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t start = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = start; i < n4; i += stride) {
    const float4 pv = load4(p, i * 4);
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
    store4(p_out, i * 4, po, key);
    reinterpret_cast<float4*>(m_out)[i] = mv;
    reinterpret_cast<float4*>(v_out)[i] = vv;
  }
  for (int64_t i = n4 * 4 + start; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    const float gi = g[i];
    bad |= !isfinite(gi);
    store1(p_out, i, adam_one(load1(p, i), mi, vi, gi, s), key);
    m_out[i] = mi;
    v_out[i] = vi;
  }
  if (bad) *found = 1.0f;
}

}  // namespace

// p, m, v, g: n fp32 each, 16-byte aligned; p_out, m_out, v_out: n fp32,
// each either its input (in place) or a separate buffer. found: one fp32
// the caller zeroed. adam_w: 1 = decoupled weight decay (AdamW), 0 = L2.
// inv_ptr: the gradient's multiplier in device memory (a scale that
// folds in a clip factor computed on the device), or null to use
// inv_scale. p_bf16: 1 when p and p_out are bf16 (a bf16 master): p' is
// then written with stochastic rounding, the threefry stream of the key
// (k0, k1) over the element index. Returns cudaGetLastError() after the
// launch.
extern "C" int apex_adam(const void* p, const void* m, const void* v,
                         const void* g, void* p_out, void* m_out, void* v_out,
                         void* found, int64_t n, float lr, float b1, float b2,
                         float eps, float wd, float bc1, float bc2,
                         float inv_scale, const void* inv_ptr, int adam_w,
                         int p_bf16, uint32_t k0, uint32_t k1, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n / 4 + kThreads - 1) / kThreads + 1;
  const int grid = (int)(want < (int64_t)sms * 8 ? want : (int64_t)sms * 8);
  AdamScalars s{lr, b1, b2, eps, wd, bc1, bc2, inv_scale, adam_w != 0};
  const SrKey key{k0, k1, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fm = static_cast<const float*>(m);
  const float* fv = static_cast<const float*>(v);
  const float* fg = static_cast<const float*>(g);
  float* fm_out = static_cast<float*>(m_out);
  float* fv_out = static_cast<float*>(v_out);
  float* ff = static_cast<float*>(found);
  const float* inv = static_cast<const float*>(inv_ptr);
  if (p_bf16)
    adam_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(p), fm, fv, fg,
        static_cast<__nv_bfloat16*>(p_out), fm_out, fv_out, ff, n, s, inv,
        key);
  else
    adam_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(p), fm, fv, fg, static_cast<float*>(p_out),
        fm_out, fv_out, ff, n, s, inv, key);
  return (int)cudaGetLastError();
}

extern "C" const char* apex_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
