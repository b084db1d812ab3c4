// Fused SGD and LARS steps over flat fp32 buffers for Hopper (sm_90a).
//
// Replaces: apex_tpu/multi_tensor/engine.py `fused_elementwise` (kernel
// :243, `pallas_call` :400) instantiated with two functors of
// apex_tpu/multi_tensor/ops.py, each with `check_finite=(2,)` on g and
// p, mom aliased to their outputs:
//
// - SGD, `fused_sgd_update` (:220-243):
//     g'   = g * scale;  g' += wd * p            (unless wd_after_momentum)
//     mom' = first ? g' : mu * mom + (1 - dampening) * g'
//     upd  = nesterov ? g' + mu * mom' : mom'
//     (mu == 0: upd = g', mom' = mom)
//     upd += wd * p                              (when wd_after_momentum)
//     p'   = p - lr * upd
// - LARS, `fused_lars_update` (:471-499), its per-tensor ratio read on
//   the device through the subtile -> leaf map (`tile_ids`):
//     g'   = (g + wd * p) * ratio[leaf]
//     mom' = first ? g' : mu * mom + g'
//     p'   = p - lr * mom'
//
// Every operation is rounded on its own (`__fmul_rn`, `__fadd_rn`,
// `__fsub_rn`: nvcc cannot contract them into FMAs), in the order of the
// plain PyTorch version, which runs one elementwise op at a time, so both
// kernels are bitwise equal to it. `found` is set to 1 when any g is inf
// or nan. The first-run flag (the reference's `initialized` slot,
// optimizers/fused.py:503, :515) and SGD's gradient scale may live in
// device memory: the kernel reads them by pointer, so no step waits on
// the host for them.
//
// Bound on the card: memory. Per element each reads p, mom, g and writes
// p, mom: 20 bytes against at most ~10 fp32 operations. ResNet-50's
// 25,557,032 parameters take 25,722,880 elements with the per-leaf
// padding: 0.514 GB, 0.154 ms at 3.35 TB/s. Measured on an H100 80GB
// HBM3 at 700 W (chip_smoke.py): 0.184 ms (SGD) and 0.182 ms (LARS),
// 84% of the bound.
//
// A bf16 master (the reference's `sr_outputs=(0,)`, ops.py:254, :502): p
// read as bf16, the same fp32 arithmetic, p' written with stochastic
// rounding (csrc/sr_common.cuh: the threefry stream of the engine's xla
// path, keyed on the host); mom stays fp32. 16 bytes an element and ~84
// integer operations of the hash.
//
// Design: a grid-stride loop of 16-byte (float4) loads and stores, each
// element read and written once; LARS reads its leaf's ratio once per
// float4 (a 2048-element subtile never splits a float4). A ragged tail
// takes scalar loads. The grid is the occupancy query's blocks per SM
// times the SM count. Outputs may alias their inputs (the in-place step)
// or be separate buffers (the step that may be skipped). Any writer of
// the found flag stores the same 1.0: no atomics and no ordering.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSubtile = 2048;   // elements per entry of the leaf map

struct SgdScalars {
  float lr, mu, damp, wd, scale;
  bool first, nesterov, wd_after;
};

struct LarsScalars {
  float lr, mu, wd;
  bool first;
};

__device__ __forceinline__ float sgd_one(float p, float& mom, float g,
                                         const SgdScalars& s) {
  float gs = __fmul_rn(g, s.scale);
  if (!s.wd_after) gs = __fadd_rn(gs, __fmul_rn(s.wd, p));
  float upd;
  if (s.mu == 0.0f) {
    upd = gs;                       // mom passes through unchanged
  } else {
    mom = s.first ? gs
                  : __fadd_rn(__fmul_rn(s.mu, mom),
                              __fmul_rn(__fsub_rn(1.0f, s.damp), gs));
    upd = s.nesterov ? __fadd_rn(gs, __fmul_rn(s.mu, mom)) : mom;
  }
  if (s.wd_after) upd = __fadd_rn(upd, __fmul_rn(s.wd, p));
  return __fsub_rn(p, __fmul_rn(s.lr, upd));
}

__device__ __forceinline__ float lars_one(float p, float& mom, float g,
                                          float ratio, const LarsScalars& s) {
  const float gs = __fmul_rn(__fadd_rn(g, __fmul_rn(s.wd, p)), ratio);
  mom = s.first ? gs : __fadd_rn(__fmul_rn(s.mu, mom), gs);
  return __fsub_rn(p, __fmul_rn(s.lr, mom));
}

__device__ __forceinline__ bool finite4(const float4& v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z) && isfinite(v.w);
}

template <typename TP>
__global__ void __launch_bounds__(kThreads)
    sgd_kernel(const TP* p, const float* mom, const float* __restrict__ g,
               TP* p_out, float* mom_out, float* __restrict__ found,
               int64_t n, SgdScalars s, const float* __restrict__ scale_ptr,
               const float* __restrict__ first_ptr, SrKey key) {
  if (scale_ptr != nullptr) s.scale = *scale_ptr;
  if (first_ptr != nullptr) s.first = *first_ptr > 0.5f;
  bool bad = false;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t start = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = start; i < n4; i += stride) {
    const float4 pv = load4(p, i * 4);
    float4 mv = reinterpret_cast<const float4*>(mom)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    bad |= !finite4(gv);
    float4 po;
    po.x = sgd_one(pv.x, mv.x, gv.x, s);
    po.y = sgd_one(pv.y, mv.y, gv.y, s);
    po.z = sgd_one(pv.z, mv.z, gv.z, s);
    po.w = sgd_one(pv.w, mv.w, gv.w, s);
    store4(p_out, i * 4, po, key);
    reinterpret_cast<float4*>(mom_out)[i] = mv;
  }
  for (int64_t i = n4 * 4 + start; i < n; i += stride) {
    float mi = mom[i];
    const float gi = g[i];
    bad |= !isfinite(gi);
    store1(p_out, i, sgd_one(load1(p, i), mi, gi, s), key);
    mom_out[i] = mi;
  }
  if (bad) *found = 1.0f;
}

template <typename TP>
__global__ void __launch_bounds__(kThreads)
    lars_kernel(const TP* p, const float* mom, const float* __restrict__ g,
                TP* p_out, float* mom_out, float* __restrict__ found,
                const float* __restrict__ ratio,
                const int* __restrict__ leaf_of_subtile, int64_t n,
                LarsScalars s, const float* __restrict__ first_ptr,
                SrKey key) {
  if (first_ptr != nullptr) s.first = *first_ptr > 0.5f;
  bool bad = false;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t start = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = start; i < n4; i += stride) {
    const float r = ratio[leaf_of_subtile[(i * 4) / kSubtile]];
    const float4 pv = load4(p, i * 4);
    float4 mv = reinterpret_cast<const float4*>(mom)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    bad |= !finite4(gv);
    float4 po;
    po.x = lars_one(pv.x, mv.x, gv.x, r, s);
    po.y = lars_one(pv.y, mv.y, gv.y, r, s);
    po.z = lars_one(pv.z, mv.z, gv.z, r, s);
    po.w = lars_one(pv.w, mv.w, gv.w, r, s);
    store4(p_out, i * 4, po, key);
    reinterpret_cast<float4*>(mom_out)[i] = mv;
  }
  for (int64_t i = n4 * 4 + start; i < n; i += stride) {
    float mi = mom[i];
    const float gi = g[i];
    bad |= !isfinite(gi);
    store1(p_out, i,
           lars_one(load1(p, i), mi, gi, ratio[leaf_of_subtile[i / kSubtile]],
                    s),
           key);
    mom_out[i] = mi;
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

}  // namespace

// p, mom, g: n fp32 each, 16-byte aligned; p_out, mom_out: n fp32, each
// its input (in place) or a separate buffer. found: one fp32 the caller
// zeroed. scale_ptr / first_ptr: the gradient's multiplier and the
// first-run flag (> 0.5: seed the momentum with the gradient) in device
// memory, or null to use scale / first. p_bf16: 1 when p and p_out are
// bf16 (a bf16 master), p' then written with stochastic rounding, the
// threefry stream of the key (k0, k1) over the element index. Returns
// cudaGetLastError() after the launch.
extern "C" int apex_sgd(const void* p, const void* mom, const void* g,
                        void* p_out, void* mom_out, void* found, int64_t n,
                        float lr, float momentum, float dampening, float wd,
                        float scale, const void* scale_ptr, int first,
                        const void* first_ptr, int nesterov,
                        int wd_after_momentum, int p_bf16, uint32_t k0,
                        uint32_t k1, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  SgdScalars s{lr, momentum, dampening, wd, scale, first != 0, nesterov != 0,
               wd_after_momentum != 0};
  const SrKey key{k0, k1, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fmom = static_cast<const float*>(mom);
  const float* fg = static_cast<const float*>(g);
  float* fmom_out = static_cast<float*>(mom_out);
  float* ff = static_cast<float*>(found);
  const float* sp = static_cast<const float*>(scale_ptr);
  const float* fp = static_cast<const float*>(first_ptr);
  if (p_bf16)
    sgd_kernel<__nv_bfloat16>
        <<<grid_for(sgd_kernel<__nv_bfloat16>, n), kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(p), fmom, fg,
            static_cast<__nv_bfloat16*>(p_out), fmom_out, ff, n, s, sp, fp,
            key);
  else
    sgd_kernel<float><<<grid_for(sgd_kernel<float>, n), kThreads, 0, st>>>(
        static_cast<const float*>(p), fmom, fg, static_cast<float*>(p_out),
        fmom_out, ff, n, s, sp, fp, key);
  return (int)cudaGetLastError();
}

// As apex_sgd, plus ratio: fp32 per leaf in device memory, and
// leaf_of_subtile: int32 leaf index per 2048-element subtile, covering n.
extern "C" int apex_lars(const void* p, const void* mom, const void* g,
                         void* p_out, void* mom_out, void* found,
                         const void* ratio, const void* leaf_of_subtile,
                         int64_t n, float lr, float momentum, float wd,
                         int first, const void* first_ptr, int p_bf16,
                         uint32_t k0, uint32_t k1, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (ratio == nullptr || leaf_of_subtile == nullptr)
    return (int)cudaErrorInvalidValue;
  LarsScalars s{lr, momentum, wd, first != 0};
  const SrKey key{k0, k1, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fmom = static_cast<const float*>(mom);
  const float* fg = static_cast<const float*>(g);
  float* fmom_out = static_cast<float*>(mom_out);
  float* ff = static_cast<float*>(found);
  const float* fr = static_cast<const float*>(ratio);
  const int* ids = static_cast<const int*>(leaf_of_subtile);
  const float* fp = static_cast<const float*>(first_ptr);
  if (p_bf16)
    lars_kernel<__nv_bfloat16>
        <<<grid_for(lars_kernel<__nv_bfloat16>, n), kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(p), fmom, fg,
            static_cast<__nv_bfloat16*>(p_out), fmom_out, ff, fr, ids, n, s,
            fp, key);
  else
    lars_kernel<float><<<grid_for(lars_kernel<float>, n), kThreads, 0, st>>>(
        static_cast<const float*>(p), fmom, fg, static_cast<float*>(p_out),
        fmom_out, ff, fr, ids, n, s, fp, key);
  return (int)cudaGetLastError();
}

extern "C" const char* apex_sgd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
