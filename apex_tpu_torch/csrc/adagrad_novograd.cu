// Fused Adagrad and NovoGrad steps over flat fp32 buffers for Hopper
// (sm_90a).
//
// Replaces: apex_tpu/multi_tensor/engine.py `fused_elementwise` (kernel
// :243, `pallas_call` :400) instantiated with two functors of
// apex_tpu/multi_tensor/ops.py, each with `check_finite=(2,)` on g and
// the first two inputs aliased to their outputs:
//
// - Adagrad, `fused_adagrad_update` (:192-217), L2 weight decay:
//     g' = g * inv_scale + wd * p
//     h' = h + g' * g'
//     p' = p - (lr * g') / (sqrt(h') + eps)
// - NovoGrad, `fused_novograd_update` (:419-468), its per-leaf
//   denominator (sqrt(v') + eps) / sqrt(bc2) read on the device through
//   the subtile -> leaf map (`tile_ids`):
//     g' = g / denom[leaf] + wd * p
//     m' = b1 * m + beta3 * g'
//     p' = p - (lr / bc1) * m'
//
// Every operation is rounded on its own (`__fmul_rn`, `__fadd_rn`,
// `__fsub_rn`, `__fdiv_rn`, `__fsqrt_rn`: nvcc cannot contract them into
// FMAs or turn a division into a reciprocal), in the order of the plain
// PyTorch version, which runs one elementwise op at a time, so both
// kernels are bitwise equal to it. The divisions stay divisions, lr / bc1
// included. `found` is set to 1 when any g is inf or nan. Adagrad's
// inv_scale (1 / grad_scale, the loss scale times the clip factor under
// the fused train step) may live in device memory: the kernel reads it by
// pointer, so no step waits on the host for it.
//
// Bound on the card: memory. Per element each reads p, g and its slot (h
// or m) and writes p and the slot: 20 bytes against ~7 fp32 operations
// (a division and a square root among them). GPT-2 345M's 355.05 M
// elements: 7.10 GB, 2.120 ms at 3.35 TB/s.
//
// A bf16 master (the reference's `sr_outputs=(0,)`, ops.py:210, :461): p
// read as bf16, the same fp32 arithmetic, p' written with stochastic
// rounding (csrc/sr_common.cuh: the threefry stream of the engine's xla
// path, keyed on the host); h and m stay fp32. 16 bytes an element and
// ~84 integer operations of the hash.
//
// Design: the SGD kernel's (csrc/fused_sgd.cu): a grid-stride loop of
// 16-byte (float4) loads and stores, each element read and written once;
// NovoGrad reads its leaf's denominator once per float4 (a 2048-element
// subtile never splits a float4). A ragged tail takes scalar loads. The
// grid is the occupancy query's blocks per SM times the SM count. Outputs
// may alias their inputs (the in-place step) or be separate buffers (the
// step that may be skipped). Any writer of the found flag stores the same
// 1.0: no atomics and no ordering.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSubtile = 2048;   // elements per entry of the leaf map

struct AdagradScalars {
  float lr, eps, wd, inv_scale;
};

struct NovogradScalars {
  float lr_over_bc1, b1, beta3, wd;
};

__device__ __forceinline__ float adagrad_one(float p, float& h, float g,
                                             const AdagradScalars& s) {
  const float gs = __fadd_rn(__fmul_rn(g, s.inv_scale), __fmul_rn(s.wd, p));
  h = __fadd_rn(h, __fmul_rn(gs, gs));
  return __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, gs),
                                __fadd_rn(__fsqrt_rn(h), s.eps)));
}

__device__ __forceinline__ float novograd_one(float p, float& m, float g,
                                              float denom,
                                              const NovogradScalars& s) {
  const float gs = __fadd_rn(__fdiv_rn(g, denom), __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.beta3, gs));
  return __fsub_rn(p, __fmul_rn(s.lr_over_bc1, m));
}

__device__ __forceinline__ bool finite4(const float4& v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z) && isfinite(v.w);
}

template <typename TP>
__global__ void __launch_bounds__(kThreads)
    adagrad_kernel(const TP* p, const float* h, const float* __restrict__ g,
                   TP* p_out, float* h_out, float* __restrict__ found,
                   int64_t n, AdagradScalars s,
                   const float* __restrict__ inv_scale_ptr, SrKey key) {
  if (inv_scale_ptr != nullptr) s.inv_scale = *inv_scale_ptr;
  bool bad = false;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t start = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = start; i < n4; i += stride) {
    const float4 pv = load4(p, i * 4);
    float4 hv = reinterpret_cast<const float4*>(h)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    bad |= !finite4(gv);
    float4 po;
    po.x = adagrad_one(pv.x, hv.x, gv.x, s);
    po.y = adagrad_one(pv.y, hv.y, gv.y, s);
    po.z = adagrad_one(pv.z, hv.z, gv.z, s);
    po.w = adagrad_one(pv.w, hv.w, gv.w, s);
    store4(p_out, i * 4, po, key);
    reinterpret_cast<float4*>(h_out)[i] = hv;
  }
  for (int64_t i = n4 * 4 + start; i < n; i += stride) {
    float hi = h[i];
    const float gi = g[i];
    bad |= !isfinite(gi);
    store1(p_out, i, adagrad_one(load1(p, i), hi, gi, s), key);
    h_out[i] = hi;
  }
  if (bad) *found = 1.0f;
}

template <typename TP>
__global__ void __launch_bounds__(kThreads)
    novograd_kernel(const TP* p, const float* m,
                    const float* __restrict__ g, TP* p_out, float* m_out,
                    float* __restrict__ found,
                    const float* __restrict__ denom,
                    const int* __restrict__ leaf_of_subtile, int64_t n,
                    float lr, float bc1, float b1, float beta3, float wd,
                    SrKey key) {
  const NovogradScalars s{__fdiv_rn(lr, bc1), b1, beta3, wd};
  bool bad = false;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t start = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = start; i < n4; i += stride) {
    const float d = denom[leaf_of_subtile[(i * 4) / kSubtile]];
    const float4 pv = load4(p, i * 4);
    float4 mv = reinterpret_cast<const float4*>(m)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    bad |= !finite4(gv);
    float4 po;
    po.x = novograd_one(pv.x, mv.x, gv.x, d, s);
    po.y = novograd_one(pv.y, mv.y, gv.y, d, s);
    po.z = novograd_one(pv.z, mv.z, gv.z, d, s);
    po.w = novograd_one(pv.w, mv.w, gv.w, d, s);
    store4(p_out, i * 4, po, key);
    reinterpret_cast<float4*>(m_out)[i] = mv;
  }
  for (int64_t i = n4 * 4 + start; i < n; i += stride) {
    float mi = m[i];
    const float gi = g[i];
    bad |= !isfinite(gi);
    store1(p_out, i,
           novograd_one(load1(p, i), mi, gi,
                        denom[leaf_of_subtile[i / kSubtile]], s),
           key);
    m_out[i] = mi;
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

// p, h, g: n fp32 each, 16-byte aligned; p_out, h_out: n fp32, each its
// input (in place) or a separate buffer. found: one fp32 the caller
// zeroed. inv_scale_ptr: the gradient's multiplier in device memory, or
// null to use inv_scale. p_bf16: 1 when p and p_out are bf16 (a bf16
// master), p' then written with stochastic rounding, the threefry stream
// of the key (k0, k1) over the element index. Returns cudaGetLastError()
// after the launch.
extern "C" int apex_adagrad(const void* p, const void* h, const void* g,
                            void* p_out, void* h_out, void* found, int64_t n,
                            float lr, float eps, float wd, float inv_scale,
                            const void* inv_scale_ptr, int p_bf16,
                            uint32_t k0, uint32_t k1, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  AdagradScalars s{lr, eps, wd, inv_scale};
  const SrKey key{k0, k1, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fh = static_cast<const float*>(h);
  const float* fg = static_cast<const float*>(g);
  float* fh_out = static_cast<float*>(h_out);
  float* ff = static_cast<float*>(found);
  const float* ip = static_cast<const float*>(inv_scale_ptr);
  if (p_bf16)
    adagrad_kernel<__nv_bfloat16>
        <<<grid_for(adagrad_kernel<__nv_bfloat16>, n), kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(p), fh, fg,
            static_cast<__nv_bfloat16*>(p_out), fh_out, ff, n, s, ip, key);
  else
    adagrad_kernel<float>
        <<<grid_for(adagrad_kernel<float>, n), kThreads, 0, st>>>(
            static_cast<const float*>(p), fh, fg, static_cast<float*>(p_out),
            fh_out, ff, n, s, ip, key);
  return (int)cudaGetLastError();
}

// p, m, g, p_out, m_out, found, p_bf16 and the key as apex_adagrad's (m
// for h); denom: fp32 per leaf in device memory; leaf_of_subtile: int32
// leaf index per 2048-element subtile, covering n.
extern "C" int apex_novograd(const void* p, const void* m, const void* g,
                             void* p_out, void* m_out, void* found,
                             const void* denom, const void* leaf_of_subtile,
                             int64_t n, float lr, float bc1, float beta1,
                             float beta3, float wd, int p_bf16, uint32_t k0,
                             uint32_t k1, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (denom == nullptr || leaf_of_subtile == nullptr)
    return (int)cudaErrorInvalidValue;
  const SrKey key{k0, k1, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fm = static_cast<const float*>(m);
  const float* fg = static_cast<const float*>(g);
  float* fm_out = static_cast<float*>(m_out);
  float* ff = static_cast<float*>(found);
  const float* fd = static_cast<const float*>(denom);
  const int* ids = static_cast<const int*>(leaf_of_subtile);
  if (p_bf16)
    novograd_kernel<__nv_bfloat16>
        <<<grid_for(novograd_kernel<__nv_bfloat16>, n), kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(p), fm, fg,
            static_cast<__nv_bfloat16*>(p_out), fm_out, ff, fd, ids, n, lr,
            bc1, beta1, beta3, wd, key);
  else
    novograd_kernel<float>
        <<<grid_for(novograd_kernel<float>, n), kThreads, 0, st>>>(
            static_cast<const float*>(p), fm, fg, static_cast<float*>(p_out),
            fm_out, ff, fd, ids, n, lr, bc1, beta1, beta3, wd, key);
  return (int)cudaGetLastError();
}

extern "C" const char* apex_adagrad_novograd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
