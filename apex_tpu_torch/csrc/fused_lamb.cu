// The two LAMB stages over flat fp32 buffers for Hopper (sm_90a).
//
// Replaces: apex_tpu/multi_tensor/engine.py `fused_elementwise` (kernel
// :243, `pallas_call` :400) instantiated with the two LAMB functors of
// apex_tpu/multi_tensor/ops.py:
//
// - stage 1, `fused_lamb_compute_update_term` (:300-319): the update
//   term u, m' and v' (csrc/lamb_common.cuh), `check_finite=(3,)` on g,
//   and from the same pass the per-subtile sums of squares of p, of u
//   and (optionally) of the raw g (`sumsq_subtiles`, engine.py:298-316),
//   one fp32 per 2048-element subtile. The reference emits 128 per-lane
//   partials a subtile; every consumer adds the lanes first
//   (ops.py:79), so one value a subtile is the same function.
// - stage 2, `fused_lamb_update`'s `stage2` (:395-408) and the large-leaf
//   stage 2 of apex_tpu/multi_tensor/segmented.py (:485-499):
//   p' = p - (lr * ratio[leaf]) * u, with the leaf of each subtile read
//   from a map in device memory (the reference resolves ids to per-row
//   values outside its kernel because Mosaic cannot gather; a CUDA
//   thread just reads ratio[leaf_of_subtile]).
//
// Bound on the card: memory. Stage 1 reads p, m, v, g and writes u, m',
// v' (28 bytes an element, ~20 fp32 operations); stage 2 reads p, u and
// writes p' (12 bytes, 3 operations). Over GPT-2 345M's 355 M elements:
// 2.97 ms and 1.27 ms at 3.35 TB/s.
//
// A bf16 master (the reference's `sr_outputs=(0,)` on stage 2, ops.py:407,
// and the large leaves' stage 2 of segmented.py:485-499): stage 1 reads p
// as bf16 (its sum of squares from the same fp32 values); stage 2 reads p
// as bf16 and writes p' with stochastic rounding (csrc/sr_common.cuh, the
// threefry stream of the engine's xla path). Over the whole buffer the
// stream is one key's over the element index; over the large leaves'
// segments each leaf has the reference's own stream, key fold_in(
// PRNGKey(seed + leaf + 1), 0) over the index within the leaf's slice,
// read from a small table (key words and the slice's first element) per
// listed segment. m, v and u stay fp32. Stage 2 moves 10 bytes an element
// and hashes each: ~84 integer operations.
//
// Design. Stage 1: one warp per subtile (grid-stride over subtiles); a
// lane takes 16 float4s of the subtile, neighbouring lanes on
// neighbouring addresses, keeps its running sums of p^2, u^2 and g^2,
// and the warp adds them with shuffles in a fixed order; lane 0 writes
// the subtile's partials. One writer per partial, no atomics: the same
// bits on every run. Stage 2: a grid-stride loop of float4s. Both take
// any length (a ragged tail takes scalar loads); outputs may alias their
// inputs (in place) or be separate buffers (the skip-capable step). The
// scale divisor of stage 1 may live in device memory (a clip factor
// computed from a device norm is never read on the host), and so do the
// trust ratios of stage 2. Both can sweep a list of segments of a
// segmented layout instead of the whole buffer: the large leaves of the
// one-pass LAMB, all of them in one launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lamb_common.cuh"
#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;
// stage 2's per-leaf stream keys in shared memory: 8 bytes a leaf, at
// most the 48 KiB a block takes without opting in
constexpr int64_t kMaxStreams = 6144;

__device__ __forceinline__ float sqf(float x) { return __fmul_rn(x, x); }

// TP: the parameter buffer's type, float or __nv_bfloat16 (a bf16 master,
// read as fp32; stage 1 writes no parameter)
template <typename TP>
__global__ void __launch_bounds__(kThreads)
    stage1_kernel(const TP* p, const float* m, const float* v,
                  const float* g, float* u_out, float* m_out, float* v_out,
                  float* __restrict__ found, float* __restrict__ pp_out,
                  float* __restrict__ uu_out, float* __restrict__ gg_out,
                  int64_t n, LambScalars s, float inv_val,
                  const float* __restrict__ inv_ptr,
                  const int* __restrict__ segs, int64_t n_segs,
                  int64_t seg_sub) {
  const float inv = inv_ptr != nullptr ? *inv_ptr : inv_val;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  const int64_t n_sub = segs != nullptr ? n_segs * seg_sub
                                        : (n + kSubtile - 1) / kSubtile;
  bool bad = false;
  for (int64_t i = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       i < n_sub; i += warps) {
    // the subtile of the buffer this warp takes: the i-th of the listed
    // segments' subtiles, or the i-th of the buffer's
    const int64_t t = segs != nullptr
        ? (int64_t)segs[i / seg_sub] * seg_sub + i % seg_sub : i;
    float pp = 0.0f, uu = 0.0f, gg = 0.0f;
    for (int j = 0; j < kSubtileVecsPerLane; ++j) {
      const int64_t e = t * kSubtile + (int64_t)(j * 32 + lane) * 4;
      if (e + 4 <= n) {
        const float4 pv = load4(p, e);
        float4 mv = *reinterpret_cast<const float4*>(m + e);
        float4 vv = *reinterpret_cast<const float4*>(v + e);
        const float4 gv = *reinterpret_cast<const float4*>(g + e);
        bad |= !isfinite(gv.x) || !isfinite(gv.y) || !isfinite(gv.z) ||
               !isfinite(gv.w);
        float4 uv;
        uv.x = lamb_stage1_one(pv.x, mv.x, vv.x, gv.x, inv, s);
        uv.y = lamb_stage1_one(pv.y, mv.y, vv.y, gv.y, inv, s);
        uv.z = lamb_stage1_one(pv.z, mv.z, vv.z, gv.z, inv, s);
        uv.w = lamb_stage1_one(pv.w, mv.w, vv.w, gv.w, inv, s);
        *reinterpret_cast<float4*>(u_out + e) = uv;
        *reinterpret_cast<float4*>(m_out + e) = mv;
        *reinterpret_cast<float4*>(v_out + e) = vv;
        pp = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(pp, sqf(pv.x)),
                                           sqf(pv.y)), sqf(pv.z)), sqf(pv.w));
        uu = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(uu, sqf(uv.x)),
                                           sqf(uv.y)), sqf(uv.z)), sqf(uv.w));
        gg = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(gg, sqf(gv.x)),
                                           sqf(gv.y)), sqf(gv.z)), sqf(gv.w));
      } else {
        for (int k = 0; k < 4 && e + k < n; ++k) {
          const float pi = load1(p, e + k), gi = g[e + k];
          float mi = m[e + k], vi = v[e + k];
          bad |= !isfinite(gi);
          const float ui = lamb_stage1_one(pi, mi, vi, gi, inv, s);
          u_out[e + k] = ui;
          m_out[e + k] = mi;
          v_out[e + k] = vi;
          pp = __fadd_rn(pp, sqf(pi));
          uu = __fadd_rn(uu, sqf(ui));
          gg = __fadd_rn(gg, sqf(gi));
        }
      }
    }
    if (pp_out != nullptr) {
      pp = warp_sum(pp);
      uu = warp_sum(uu);
      gg = warp_sum(gg);
      if (lane == 0) {
        pp_out[t] = pp;
        uu_out[t] = uu;
        if (gg_out != nullptr) gg_out[t] = gg;
      }
    }
  }
  if (bad) *found = 1.0f;
}

// TP as stage 1's; a bf16 p' is written with stochastic rounding: the
// whole buffer's stream `key`, or with `seg_streams` (n_segs x (k, base)
// int64, a segment list only) the stream of each listed segment's leaf,
// `stream_leaves[k]`: fold_in(PRNGKey(seed + leaf + 1), 0), indexed from
// the leaf's first element (`base`). Each block derives the n_streams
// leaves' keys into shared memory first (one threefry a leaf), so the
// tables are fixed by the layout and only the seed changes per step.
template <typename TP>
__global__ void __launch_bounds__(kThreads)
    stage2_kernel(const TP* p, const float* __restrict__ u, TP* p_out,
                  const float* __restrict__ ratio,
                  const int* __restrict__ leaf_of_subtile, int64_t n,
                  float lr, const int* __restrict__ segs, int64_t n_segs,
                  int64_t seg_elems, SrKey key,
                  const int64_t* __restrict__ seg_streams,
                  const int64_t* __restrict__ stream_leaves, int n_streams,
                  uint32_t seed) {
  extern __shared__ uint2 leaf_key[];
  if (seg_streams != nullptr) {
    for (int k = threadIdx.x; k < n_streams; k += kThreads) {
      const SrKey lk =
          sr_fold_in_key(seed + (uint32_t)stream_leaves[k] + 1u, 0u);
      leaf_key[k] = make_uint2(lk.k0, lk.k1);
    }
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  // float4s to write: those of the listed segments, or of the buffer
  const int64_t seg4 = seg_elems / 4;
  const int64_t n4 = segs != nullptr ? n_segs * seg4 : n / 4;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < n4;
       j += stride) {
    const int64_t i =
        segs != nullptr ? (int64_t)segs[j / seg4] * seg4 + j % seg4 : j;
    if (seg_streams != nullptr) {
      const int64_t* t = seg_streams + 2 * (j / seg4);
      const uint2 lk = leaf_key[t[0]];
      key = SrKey{lk.x, lk.y, t[1]};
    }
    const float r = ratio[leaf_of_subtile[(i * 4) / kSubtile]];
    const float lr_r = __fmul_rn(lr, r);
    const float4 pv = load4(p, i * 4);
    const float4 uv = reinterpret_cast<const float4*>(u)[i];
    float4 o;
    o.x = __fsub_rn(pv.x, __fmul_rn(lr_r, uv.x));
    o.y = __fsub_rn(pv.y, __fmul_rn(lr_r, uv.y));
    o.z = __fsub_rn(pv.z, __fmul_rn(lr_r, uv.z));
    o.w = __fsub_rn(pv.w, __fmul_rn(lr_r, uv.w));
    store4(p_out, i * 4, o, key);
  }
  if (segs != nullptr) return;      // segments hold whole float4s
  for (int64_t i = n4 * 4 + (int64_t)blockIdx.x * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float r = ratio[leaf_of_subtile[i / kSubtile]];
    store1(p_out, i,
           __fsub_rn(load1(p, i), __fmul_rn(__fmul_rn(lr, r), u[i])), key);
  }
}

int grid_for(int64_t work, int64_t per_block) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (work + per_block - 1) / per_block;
  const int64_t cap = (int64_t)sms * 8;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

// p, m, v, g: n fp32 each, 16-byte aligned; u_out, m_out, v_out: n fp32,
// each a separate buffer or (m_out, v_out) its input. found: one fp32 the
// caller zeroed. pp, uu: ceil(n / 2048) fp32 each, or both null for no
// partials; gg: the same, or null. inv_ptr: the divisor in device memory,
// or null to use inv_val. adam_w: 1 = decoupled weight decay, 0 = L2.
// segs: null for the whole buffer, or n_segs int32 indices of segments of
// seg_elems elements (a multiple of 2048) to sweep, the rest untouched
// (partials are written at their subtiles' places in the buffer).
// p_bf16: 1 when p is bf16 (a bf16 master).
extern "C" int apex_lamb_stage1(const void* p, const void* m, const void* v,
                                const void* g, void* u_out, void* m_out,
                                void* v_out, void* found, void* pp, void* uu,
                                void* gg, int64_t n, float b1, float b2,
                                float beta3, float eps, float wd, float bc1,
                                float bc2, float inv_val, const void* inv_ptr,
                                int adam_w, const void* segs, int64_t n_segs,
                                int64_t seg_elems, int p_bf16, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (segs != nullptr && (seg_elems <= 0 || seg_elems % kSubtile))
    return (int)cudaErrorInvalidValue;
  LambScalars s{b1, b2, beta3, eps, wd, bc1, bc2, 0.0f, adam_w};
  const int64_t work = segs != nullptr ? n_segs * (seg_elems / kSubtile)
                                       : (n + kSubtile - 1) / kSubtile;
  if (work <= 0) return (int)cudaGetLastError();
  const int grid = grid_for(work, kThreads / 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fm = static_cast<const float*>(m);
  const float* fv = static_cast<const float*>(v);
  const float* fg = static_cast<const float*>(g);
  float* fu = static_cast<float*>(u_out);
  float* fm_out = static_cast<float*>(m_out);
  float* fv_out = static_cast<float*>(v_out);
  float* ff = static_cast<float*>(found);
  float* fpp = static_cast<float*>(pp);
  float* fuu = static_cast<float*>(uu);
  float* fgg = static_cast<float*>(gg);
  const float* ip = static_cast<const float*>(inv_ptr);
  const int* sg = static_cast<const int*>(segs);
  if (p_bf16)
    stage1_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(p), fm, fv, fg, fu, fm_out, fv_out,
        ff, fpp, fuu, fgg, n, s, inv_val, ip, sg, n_segs,
        seg_elems / kSubtile);
  else
    stage1_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(p), fm, fv, fg, fu, fm_out, fv_out, ff, fpp,
        fuu, fgg, n, s, inv_val, ip, sg, n_segs, seg_elems / kSubtile);
  return (int)cudaGetLastError();
}

// p, u: n fp32, 16-byte aligned; p_out: n fp32 (p itself, or a separate
// buffer). ratio: fp32 per leaf in device memory; leaf_of_subtile: int32
// leaf index per 2048-element subtile. segs: null for the whole buffer,
// or n_segs int32 indices of segments of seg_elems elements to sweep.
// p_bf16: 1 when p and p_out are bf16 (a bf16 master): p' is then
// written with stochastic rounding, over the whole buffer with the
// threefry key (k0, k1), or, given seg_streams (n_segs rows of int64 k,
// base: a segment list only) and stream_leaves (n_streams int64 leaf
// indices, at most kMaxStreams), each listed segment with the key of
// fold_in(PRNGKey(seed + stream_leaves[k] + 1), 0) at stream index
// (element - base).
extern "C" int apex_lamb_stage2(const void* p, const void* u, void* p_out,
                                const void* ratio, const void* leaf_of_subtile,
                                int64_t n, float lr, const void* segs,
                                int64_t n_segs, int64_t seg_elems, int p_bf16,
                                uint32_t k0, uint32_t k1,
                                const void* seg_streams,
                                const void* stream_leaves, int64_t n_streams,
                                uint32_t seed, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (leaf_of_subtile == nullptr ||
      (segs != nullptr && (seg_elems <= 0 || seg_elems % kSubtile)) ||
      (seg_streams != nullptr &&
       (segs == nullptr || !p_bf16 || stream_leaves == nullptr ||
        n_streams <= 0 || n_streams > kMaxStreams)))
    return (int)cudaErrorInvalidValue;
  const int64_t work = segs != nullptr ? n_segs * seg_elems / 4 : n / 4 + 1;
  if (work <= 0) return (int)cudaGetLastError();
  const int grid = grid_for(work, kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fu = static_cast<const float*>(u);
  const float* fr = static_cast<const float*>(ratio);
  const int* ids = static_cast<const int*>(leaf_of_subtile);
  const int* sg = static_cast<const int*>(segs);
  const SrKey key{k0, k1, 0};
  const int ns = seg_streams != nullptr ? (int)n_streams : 0;
  const size_t smem = (size_t)ns * sizeof(uint2);
  if (p_bf16)
    stage2_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(p), fu,
        static_cast<__nv_bfloat16*>(p_out), fr, ids, n, lr, sg, n_segs,
        seg_elems, key, static_cast<const int64_t*>(seg_streams),
        static_cast<const int64_t*>(stream_leaves), ns, seed);
  else
    stage2_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(p), fu, static_cast<float*>(p_out), fr, ids,
        n, lr, sg, n_segs, seg_elems, key, nullptr, nullptr, 0, 0u);
  return (int)cudaGetLastError();
}

extern "C" const char* apex_lamb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
