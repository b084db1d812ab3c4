// One-pass LAMB over the small segments of a segmented flat layout, for
// Hopper (sm_90a).
//
// Replaces: apex_tpu/multi_tensor/segmented.py `_small_segment_pass`
// (kernel :126, `pallas_call` :325). A segment is `seg_elems` consecutive
// elements; every small leaf lives inside one segment and owns a "slot"
// there (the `slot_ids` map gives the slot of each 2048-element subtile,
// -1 for padding). The reference runs a grid of (segment, phase, chunk)
// in order on one TPU core: phase 0 streams p, m, v, g, writes m' and v',
// keeps u (and p) resident in VMEM and sums each slot's |p|^2, |u|^2
// (and |g|^2); phase 1 turns the sums into trust ratios (:207-214) and
// writes p' from VMEM. 7 memory accesses an element (8 without the p
// stash) instead of the two-stage path's 10.
//
// What differs on the card: a block has at most 227 KB of shared memory
// (less than one 65,536-element fp32 chunk of u), and blocks run in no
// order, so "phase 1 after the whole segment's phase 0" has no meaning
// between independent blocks.
//
// A bf16 master (the reference's `sr_seed`, :235-261) reads p as bf16
// (its fp32 stash is exact) and writes p' with stochastic rounding, the
// reference's murmur3 bits of each element's global flat index
// (csrc/sr_common.cuh `sr_bits_murmur`). `u_bf16` (the reference's
// `u_dtype=bfloat16`, :105-109, :313) stashes u rounded to bf16, half the
// shared memory, and reads it back as fp32 for p - (lr * ratio) * u; the
// sums of |u|^2 are taken from the fp32 u before the rounding, as the
// reference takes them.
//
// Design: one thread-block cluster of 8 blocks per small segment. Each
// block takes one eighth of the segment and keeps its u (and p, with
// stash_p) in its own shared memory. Phase 0: a warp per subtile, as in
// csrc/fused_lamb.cu's stage 1 (same math, csrc/lamb_common.cuh, so m'
// and v' are bitwise the plain version's); the subtiles' sums go into
// the block's per-slot sums in subtile order by one thread. Then
// cluster.sync(): every block adds the eight blocks' per-slot sums
// through distributed shared memory, in rank order (so all eight compute
// the same ratios, and the same card gives the same bits every run), and
// computes the trust ratios with the reference's rule, the wd == 0 /
// NVLAMB case included. Phase 1 writes p' = p - (lr * ratio) * u from
// shared memory (p re-read from device memory without the stash: the
// thread that reads an element is the one that writes it). A closing
// cluster.sync() keeps each block's shared memory alive until the others
// have read it. Memory accesses: the reference's 7 an element (8 without
// stash_p). Bound on the card: memory, 28 bytes an element (32 without
// the stash).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lamb_common.cuh"
#include "sr_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 256;

struct SegArgs {
  LambScalars s;
  float inv_val;
  int use_nvlamb, wd_is_zero;
};

__device__ __forceinline__ float sqf(float x) { return __fmul_rn(x, x); }

// p' of a float master: stored as it is; of a bf16 master: stochastically
// rounded with the murmur3 bits of the global flat index (the reference's
// stream, segmented.py:235-261)
__device__ __forceinline__ void seg_store4(float* p, int64_t i, float4 v,
                                           uint32_t) {
  *reinterpret_cast<float4*>(p + i) = v;
}
__device__ __forceinline__ void seg_store4(__nv_bfloat16* p, int64_t i,
                                           float4 v, uint32_t seed) {
  const uint32_t a = __bfloat16_as_ushort(
      sr_to_bf16(v.x, sr_bits_murmur(seed, i)));
  const uint32_t b = __bfloat16_as_ushort(
      sr_to_bf16(v.y, sr_bits_murmur(seed, i + 1)));
  const uint32_t c = __bfloat16_as_ushort(
      sr_to_bf16(v.z, sr_bits_murmur(seed, i + 2)));
  const uint32_t d = __bfloat16_as_ushort(
      sr_to_bf16(v.w, sr_bits_murmur(seed, i + 3)));
  *reinterpret_cast<uint2*>(p + i) = make_uint2(a | (b << 16), c | (d << 16));
}

// the update term's stash: fp32, or bf16 rounded to nearest (the
// reference's `u.astype(u_buf.dtype)`)
__device__ __forceinline__ void stash4(float* u, int64_t q, float4 v) {
  reinterpret_cast<float4*>(u)[q] = v;
}
__device__ __forceinline__ void stash4(__nv_bfloat16* u, int64_t q,
                                       float4 v) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(v.x));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v.y));
  const uint32_t c = __bfloat16_as_ushort(__float2bfloat16_rn(v.z));
  const uint32_t d = __bfloat16_as_ushort(__float2bfloat16_rn(v.w));
  reinterpret_cast<uint2*>(u)[q] = make_uint2(a | (b << 16), c | (d << 16));
}

// dynamic shared memory: u[E] of TU, p[E] fp32 (stash only), then, in
// floats, acc[4 * max_slots] (|p|^2, |u|^2, |g|^2 per slot, then the
// ratios), then sub[3 * nsub] (the block's per-subtile sums).
// TP: the parameter buffer's type (float, or __nv_bfloat16 for a bf16
// master written with stochastic rounding, seed `sr_seed`).
template <bool kStashP, typename TP, typename TU>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    segment_kernel(const TP* p, const float* m, const float* v,
                   const float* __restrict__ g, TP* p_out, float* m_out,
                   float* v_out, float* __restrict__ found,
                   float* __restrict__ gg_out,
                   const int* __restrict__ small_segments,
                   const int* __restrict__ slot_ids, int64_t seg_elems,
                   int max_slots, SegArgs a,
                   const float* __restrict__ inv_ptr, uint32_t sr_seed) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int s_idx = blockIdx.x / kCluster;
  const int64_t E = seg_elems / kCluster;           // elements a block
  const int nsub = (int)(E / kSubtile);
  const int64_t base = (int64_t)small_segments[s_idx] * seg_elems + rank * E;
  const int* ids = slot_ids + (int64_t)s_idx * (seg_elems / kSubtile) +
                   (int64_t)rank * nsub;
  TU* u_buf = reinterpret_cast<TU*>(smem);
  float* p_buf = reinterpret_cast<float*>(smem + E * sizeof(TU));
  float* acc = reinterpret_cast<float*>(smem + E * sizeof(TU) +
                                        (kStashP ? E * 4 : 0));
  float* ratio = acc + 3 * max_slots;
  float* sub = acc + 4 * max_slots;
  const float inv = inv_ptr != nullptr ? *inv_ptr : a.inv_val;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < 4 * max_slots; i += kThreads) acc[i] = 0.0f;

  // phase 0: m', v' out; u (and p) into shared memory; per-subtile sums
  bool bad = false;
  for (int t = warp; t < nsub; t += kThreads / 32) {
    float pp = 0.0f, uu = 0.0f, gg = 0.0f;
    for (int j = 0; j < kSubtileVecsPerLane; ++j) {
      const int64_t le = (int64_t)t * kSubtile + (int64_t)(j * 32 + lane) * 4;
      const int64_t e = base + le;
      const float4 pv = load4(p, e);
      float4 mv = *reinterpret_cast<const float4*>(m + e);
      float4 vv = *reinterpret_cast<const float4*>(v + e);
      const float4 gv = *reinterpret_cast<const float4*>(g + e);
      bad |= !isfinite(gv.x) || !isfinite(gv.y) || !isfinite(gv.z) ||
             !isfinite(gv.w);
      float4 uv;
      uv.x = lamb_stage1_one(pv.x, mv.x, vv.x, gv.x, inv, a.s);
      uv.y = lamb_stage1_one(pv.y, mv.y, vv.y, gv.y, inv, a.s);
      uv.z = lamb_stage1_one(pv.z, mv.z, vv.z, gv.z, inv, a.s);
      uv.w = lamb_stage1_one(pv.w, mv.w, vv.w, gv.w, inv, a.s);
      *reinterpret_cast<float4*>(m_out + e) = mv;
      *reinterpret_cast<float4*>(v_out + e) = vv;
      stash4(u_buf, le / 4, uv);
      if (kStashP) reinterpret_cast<float4*>(p_buf)[le / 4] = pv;
      pp = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(pp, sqf(pv.x)),
                                         sqf(pv.y)), sqf(pv.z)), sqf(pv.w));
      uu = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(uu, sqf(uv.x)),
                                         sqf(uv.y)), sqf(uv.z)), sqf(uv.w));
      gg = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(gg, sqf(gv.x)),
                                         sqf(gv.y)), sqf(gv.z)), sqf(gv.w));
    }
    pp = warp_sum(pp);
    uu = warp_sum(uu);
    gg = warp_sum(gg);
    if (lane == 0) {
      sub[3 * t] = pp;
      sub[3 * t + 1] = uu;
      sub[3 * t + 2] = gg;
    }
  }
  if (bad) *found = 1.0f;
  __syncthreads();
  if (threadIdx.x == 0) {                   // per-slot sums, subtile order
    for (int t = 0; t < nsub; ++t) {
      const int sl = ids[t];
      if (sl < 0) continue;
      acc[sl] = __fadd_rn(acc[sl], sub[3 * t]);
      acc[max_slots + sl] = __fadd_rn(acc[max_slots + sl], sub[3 * t + 1]);
      acc[2 * max_slots + sl] =
          __fadd_rn(acc[2 * max_slots + sl], sub[3 * t + 2]);
    }
  }
  cluster.sync();                           // every block's phase 0 done

  // the segment's per-slot sums, blocks in rank order; the trust ratios
  for (int sl = threadIdx.x; sl < max_slots; sl += kThreads) {
    float tp = 0.0f, tu = 0.0f, tg = 0.0f;
    for (int r = 0; r < kCluster; ++r) {
      const float* ra = cluster.map_shared_rank(acc, r);
      tp = __fadd_rn(tp, ra[sl]);
      tu = __fadd_rn(tu, ra[max_slots + sl]);
      tg = __fadd_rn(tg, ra[2 * max_slots + sl]);
    }
    const float wn = __fsqrt_rn(tp), un = __fsqrt_rn(tu);
    float r_ = (wn > 0.0f && un > 0.0f) ? __fdiv_rn(wn, un) : 1.0f;
    if (!a.use_nvlamb && a.wd_is_zero) r_ = 1.0f;
    ratio[sl] = r_;
    if (rank == 0 && gg_out != nullptr)
      gg_out[(int64_t)s_idx * max_slots + sl] = tg;
  }
  __syncthreads();

  // phase 1: p' from shared memory
  const int64_t E4 = E / 4;
  for (int64_t q = threadIdx.x; q < E4; q += kThreads) {
    const int sl = ids[(q * 4) / kSubtile];
    const float lr_r = __fmul_rn(a.s.lr, sl >= 0 ? ratio[sl] : 0.0f);
    const float4 uv = load4(u_buf, q * 4);
    const float4 pv = kStashP ? reinterpret_cast<const float4*>(p_buf)[q]
                              : load4(p, base + q * 4);
    float4 o;
    o.x = __fsub_rn(pv.x, __fmul_rn(lr_r, uv.x));
    o.y = __fsub_rn(pv.y, __fmul_rn(lr_r, uv.y));
    o.z = __fsub_rn(pv.z, __fmul_rn(lr_r, uv.z));
    o.w = __fsub_rn(pv.w, __fmul_rn(lr_r, uv.w));
    seg_store4(p_out, base + q * 4, o, sr_seed);
  }
  cluster.sync();       // others may still read this block's sums
}

template <bool kStashP, typename TP, typename TU>
int launch(const void* p, const float* m, const float* v, const float* g,
           void* p_out, float* m_out, float* v_out, float* found,
           float* gg_out, const int* small_segments, const int* slot_ids,
           int n_small, int64_t seg_elems, int max_slots, SegArgs a,
           const float* inv_ptr, uint32_t sr_seed, size_t smem,
           cudaStream_t stream) {
  // raised once per size (so a launch captured into a CUDA graph after a
  // first eager call makes no attribute call)
  static size_t allowed = 0;
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        segment_kernel<kStashP, TP, TU>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  segment_kernel<kStashP, TP, TU>
      <<<n_small * kCluster, kThreads, smem, stream>>>(
          static_cast<const TP*>(p), m, v, g, static_cast<TP*>(p_out), m_out,
          v_out, found, gg_out, small_segments, slot_ids, seg_elems,
          max_slots, a, inv_ptr, sr_seed);
  return (int)cudaGetLastError();
}

template <bool kStashP, typename TP>
int launch_u(int u_bf16, const void* p, const float* m, const float* v,
             const float* g, void* p_out, float* m_out, float* v_out,
             float* found, float* gg_out, const int* small_segments,
             const int* slot_ids, int n_small, int64_t seg_elems,
             int max_slots, SegArgs a, const float* inv_ptr, uint32_t sr_seed,
             size_t smem, cudaStream_t stream) {
  if (u_bf16)
    return launch<kStashP, TP, __nv_bfloat16>(
        p, m, v, g, p_out, m_out, v_out, found, gg_out, small_segments,
        slot_ids, n_small, seg_elems, max_slots, a, inv_ptr, sr_seed, smem,
        stream);
  return launch<kStashP, TP, float>(
      p, m, v, g, p_out, m_out, v_out, found, gg_out, small_segments,
      slot_ids, n_small, seg_elems, max_slots, a, inv_ptr, sr_seed, smem,
      stream);
}

}  // namespace

// The shared memory a block of the segment kernel takes, in bytes (the
// wrapper checks the same count, flat_buffer.segment_smem_bytes, against
// the card's limit before the launch).
static int64_t segment_smem(int64_t seg_elems, int max_slots, int stash_p,
                            int u_bf16) {
  const int64_t E = seg_elems / kCluster;
  return (u_bf16 ? 2 : 4) * E + (stash_p ? 4 * E : 0) +
         4 * (4 * (int64_t)max_slots + 3 * (E / kSubtile));
}

// p, m, v, g: the whole flat buffers (16-byte aligned; p fp32, or bf16
// with p_bf16; the rest fp32); p_out, m_out, v_out: the same size and
// types, each its input (in place) or a separate buffer; only the small
// segments are read and written. found: one fp32 the caller zeroed.
// gg_out: n_small * max_slots fp32 per-slot sums of g^2, or null.
// small_segments: n_small int32 segment indices; slot_ids: n_small *
// (seg_elems / 2048) int32 slots (-1 = padding). seg_elems: a multiple of
// 8 * 2048. inv_ptr: the gradient divisor in device memory, or null to
// use inv_val. p_bf16: a bf16 master, p' written with stochastic rounding
// (the murmur3 stream of sr_seed over the global flat index). u_bf16:
// the update term stashed in bf16 (rounded to nearest).
extern "C" int apex_lamb_segment(
    const void* p, const void* m, const void* v, const void* g, void* p_out,
    void* m_out, void* v_out, void* found, void* gg_out,
    const void* small_segments, const void* slot_ids, int n_small,
    int64_t seg_elems, int max_slots, float b1, float b2, float beta3,
    float eps, float wd, float bc1, float bc2, float lr, float inv_val,
    const void* inv_ptr, int adam_w, int use_nvlamb, int wd_is_zero,
    int stash_p, int p_bf16, int u_bf16, uint32_t sr_seed, void* stream) {
  if (n_small <= 0) return (int)cudaGetLastError();
  if (seg_elems % ((int64_t)kCluster * kSubtile)) return (int)cudaErrorInvalidValue;
  SegArgs a{{b1, b2, beta3, eps, wd, bc1, bc2, lr, adam_w}, inv_val,
            use_nvlamb, wd_is_zero};
  const size_t smem =
      (size_t)segment_smem(seg_elems, max_slots, stash_p, u_bf16);
  const float* fm = static_cast<const float*>(m);
  const float* fv = static_cast<const float*>(v);
  const float* fg = static_cast<const float*>(g);
  float* fm_out = static_cast<float*>(m_out);
  float* fv_out = static_cast<float*>(v_out);
  float* ff = static_cast<float*>(found);
  float* fgg = static_cast<float*>(gg_out);
  const int* segs = static_cast<const int*>(small_segments);
  const int* slots = static_cast<const int*>(slot_ids);
  const float* ip = static_cast<const float*>(inv_ptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define APEX_SEG_LAUNCH(STASH, TP)                                          \
  return launch_u<STASH, TP>(u_bf16, p, fm, fv, fg, p_out, fm_out, fv_out, \
                             ff, fgg, segs, slots, n_small, seg_elems,     \
                             max_slots, a, ip, sr_seed, smem, st)
  if (stash_p) {
    if (p_bf16) APEX_SEG_LAUNCH(true, __nv_bfloat16);
    APEX_SEG_LAUNCH(true, float);
  }
  if (p_bf16) APEX_SEG_LAUNCH(false, __nv_bfloat16);
  APEX_SEG_LAUNCH(false, float);
#undef APEX_SEG_LAUNCH
}

extern "C" const char* apex_lamb_segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
