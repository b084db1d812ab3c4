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
// Bound on the card: memory, 28 bytes an element of the segments (32
// without the stash). At GPT-2 345M's layout (8 segments of 65,536) that
// is 4.4 us over the swept elements, less than a launch and one round
// trip to memory take, so the design is about latency: every SM busy,
// and every load of a block in flight before any of its math.
//
// Design: one thread-block cluster of 16 blocks per small segment (a
// non-portable cluster size). Two blocks fit an SM, and 14 such clusters
// are resident at once (`apex_lamb_segment_route` reports it), so 8 or 9
// segments are one wave. A 16-block cluster lives in one GPC, and on an
// H100 SXM only 112 of the 132 SMs lie in GPCs of 16 or more: at GPT-2
// 345M's 8 segments 96 SMs hold one block and 16 hold two (BERT-Large's
// 9: 80 and 32), and the kernel's time is that of a cluster whose blocks
// share SMs. Clusters of 8 would put one block on each of only 64-72 SMs,
// and one block an SM leaves room for 7 clusters (two waves); both were
// slower on the card (PERF.md). Each block takes one sixteenth of the
// segment, in rounds of 4096 elements: a lane loads its four float4s of
// p, m, v and g (sixteen 16-byte loads in flight a lane, 64 KB a block)
// before it does any math, then writes m' and v' and keeps u (and p, with
// stash_p) in its block's shared memory. Every warp works on every
// round; a subtile is four warps' 512 elements.
//
// The per-slot sums, one fixed tree, the same on every call and under
// graph capture (no atomics): a lane adds the squares of its 16 elements
// of a round in order (its four float4s, each x, y, z, w) from +0; the
// warp adds its lanes by the xor butterfly (16, 8, 4, 2, 1); a subtile's
// sum is ((w0 + w1) + w2) + w3 over its four warps; a block adds its
// subtiles' sums into its per-slot sums in subtile order, from +0; after
// cluster.sync() the segment's sum of a slot is the sixteen blocks'
// per-slot sums added in rank order from +0, read through distributed
// shared memory. The plain version (multi_tensor/segmented.py
// `_slot_sums`) takes the same order, so the sums, the ratios and p' are
// bitwise the kernel's. Each block computes the ratio of each of its
// subtiles' slots (every block holding a piece of a slot computes the
// same bits; no third cluster barrier to hand ratios out), and, with
// gg_out, block r writes the g^2 sums of slots r, r + 16, .... Phase 1
// writes p' = p - (lr * ratio) * u from shared memory (p re-read from
// device memory without the stash: the thread that reads an element is
// the one that writes it). The barrier that keeps each block's sums alive
// until the others have read them is split: each block arrives once its
// reads are done and waits only at its end, so phase 1 overlaps it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "lamb_common.cuh"
#include "sr_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;                  // blocks a segment
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                       // float4s of each input a lane
constexpr int kWarpElems = 32 * kVec * 4;     // 512: a warp's elements a round
constexpr int kRound = kWarps * kWarpElems;   // 4096: a block's a round
constexpr int kWarpsPerSub = kSubtile / kWarpElems;   // 4

struct SegArgs {
  LambScalars s;
  float inv_val;
  int use_nvlamb, wd_is_zero;
};

__device__ __forceinline__ float sqf(float x) { return __fmul_rn(x, x); }

__device__ __forceinline__ float add_sq4(float acc, float4 x) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, sqf(x.x)), sqf(x.y)),
                             sqf(x.z)), sqf(x.w));
}

// the two halves of a cluster barrier (cluster.sync() is both at once)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

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
// floats, acc[3 * max_slots] (the block's |p|^2, |u|^2, |g|^2 per slot),
// wsum[3 * E / 512] (each warp's sums a round) and lr_sub[E / 2048] (lr
// times the ratio of each subtile's slot, 0 for padding).
// TP: the parameter buffer's type (float, or __nv_bfloat16 for a bf16
// master written with stochastic rounding, seed `sr_seed`).
template <bool kStashP, typename TP, typename TU>
__global__ void __launch_bounds__(kThreads, 2)
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
  const int nchunk = (int)(E / kWarpElems);         // warp rounds a block
  const int64_t base = (int64_t)small_segments[s_idx] * seg_elems + rank * E;
  const int* ids = slot_ids + (int64_t)s_idx * (seg_elems / kSubtile) +
                   (int64_t)rank * nsub;
  TU* u_buf = reinterpret_cast<TU*>(smem);
  float* p_buf = reinterpret_cast<float*>(smem + E * sizeof(TU));
  float* acc = reinterpret_cast<float*>(smem + E * sizeof(TU) +
                                        (kStashP ? E * 4 : 0));
  float* wsum = acc + 3 * max_slots;
  float* lr_sub = wsum + 3 * nchunk;
  const float inv = inv_ptr != nullptr ? *inv_ptr : a.inv_val;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < 3 * max_slots; i += kThreads) acc[i] = 0.0f;

  // phase 0: a round's loads all issued, then m', v' out, u (and p) into
  // shared memory, and each warp's sums
  bool bad = false;
  for (int64_t r0 = 0; r0 < E; r0 += kRound) {
    const int64_t l0 = r0 + warp * kWarpElems + lane * 4;
    float4 pv[kVec], mv[kVec], vv[kVec], gv[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int64_t e = base + l0 + j * 128;
      pv[j] = load4(p, e);
      mv[j] = *reinterpret_cast<const float4*>(m + e);
      vv[j] = *reinterpret_cast<const float4*>(v + e);
      gv[j] = *reinterpret_cast<const float4*>(g + e);
    }
    float pp = 0.0f, uu = 0.0f, gg = 0.0f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int64_t le = l0 + j * 128;
      const int64_t e = base + le;
      bad |= !isfinite(gv[j].x) || !isfinite(gv[j].y) ||
             !isfinite(gv[j].z) || !isfinite(gv[j].w);
      float4 uv;
      uv.x = lamb_stage1_one(pv[j].x, mv[j].x, vv[j].x, gv[j].x, inv, a.s);
      uv.y = lamb_stage1_one(pv[j].y, mv[j].y, vv[j].y, gv[j].y, inv, a.s);
      uv.z = lamb_stage1_one(pv[j].z, mv[j].z, vv[j].z, gv[j].z, inv, a.s);
      uv.w = lamb_stage1_one(pv[j].w, mv[j].w, vv[j].w, gv[j].w, inv, a.s);
      *reinterpret_cast<float4*>(m_out + e) = mv[j];
      *reinterpret_cast<float4*>(v_out + e) = vv[j];
      stash4(u_buf, le / 4, uv);
      if (kStashP) reinterpret_cast<float4*>(p_buf)[le / 4] = pv[j];
      pp = add_sq4(pp, pv[j]);
      uu = add_sq4(uu, uv);
      gg = add_sq4(gg, gv[j]);
    }
    pp = warp_sum(pp);
    uu = warp_sum(uu);
    gg = warp_sum(gg);
    if (lane == 0) {
      const int c = (int)(r0 / kWarpElems) + warp;
      wsum[c] = pp;
      wsum[nchunk + c] = uu;
      wsum[2 * nchunk + c] = gg;
    }
  }
  if (bad) *found = 1.0f;
  __syncthreads();
  if (threadIdx.x < 3) {          // the block's per-slot sums, one a thread
    const float* w = wsum + threadIdx.x * nchunk;
    float* slot_acc = acc + threadIdx.x * max_slots;
    for (int t = 0; t < nsub; ++t) {
      const int sl = ids[t];
      if (sl < 0) continue;
      const float* wt = w + t * kWarpsPerSub;
      float sub = wt[0];
      for (int k = 1; k < kWarpsPerSub; ++k) sub = __fadd_rn(sub, wt[k]);
      slot_acc[sl] = __fadd_rn(slot_acc[sl], sub);
    }
  }
  cluster.sync();                           // every block's sums are in

  // the segment's sums, blocks in rank order: lr * ratio of each subtile
  for (int t = threadIdx.x; t < nsub; t += kThreads) {
    const int sl = ids[t];
    float lr_r = 0.0f;
    if (sl >= 0) {
      float tp = 0.0f, tu = 0.0f;
      for (int r = 0; r < kCluster; ++r) {
        const float* ra = cluster.map_shared_rank(acc, r);
        tp = __fadd_rn(tp, ra[sl]);
        tu = __fadd_rn(tu, ra[max_slots + sl]);
      }
      const float wn = __fsqrt_rn(tp), un = __fsqrt_rn(tu);
      float r_ = (wn > 0.0f && un > 0.0f) ? __fdiv_rn(wn, un) : 1.0f;
      if (!a.use_nvlamb && a.wd_is_zero) r_ = 1.0f;
      lr_r = __fmul_rn(a.s.lr, r_);
    }
    lr_sub[t] = lr_r;
  }
  if (gg_out != nullptr) {
    for (int sl = rank + kCluster * threadIdx.x; sl < max_slots;
         sl += kCluster * kThreads) {
      float tg = 0.0f;
      for (int r = 0; r < kCluster; ++r)
        tg = __fadd_rn(tg, cluster.map_shared_rank(acc, r)[2 * max_slots + sl]);
      gg_out[(int64_t)s_idx * max_slots + sl] = tg;
    }
  }
  __syncthreads();
  cluster_arrive();           // done reading the other blocks' sums

  // phase 1: p' from shared memory
  for (int64_t r0 = 0; r0 < E; r0 += kRound) {
    const int64_t l0 = r0 + warp * kWarpElems + lane * 4;
    const float lr_r = lr_sub[l0 / kSubtile];
    float4 pv[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      pv[j] = kStashP
                  ? reinterpret_cast<const float4*>(p_buf)[(l0 + j * 128) / 4]
                  : load4(p, base + l0 + j * 128);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int64_t le = l0 + j * 128;
      const float4 uv = load4(u_buf, le);
      float4 o;
      o.x = __fsub_rn(pv[j].x, __fmul_rn(lr_r, uv.x));
      o.y = __fsub_rn(pv[j].y, __fmul_rn(lr_r, uv.y));
      o.z = __fsub_rn(pv[j].z, __fmul_rn(lr_r, uv.z));
      o.w = __fsub_rn(pv[j].w, __fmul_rn(lr_r, uv.w));
      seg_store4(p_out, base + le, o, sr_seed);
    }
  }
  cluster_wait();             // the others may still read this block's sums
}

// The shared memory a block takes, in bytes (the wrapper checks the same
// count, flat_buffer.segment_smem_bytes, against the card's limit first).
int64_t segment_smem(int64_t seg_elems, int max_slots, int stash_p,
                     int u_bf16) {
  const int64_t E = seg_elems / kCluster;
  return (u_bf16 ? 2 : 4) * E + (stash_p ? 4 * E : 0) +
         4 * (3 * (int64_t)max_slots + 3 * (E / kWarpElems) + E / kSubtile);
}

template <bool kStashP, typename TP, typename TU>
struct Variant {
  // The launch config of n_small clusters of kCluster blocks.
  static cudaLaunchConfig_t config(int n_small, size_t smem,
                                   cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(n_small * kCluster), 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = kCluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }

  // The clusters resident at once at `smem` bytes a block (cached per
  // device, so a launch captured into a CUDA graph after a first eager
  // call makes no attribute or occupancy call). 0 with `*err` set when the
  // attributes cannot be set; 0 alone when no cluster fits the card.
  static int resident_clusters(size_t smem, cudaError_t* err) {
    constexpr int kDevices = 64;
    static std::atomic<unsigned long long> cached[kDevices];
    auto kernel = segment_kernel<kStashP, TP, TU>;
    int dev = 0;
    *err = cudaGetDevice(&dev);
    if (*err != cudaSuccess) return 0;
    const unsigned long long key = (unsigned long long)(smem + 1) << 32;
    const bool cacheable = dev >= 0 && dev < kDevices;
    if (cacheable) {
      const unsigned long long got =
          cached[dev].load(std::memory_order_relaxed);
      if ((got >> 32) << 32 == key) return (int)(got & 0xffffffffu);
    }
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (*err == cudaSuccess)
      *err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int n = 0;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config(1, smem, nullptr, &attr);
    if (*err == cudaSuccess)
      *err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (*err != cudaSuccess) return 0;
    if (cacheable) cached[dev].store(key | (unsigned)n,
                                     std::memory_order_relaxed);
    return n;
  }

  static int launch(const void* p, const float* m, const float* v,
                    const float* g, void* p_out, float* m_out, float* v_out,
                    float* found, float* gg_out, const int* small_segments,
                    const int* slot_ids, int n_small, int64_t seg_elems,
                    int max_slots, SegArgs a, const float* inv_ptr,
                    uint32_t sr_seed, size_t smem, cudaStream_t stream) {
    cudaError_t err = cudaSuccess;
    if (resident_clusters(smem, &err) < 1)
      return (int)(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(n_small, smem, stream, &attr);
    err = cudaLaunchKernelEx(
        &cfg, segment_kernel<kStashP, TP, TU>, static_cast<const TP*>(p), m,
        v, g, static_cast<TP*>(p_out), m_out, v_out, found, gg_out,
        small_segments, slot_ids, seg_elems, max_slots, a, inv_ptr, sr_seed);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }

  // out: cluster size, clusters resident at once, blocks an SM, registers
  // a thread, local (spilled) bytes a thread, shared bytes a block
  static int route(size_t smem, int* out) {
    cudaError_t err = cudaSuccess;
    out[0] = kCluster;
    out[1] = resident_clusters(smem, &err);
    if (err != cudaSuccess) return (int)err;
    auto kernel = segment_kernel<kStashP, TP, TU>;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                        kThreads, smem);
    cudaFuncAttributes fa;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return (int)err;
    out[3] = fa.numRegs;
    out[4] = (int)fa.localSizeBytes;
    out[5] = (int)smem;
    return 0;
  }
};

// f(Variant<...>{}) for the variant the flags name
template <typename F>
int with_variant(int stash_p, int p_bf16, int u_bf16, F&& f) {
  using bf = __nv_bfloat16;
  if (stash_p) {
    if (p_bf16)
      return u_bf16 ? f(Variant<true, bf, bf>{})
                    : f(Variant<true, bf, float>{});
    return u_bf16 ? f(Variant<true, float, bf>{})
                  : f(Variant<true, float, float>{});
  }
  if (p_bf16)
    return u_bf16 ? f(Variant<false, bf, bf>{})
                  : f(Variant<false, bf, float>{});
  return u_bf16 ? f(Variant<false, float, bf>{})
                : f(Variant<false, float, float>{});
}

}  // namespace

// p, m, v, g: the whole flat buffers (16-byte aligned; p fp32, or bf16
// with p_bf16; the rest fp32); p_out, m_out, v_out: the same size and
// types, each its input (in place) or a separate buffer; only the small
// segments are read and written. found: one fp32 the caller zeroed.
// gg_out: n_small * max_slots fp32 per-slot sums of g^2, or null.
// small_segments: n_small int32 segment indices; slot_ids: n_small *
// (seg_elems / 2048) int32 slots (-1 = padding). seg_elems: a multiple of
// 16 * 4096. inv_ptr: the gradient divisor in device memory, or null to
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
  if (seg_elems % ((int64_t)kCluster * kRound))
    return (int)cudaErrorInvalidValue;
  const SegArgs a{{b1, b2, beta3, eps, wd, bc1, bc2, lr, adam_w}, inv_val,
                  use_nvlamb, wd_is_zero};
  const size_t smem =
      (size_t)segment_smem(seg_elems, max_slots, stash_p, u_bf16);
  return with_variant(stash_p, p_bf16, u_bf16, [&](auto variant) {
    return decltype(variant)::launch(
        p, static_cast<const float*>(m), static_cast<const float*>(v),
        static_cast<const float*>(g), p_out, static_cast<float*>(m_out),
        static_cast<float*>(v_out), static_cast<float*>(found),
        static_cast<float*>(gg_out), static_cast<const int*>(small_segments),
        static_cast<const int*>(slot_ids), n_small, seg_elems, max_slots, a,
        static_cast<const float*>(inv_ptr), sr_seed, smem,
        static_cast<cudaStream_t>(stream));
  });
}

// The launch's route for these flags: out[6] as Variant::route fills it.
extern "C" int apex_lamb_segment_route(int64_t seg_elems, int max_slots,
                                       int stash_p, int p_bf16, int u_bf16,
                                       void* out) {
  const size_t smem =
      (size_t)segment_smem(seg_elems, max_slots, stash_p, u_bf16);
  return with_variant(stash_p, p_bf16, u_bf16, [&](auto variant) {
    return decltype(variant)::route(smem, static_cast<int*>(out));
  });
}

extern "C" const char* apex_lamb_segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
