// Per-tile sums of squares of a flat fp32 or bf16 buffer for Hopper (sm_90a).
//
// Replaces: apex_tpu/multi_tensor/engine.py `fused_sumsq_partials`, both
// of its Pallas kernels: `kernel` (:519, `pallas_call` :528), sum of x^2
// per tile, and `scaled_kernel` (:543, `pallas_call` :557), sum of
// (s * x)^2 with the scale s read from a scalar in device memory (the
// fused train step's unscale, so no unscaled copy is ever written, and
// a clip factor computed on the device is never read on the host). The
// reference returns one partial per tile of `tile_rows * 128` elements;
// the finishing sum (a global norm or a per-tensor segment sum) is plain
// PyTorch, as the reference leaves it to XLA.
//
// A bf16 buffer (a bf16 master's ||p||, which LARS reads) is read as
// fp32, as the reference's `astype(float32)` reads it.
//
// Bound on the card: memory. It reads each element once (4 bytes) and
// does two fp32 operations on it; GPT-2 345M's flat gradient (355 M
// elements, 1.42 GB) takes 0.424 ms at 3.35 TB/s.
//
// Design: one block of 256 threads per tile; each thread walks the tile
// in 16-byte loads with a stride of the block, keeps its own running
// sum, and the block adds its threads' sums in a fixed tree (warp
// shuffles, then the eight warp sums in order by one thread). One writer
// per partial and no atomics, so the same card gives the same bits on
// every run. A tile that runs past the end of the buffer stops at it.
//
// Also the finishing sum by leaf that the per-tensor norms take
// (`leaf_sum_kernel`; the reference's `jax.ops.segment_sum` over
// `tile_leaf_ids`, in XLA outside any `pallas_call`): each leaf's
// per-subtile partials lie in one contiguous run, summed in one
// documented order, so two runs and the plain version
// (`engine._leaf_sum_torch`) agree bit for bit, which atomics into one
// float per leaf (`index_add_`) never did. Bound: memory, one read of the
// partials (GPT-2 345M: 173 k floats, 0.2 us at 3.35 TB/s), far under a
// launch: the kernel is launch- and latency-bound, and its lever is the
// longest run (GPT-2 345M's embedding, 25,152 partials): one block alone
// would walk it in ~98 strided loads a thread.
// Design: a run is cut into chunks of 2048 partials (an empty run is one
// chunk), one block of 256 threads a chunk, which reads its span of the
// partials and its leaf from one 16-byte descriptor. The order: thread i of a
// chunk adds its elements i, i + 256, ..., i + 1792 (eight loads in
// flight, absent ones +0) in turn to its own sum from +0; a halving tree
// over the 256 sums, v[i] += v[i + s] for s = 128, 64, ..., 1, gives the
// chunk's sum; the leaf's sum is its chunks' sums added in chunk order,
// ((c0 + c1) + c2) + .... A leaf of one chunk writes c0. A leaf of more
// writes each chunk's sum to `partial`, and the block that finishes the
// leaf's chunks last (a per-leaf counter, not a sum: one acquire-release
// atomic add a block) adds them in chunk order and resets the counter for
// the next launch, so a leaf is finished within the same launch, with no
// atomic into a sum, and a CUDA graph replays it unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sq(float x, float s, bool scaled) {
  const float y = scaled ? __fmul_rn(x, s) : x;
  return __fmul_rn(y, y);
}

// T: the buffer's type, float or __nv_bfloat16 (a bf16 master's
// ||p||, read as fp32)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const T* __restrict__ x, float* __restrict__ partials,
                 int64_t n, int64_t tile, const float* __restrict__ scale) {
  const bool scaled = scale != nullptr;
  const float s = scaled ? *scale : 1.0f;
  const int64_t start = (int64_t)blockIdx.x * tile;
  const int64_t lim = (n - start < tile) ? n - start : tile;
  const T* base = x + start;
  float acc = 0.0f;
  const int64_t nv = lim / 4;
  for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
    const float4 v = load4(base, i * 4);
    acc = __fadd_rn(acc, sq(v.x, s, scaled));
    acc = __fadd_rn(acc, sq(v.y, s, scaled));
    acc = __fadd_rn(acc, sq(v.z, s, scaled));
    acc = __fadd_rn(acc, sq(v.w, s, scaled));
  }
  for (int64_t i = nv * 4 + threadIdx.x; i < lim; i += kThreads)
    acc = __fadd_rn(acc, sq(load1(base, i), s, scaled));
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  __shared__ float warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w)
      total = __fadd_rn(total, warp_sums[w]);
    partials[blockIdx.x] = total;
  }
}

constexpr int kLeafThreads = 256;
constexpr int kLeafPer = 8;                             // loads a thread
constexpr int kLeafChunk = kLeafThreads * kLeafPer;     // 2048 partials

// spans: (n_chunks, 4) int32 [lo, hi, leaf, (c << 16) | n] of each block:
// its partials [lo, hi) of x, its leaf, its chunk c within the leaf and
// the leaf's chunk count n (one load, so the block's loads of x wait on
// no other); partial: n_chunks fp32 scratch; count: (leaves,) uint32, 0
// before and after each launch; out: (leaves,) fp32.
__global__ void __launch_bounds__(kLeafThreads)
    leaf_sum_kernel(const float* __restrict__ x, const int4* __restrict__ spans,
                    float* partial, unsigned* count, float* __restrict__ out) {
  __shared__ float v[kLeafThreads];
  const int4 sp = spans[blockIdx.x];
  const int lo = sp.x, hi = sp.y, leaf = sp.z;
  float xs[kLeafPer];
#pragma unroll
  for (int k = 0; k < kLeafPer; ++k) {
    const int j = lo + (int)threadIdx.x + k * kLeafThreads;
    xs[k] = j < hi ? x[j] : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kLeafPer; ++k) acc = __fadd_rn(acc, xs[k]);
  v[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kLeafThreads / 2; s >= 32; s >>= 1) {
    if (threadIdx.x < s)
      v[threadIdx.x] = __fadd_rn(v[threadIdx.x], v[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x >= 32) return;
  float t = v[threadIdx.x];
  for (int s = 16; s > 0; s >>= 1)        // lane i: v[i] + v[i + s]
    t = __fadd_rn(t, __shfl_down_sync(0xffffffffu, t, s));
  if (threadIdx.x != 0) return;
  const int c = sp.w >> 16, n_chunks = sp.w & 0xffff;
  if (n_chunks == 1) {
    out[leaf] = t;
    return;
  }
  partial[blockIdx.x] = t;
  // one atomic that releases this block's sum and acquires the others'
  unsigned done;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(done) : "l"(count + leaf) : "memory");
  if (done != (unsigned)(n_chunks - 1)) return;
  const float* mine = partial + (blockIdx.x - c);
  float total = __ldcg(mine);
  for (int k = 1; k < n_chunks; ++k) total = __fadd_rn(total, __ldcg(mine + k));
  out[leaf] = total;
  count[leaf] = 0;
}

}  // namespace

// x: n elements of dtype (0 fp32, 1 bf16), 16-byte aligned; partials:
// ceil(n / tile) fp32; tile: a multiple of 4 (so every tile's 4-element
// loads stay aligned for either dtype). scale: one fp32 in device memory, or null for no scale.
// Returns cudaGetLastError() after the launch.
extern "C" int apex_sumsq(const void* x, void* partials, int64_t n,
                          int64_t tile, const void* scale, int dtype,
                          void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t tiles = (n + tile - 1) / tile;
  if (tiles > 0x7fffffff || tile <= 0 || tile % 4 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(partials);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 1)
    sumsq_kernel<__nv_bfloat16><<<(unsigned)tiles, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), out, n, tile, sc);
  else
    sumsq_kernel<float><<<(unsigned)tiles, kThreads, 0, st>>>(
        static_cast<const float*>(x), out, n, tile, sc);
  return (int)cudaGetLastError();
}

// x: fp32 per-subtile partials; spans: (n_chunks, 4) int32, each block's
// [lo, hi, leaf, (c << 16) | n] as above (engine.leaf_sums builds it from
// the leaves' runs of partials; n < 65536); partial: n_chunks fp32 scratch;
// count: (leaves,) int32 zeros (left zero); out: (leaves,) fp32, each run
// summed in the order above (an empty run gives +0). Returns
// cudaGetLastError() after the launch.
extern "C" int apex_leaf_sum(const void* x, const void* spans, void* partial,
                             void* count, void* out, int n_chunks,
                             void* stream) {
  if (n_chunks <= 0) return (int)cudaGetLastError();
  leaf_sum_kernel<<<(unsigned)n_chunks, kLeafThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int4*>(spans),
      static_cast<float*>(partial), static_cast<unsigned*>(count),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* apex_sumsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
