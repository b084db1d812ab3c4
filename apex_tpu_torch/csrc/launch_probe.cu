// Launch probes for Hopper (sm_90a): which launch shapes the card takes.
//
// Replaces the two `pallas_call` sites of tools/mosaic_probe.py, which ask
// Mosaic which BlockSpec tilings it accepts:
//   `probe` (:17, `pallas_call` :24): x * 2 over one (array, block, grid)
//   tiling. Here `probe_tiles_kernel`: one CUDA block per grid point, its
//   block of the array placed at the origin the host computed from the
//   case's index map (block index times block shape, as a BlockSpec
//   places it), elements past the array's edge masked. Beside the
//   reference's fourteen cases, `probe_launch_kernel` asks the sm_90 limits
//   the port's kernels rely on: threads per block (1024 at most), dynamic
//   shared memory (227 KB at most, past 48 KB only after
//   cudaFuncSetAttribute) and thread-block clusters (8 portable, 16 with
//   the non-portable attribute: csrc/lamb_segment.cu holds a segment in a
//   cluster's shared memory). The x * 2 goes through the shared memory it
//   asked for, and in a cluster each block writes its neighbour's slice
//   from the neighbour's shared memory (distributed shared memory), so a
//   PASS shows that the resource works, not only that the launch was
//   taken. Only invalid launch configurations are probed: their errors
//   are not sticky, and nothing here can fault on memory.
//   `probe_subtile_gather` (:80, `pallas_call` :102; kernel :92-99): the
//   engine's per-tensor pattern, a leaf id per subtile read from a small
//   table, that leaf's scalar broadcast over the subtile's rows, times x.
//   Here `probe_gather_kernel`: a block per row, each reading its
//   subtile's id and scalar itself.
//
// Bound on the card: launch overhead; the arrays are kilobytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileThreads = 256;

// x, out: (s0, s1, s2) fp32 contiguous; origins: one (o0, o1, o2) int64 per
// block; each block writes x * 2 over its (b0, b1, b2) block.
__global__ void __launch_bounds__(kTileThreads)
    probe_tiles_kernel(const float* __restrict__ x, float* __restrict__ out,
                       const long long* __restrict__ origins, int s0, int s1,
                       int s2, int b0, int b1, int b2) {
  const long long* o = origins + 3 * (long long)blockIdx.x;
  const long long count = (long long)b0 * b1 * b2;
  for (long long e = threadIdx.x; e < count; e += kTileThreads) {
    const long long i0 = o[0] + e / ((long long)b1 * b2);
    const long long i1 = o[1] + (e / b2) % b1;
    const long long i2 = o[2] + e % b2;
    if (i0 < 0 || i0 >= s0 || i1 < 0 || i1 >= s1 || i2 < 0 || i2 >= s2)
      continue;
    const long long at = (i0 * s1 + i1) * s2 + i2;
    out[at] = x[at] * 2.0f;
  }
}

// x * 2 over n elements, blockDim.x a block, staged through the dynamic
// shared memory (its last word touched too: written 0, read back, added);
// with clusters of more than one block, block r of a cluster writes the
// slice of block r + 1 (mod the cluster) from that block's shared memory.
__global__ void probe_launch_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, long long n,
                                    int smem_words, int clustered) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * blockDim.x;
  if (smem_words == 0) {
    if (base + t < n) out[base + t] = x[base + t] * 2.0f;
    return;
  }
  // the last word of the allocation, when it lies past the staged slice
  const bool tail = smem_words > (int)blockDim.x;
  if (tail && t == 0) smem[smem_words - 1] = 0.0f;
  smem[t] = base + t < n ? x[base + t] * 2.0f : 0.0f;
  __syncthreads();
  if (!clustered) {
    if (base + t < n)
      out[base + t] = smem[t] + (tail ? smem[smem_words - 1] : 0.0f);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const unsigned rank = cluster.block_rank();
  const unsigned next = (rank + 1) % cluster.num_blocks();
  const float* other = cluster.map_shared_rank(smem, next);
  const long long nbase = base + ((long long)next - rank) * blockDim.x;
  if (nbase + t < n) out[nbase + t] = other[t];
  cluster.sync();   // the neighbour's shared memory stays until all read
}

// ids: (n_tiles * sub,) int32 leaf ids; vals: leaf scalars; x, out:
// (n_tiles * tile_rows, lanes). Row r of tile i is in subtile (r % tile_rows)
// / (tile_rows / sub).
__global__ void probe_gather_kernel(const int* __restrict__ ids,
                                    const float* __restrict__ vals,
                                    const float* __restrict__ x,
                                    float* __restrict__ out, int tile_rows,
                                    int lanes, int sub) {
  const int row = blockIdx.x;
  const int tile = row / tile_rows;
  const int s = (row % tile_rows) / (tile_rows / sub);
  const float scalar = vals[ids[tile * sub + s]];
  for (int c = threadIdx.x; c < lanes; c += blockDim.x)
    out[(long long)row * lanes + c] = x[(long long)row * lanes + c] * scalar;
}

}  // namespace

// One BlockSpec case: nblocks blocks, origins (nblocks, 3) int64 in device
// memory, array (s0, s1, s2), block (b0, b1, b2). Returns
// cudaGetLastError() after the launch.
extern "C" int apex_probe_tiles(const void* x, void* out, const void* origins,
                                int nblocks, int s0, int s1, int s2, int b0,
                                int b1, int b2, void* stream) {
  if (nblocks <= 0) return (int)cudaErrorInvalidValue;
  probe_tiles_kernel<<<nblocks, kTileThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<const long long*>(origins), s0, s1, s2, b0, b1, b2);
  return (int)cudaGetLastError();
}

// One launch-limit case: n elements, `threads` a block, `smem` bytes of
// dynamic shared memory (0, or at least threads * 4), clusters of
// `cluster` blocks (1 = none; more needs smem >= threads * 4; above 8 sets
// the non-portable attribute). The grid is rounded up to whole clusters.
// Returns the first CUDA error of setting the attributes or launching (the
// refused configurations' errors are not sticky), else
// cudaGetLastError() after the launch.
extern "C" int apex_probe_launch(const void* x, void* out, long long n,
                                 int threads, int smem, int cluster,
                                 void* stream) {
  if (threads <= 0 || smem < 0 || cluster < 1 ||
      (smem > 0 && smem < threads * 4) || (cluster > 1 && smem == 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      probe_launch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(probe_launch_kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           cluster > 8 ? 1 : 0);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (n + threads - 1) / threads;
  blocks = (blocks + cluster - 1) / cluster * cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, probe_launch_kernel,
                         static_cast<const float*>(x),
                         static_cast<float*>(out), n, smem / 4,
                         cluster > 1 ? 1 : 0);
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear the (non-sticky) launch error
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// The subtile gather: n_tiles tiles of tile_rows x lanes, sub subtiles a
// tile. Returns cudaGetLastError() after the launch.
extern "C" int apex_probe_gather(const void* ids, const void* vals,
                                 const void* x, void* out, int n_tiles,
                                 int tile_rows, int lanes, int sub,
                                 void* stream) {
  if (n_tiles <= 0 || sub <= 0 || tile_rows % sub)
    return (int)cudaErrorInvalidValue;
  probe_gather_kernel<<<n_tiles * tile_rows, 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(vals),
      static_cast<const float*>(x), static_cast<float*>(out), tile_rows,
      lanes, sub);
  return (int)cudaGetLastError();
}

extern "C" const char* apex_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
