// How many blocks of a kernel the card keeps resident at once: the grid
// of a kernel that walks its work in a grid stride (the streaming
// LayerNorm kernels, the softmax forwards' row path).

#pragma once

#include <cuda_runtime.h>

#include <atomic>

// The blocks of `kKernel` the current device keeps resident at `threads`
// threads and `smem` bytes of dynamic shared memory, whose limit is raised
// to `smem` first. Computed once a device for the last `smem` asked (the
// row kernels of the warp paths ask one size; the block path's depends on
// h). Returns 0 with *err set after a failed query.
template <auto kKernel>
int resident_blocks(int threads, int smem, cudaError_t* err) {
  constexpr int kDevices = 64;
  // (smem + 1) << 32 | blocks, 0 before the first query
  static std::atomic<unsigned long long> cached[kDevices];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  const unsigned long long key = (unsigned long long)(smem + 1) << 32;
  const bool cacheable = dev >= 0 && dev < kDevices;
  if (cacheable) {
    const unsigned long long got = cached[dev].load(std::memory_order_relaxed);
    if ((got >> 32) << 32 == key) return (int)(got & 0xffffffffu);
  }
  int sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess && smem > 0)
    *err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel,
                                                         threads, smem);
  if (*err != cudaSuccess) return 0;
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (cacheable) cached[dev].store(key | (unsigned)blocks,
                                   std::memory_order_relaxed);
  return blocks;
}
