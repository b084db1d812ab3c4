// fp32 -> bf16 stochastic rounding of a whole buffer for Hopper (sm_90a).
//
// Replaces: apex_tpu/multi_tensor/engine.py `stochastic_round_cast`
// (:48-67), the SR cast of the engine's xla/interpret paths (no
// `pallas_call` of its own: the XLA ops the reference composes, which on
// the card would be ~160 int64 passes of the plain version). Per element
// at flat index i, with (k0, k1) = fold_in(PRNGKey(seed), salt) computed
// on the host (csrc/sr_common.cuh):
//   y[i] = isfinite(x) ? trunc16(bits(x[i]) + (threefry(k0, k1, i) & 0xFFFF))
//                      : bf16_rn(x[i])
// bitwise the plain version's.
//
// Bound on the card: the generator's integer work. It reads 4 bytes and
// writes 2 an element (6 bytes: 2.1 ms for GPT-2 345M's 355 M elements at
// 3.35 TB/s would be 0.64 ms) against ~84 integer operations (threefry's
// 20 rounds and key injections, the add, mask and truncation): at the
// fp32 rate of 67 T operations/s, 0.45 ms; the integer pipe has half
// that rate. It is the yardstick of what threefry costs inside the
// optimizer kernels' SR outputs.
//
// Design: csrc/dropout.cu's: a grid-stride loop, four consecutive
// elements a thread an iteration (one 16-byte load, one 8-byte store),
// the key in registers; a tail of fewer than four elements takes the
// first block's first threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    sr_cast_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ y,
                   int64_t n, SrKey key) {
  const int64_t stride = (int64_t)gridDim.x * kThreads * 4;
  const int64_t n4 = n - n % 4;
  for (int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * 4; i < n4;
       i += stride)
    store4(y, i, load4(x, i), key);
  if (blockIdx.x == 0 && threadIdx.x < n - n4) {
    const int64_t i = n4 + threadIdx.x;
    store1(y, i, x[i], key);
  }
}

}  // namespace

// x: n fp32, 16-byte aligned; y: n bf16, 16-byte aligned. (k0, k1): the
// threefry key of the stream (fold_in(PRNGKey(seed), salt)). Returns
// cudaGetLastError() after the launch.
extern "C" int apex_sr_cast(const void* x, void* y, int64_t n, uint32_t k0,
                            uint32_t k1, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int64_t blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  sr_cast_kernel<<<(unsigned)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(y), n,
      SrKey{k0, k1, 0});
  return (int)cudaGetLastError();
}

extern "C" const char* apex_sr_cast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
