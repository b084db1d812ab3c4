// The split pass of the fp32 flash kernels: fp32 tensors into their three
// bf16 part planes, x = hi + mid + lo (`split3`, flash_common.cuh), which the
// fp32 forward (flash_fwd32_sm90.cuh) and backward (flash_bwd32_sm90.cuh)
// read by TMA for their exact products (exact32_sm90.cuh). A forward splits
// q, k and v in one launch and hands the planes to the backward, which
// splits dO alone; its own library, so that either side loads it alone.
//
// Replaces no TPU kernel: the Pallas kernels multiply fp32 tiles on the
// TPU's matrix unit directly; on Hopper an exact fp32 product is six bf16
// ones, and this pass makes their operands once per tensor instead of once
// per tile that reads them.
//
// Bound on the card: bytes. Each fp32 element is read once (4 bytes) and
// its three parts written once (6 bytes), against ~8 operations an
// element. One thread a group of eight columns: two 16-byte loads where
// the row is as wide as the plane, three 16-byte stores.

#include "flash_common.cuh"

namespace {

// Up to four fp32 tensors of (rows, d) into their bf16 part planes (3,
// rows, w): part j of row r at dst + (j * rows + r) * w, columns d .. w - 1
// zero; one job a blockIdx.y. One instance a job count (JOBS), so that a
// profile tells the forward's split of q, k, v (three) from the backward's
// of dO (one) or of all four.
struct SplitJob {
  const float* src;
  __nv_bfloat16* dst;
  unsigned rows;
};
struct SplitJobs {
  SplitJob job[4];
};

template <int JOBS>
__global__ void __launch_bounds__(256)
    flash_split3_kernel(const SplitJobs jobs, int d, int w) {
  // each field read at a constant index (a computed one would copy the
  // whole parameter struct to local memory)
  const unsigned y = blockIdx.y;
  const SplitJob jb = (JOBS == 1 || y == 0) ? jobs.job[0]
                    : (JOBS == 2 || y == 1) ? jobs.job[1]
                    : (JOBS == 3 || y == 2) ? jobs.job[2] : jobs.job[3];
  const unsigned groups = (unsigned)w / 8;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= jb.rows * groups) return;
  const unsigned r = i / groups;
  const int c = (int)(i - r * groups) * 8;
  const float* s = jb.src + (size_t)r * d + c;
  float v[8];
  if (d == w) {
    const float4 a = *reinterpret_cast<const float4*>(s);
    const float4 b = *reinterpret_cast<const float4*>(s + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = c + e < d ? s[e] : 0.f;
  }
  uint32_t part[3][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t t3[3];
    split_pair(t3, v[2 * q], v[2 * q + 1]);
#pragma unroll
    for (int j = 0; j < 3; ++j) part[j][q] = t3[j];
  }
  const size_t plane = (size_t)jb.rows * w;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    *reinterpret_cast<uint4*>(jb.dst + j * plane + (size_t)r * w + c) =
        make_uint4(part[j][0], part[j][1], part[j][2], part[j][3]);
}

}  // namespace

// fp32 tensors src[i] of (rows[i], d) into bf16 planes dst[i] of (3,
// rows[i], w), w a multiple of 8 and >= d (null src ends the list).
// Returns cudaGetLastError() after the launch.
extern "C" int apex_flash_split3(const void* src0, const void* src1,
                                 const void* src2, const void* src3,
                                 void* dst0, void* dst1, void* dst2,
                                 void* dst3, long long rows0,
                                 long long rows1, long long rows2,
                                 long long rows3, int d, int w,
                                 void* stream) {
  if (w % 8 || w < d || d < 1) return (int)cudaErrorInvalidValue;
  const void* src[4] = {src0, src1, src2, src3};
  void* dst[4] = {dst0, dst1, dst2, dst3};
  const long long rows[4] = {rows0, rows1, rows2, rows3};
  SplitJobs jobs{};
  int n = 0;
  long long most = 0;
  for (int i = 0; i < 4 && src[i] != nullptr; ++i, ++n) {
    jobs.job[i] = SplitJob{static_cast<const float*>(src[i]),
                           static_cast<__nv_bfloat16*>(dst[i]),
                           (unsigned)rows[i]};
    most = rows[i] > most ? rows[i] : most;
  }
  if (n == 0 || most == 0) return (int)cudaGetLastError();
  // one thread an 8-column group, indexed in 32 bits
  if (most * (w / 8) >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((most * (w / 8) + 255) / 256), n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 1) flash_split3_kernel<1><<<grid, 256, 0, s>>>(jobs, d, w);
  if (n == 2) flash_split3_kernel<2><<<grid, 256, 0, s>>>(jobs, d, w);
  if (n == 3) flash_split3_kernel<3><<<grid, 256, 0, s>>>(jobs, d, w);
  if (n == 4) flash_split3_kernel<4><<<grid, 256, 0, s>>>(jobs, d, w);
  return (int)cudaGetLastError();
}

extern "C" const char* apex_flash_split3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
