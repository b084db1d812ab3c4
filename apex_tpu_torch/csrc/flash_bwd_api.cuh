// The C entry point shared by the flash backward libraries (flash_bwd.cu
// bf16, flash_bwd_fp16.cu, flash_bwd_fp32.cu): argument checks, then the
// launcher of the dtype's design, `launch_width<T>`, which the including
// header defines (flash_bwd_sm90.cuh for bf16 and fp16, flash_bwd.cuh for
// fp32).

#pragma once

#include "flash_common.cuh"

namespace {

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *q_seg, *k_seg, *q_pos,
      *k_pos, *glse;
  Bias bias;
  void *dq, *dk, *dv;
  int B, H, HK, SQ, SK, DH;
  float scale;
  int causal, window;
  Dropout dr;
};

template <typename T>
int launch_width(const Args& a, cudaStream_t stream);

// The launcher of element type T (each flash_bwd*.cu exports it for its
// dtype, one library each, so that the dtypes build in parallel).
// One entry for both kernels: dq null skips the dq kernel, dk (and dv)
// null skips the dk/dv kernel. Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a head_dim the dtype's kernels are
// not built for, an unknown dtype or a grid beyond the y limit). dtype (0
// fp32, 1 bf16, 2 fp16) is that of q, k, v, dout and the gradients.
// window <= 0 means no window. The dropout, position and bias arguments
// are the forward's; glse (B, H, SQ) fp32, or null, is the cotangent of
// the forward's lse.
template <typename T>
int apex_flash_bwd_entry(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         const void* q_seg, const void* k_seg,
                         const void* q_pos, const void* k_pos,
                         const void* glse, const void* bias, int bias_dtype,
                         long long sb, long long sh, long long sq,
                         long long sk, void* dq, void* dk, void* dv, int B,
                         int H, int HK, int SQ, int SK, int D, int dtype,
                         float scale, int causal, int window, int dropout,
                         uint32_t seed, uint32_t thresh, float keep,
                         void* stream) {
  if (dtype != Elem<T>::kCode) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || SQ == 0 || SK == 0) return (int)cudaGetLastError();
  if (HK <= 0 || H % HK || B * H > 65535) return (int)cudaErrorInvalidValue;
  if ((dk == nullptr) != (dv == nullptr)) return (int)cudaErrorInvalidValue;
  if ((q_pos == nullptr) != (k_pos == nullptr) || (q_pos && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q,     k,     v,     dout,  lse,   delta, q_seg, k_seg,
               q_pos, k_pos, glse,  Bias{bias, bias_dtype, sb, sh, sq, sk},
               dq,    dk,    dv,    B,     H,     HK,    SQ,    SK,
               D,     scale, causal, window,
               Dropout{dropout, seed, thresh, keep}};
  return launch_width<T>(a, s);
}

}  // namespace

// The C entry points of one dtype's library: `apex_flash_bwd`, the entry
// above for T (its dtype argument must be T's code), and the error string.
#define APEX_EXPORT_FLASH_BWD(T)                                             \
  extern "C" int apex_flash_bwd(                                             \
      const void* q, const void* k, const void* v, const void* dout,        \
      const void* lse, const void* delta, const void* q_seg,                \
      const void* k_seg, const void* q_pos, const void* k_pos,              \
      const void* glse, const void* bias, int bias_dtype, long long sb,     \
      long long sh, long long sq, long long sk, void* dq, void* dk,         \
      void* dv, int B, int H, int HK, int SQ, int SK, int D, int dtype,     \
      float scale, int causal, int window, int dropout, uint32_t seed,      \
      uint32_t thresh, float keep, void* stream) {                          \
    return apex_flash_bwd_entry<T>(                                         \
        q, k, v, dout, lse, delta, q_seg, k_seg, q_pos, k_pos, glse, bias,  \
        bias_dtype, sb, sh, sq, sk, dq, dk, dv, B, H, HK, SQ, SK, D, dtype, \
        scale, causal, window, dropout, seed, thresh, keep, stream);        \
  }                                                                         \
  extern "C" const char* apex_flash_bwd_error_string(int err) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(err));               \
  }
