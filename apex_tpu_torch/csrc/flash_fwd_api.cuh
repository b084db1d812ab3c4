// The C entry point shared by the flash forward libraries (flash_fwd.cu
// bf16, flash_fwd_fp16.cu, flash_fwd_fp32.cu): argument checks, then the
// launcher of the dtype's design, `launch_width<T>`, which the including
// header defines (flash_fwd_sm90.cuh for bf16 and fp16, flash_fwd.cuh for
// fp32).

#pragma once

#include "flash_common.cuh"

namespace {

struct Args {
  const void *q, *k, *v, *q_seg, *k_seg, *q_pos, *k_pos;
  Bias bias;
  void *out, *lse;
  int B, H, HK, SQ, SK, DH;
  float scale;
  int causal, window;
  Dropout dr;
};

template <typename T>
int launch_width(const Args& a, cudaStream_t stream);

// The launcher of element type T (each flash_fwd*.cu exports it for its
// dtype, one library each, so that the dtypes build in parallel).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a head_dim the dtype's kernel is not built for, an unknown dtype or a
// grid beyond the y limit).
// q: (B, H, SQ, D); k, v: (B, HK, SK, D); out: (B, H, SQ, D); lse: (B, H,
// SQ) fp32. dtype: 0 fp32, 1 bf16, 2 fp16, for q, k, v and out. window <= 0
// means no window; q_seg (B, SQ) and k_seg (B, SK) are both null or both
// set, as are q_pos (SQ,) and k_pos (SK,) (positions need causal != 0),
// all int32. bias null means no bias; else bias_dtype (0 fp32, 1 bf16, 2
// fp16) says its type and sb, sh, sq, sk are its element strides over (b,
// h, q, k), 0 where it broadcasts. dropout != 0 drops P in the P.V
// product: kept where the hash of (seed, b * H + h, row, col) is >=
// thresh, divided by keep (1 - rate).
template <typename T>
int apex_flash_fwd_entry(const void* q, const void* k, const void* v,
                         const void* q_seg, const void* k_seg,
                         const void* q_pos, const void* k_pos,
                         const void* bias, int bias_dtype, long long sb,
                         long long sh, long long sq, long long sk, void* out,
                         void* lse, int B, int H, int HK, int SQ, int SK,
                         int D, int dtype, float scale, int causal,
                         int window, int dropout, uint32_t seed,
                         uint32_t thresh, float keep, void* stream) {
  if (dtype != Elem<T>::kCode) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || SQ == 0) return (int)cudaGetLastError();
  if (HK <= 0 || H % HK || B * H > 65535 || SK < 1)
    return (int)cudaErrorInvalidValue;
  if ((q_pos == nullptr) != (k_pos == nullptr) || (q_pos && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q,   k,  v,  q_seg, k_seg, q_pos, k_pos,
               Bias{bias, bias_dtype, sb, sh, sq, sk},
               out, lse, B, H, HK, SQ, SK, D, scale, causal, window,
               Dropout{dropout, seed, thresh, keep}};
  return launch_width<T>(a, s);
}

}  // namespace

// The C entry points of one dtype's library: `apex_flash_fwd`, the entry
// above for T (its dtype argument must be T's code), and the error string.
#define APEX_EXPORT_FLASH_FWD(T)                                             \
  extern "C" int apex_flash_fwd(                                             \
      const void* q, const void* k, const void* v, const void* q_seg,       \
      const void* k_seg, const void* q_pos, const void* k_pos,              \
      const void* bias, int bias_dtype, long long sb, long long sh,         \
      long long sq, long long sk, void* out, void* lse, int B, int H,       \
      int HK, int SQ, int SK, int D, int dtype, float scale, int causal,    \
      int window, int dropout, uint32_t seed, uint32_t thresh, float keep,  \
      void* stream) {                                                       \
    return apex_flash_fwd_entry<T>(                                         \
        q, k, v, q_seg, k_seg, q_pos, k_pos, bias, bias_dtype, sb, sh, sq,  \
        sk, out, lse, B, H, HK, SQ, SK, D, dtype, scale, causal, window,    \
        dropout, seed, thresh, keep, stream);                               \
  }                                                                         \
  extern "C" const char* apex_flash_error_string(int err) {                 \
    return cudaGetErrorString(static_cast<cudaError_t>(err));               \
  }
