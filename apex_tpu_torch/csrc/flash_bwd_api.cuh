// The C entry point shared by the flash backward libraries (flash_bwd.cu
// bf16, flash_bwd_fp16.cu, flash_bwd_fp32.cu): argument checks, then the
// launcher of the dtype's design, `launch_width<T>`, which the including
// header defines (flash_bwd_sm90.cuh for bf16 and fp16,
// flash_bwd32_sm90.cuh for fp32).
//
// The function both designs compute replaces apex_tpu/ops/attention.py
// `_bwd_dq_kernel` (:402, `pallas_call` at :657) and `_bwd_dkv_kernel`
// (:470, `pallas_call` at :711), both launched by `_flash_bwd_pallas`
// (:547): two kernels as there, each recomputing the probabilities from
// the forward's lse:
//   s  = scale * q k^T + mask            (mask: `_mask_block`, NEG_INF)
//   P  = exp(s - max(lse, NEG_INF / 2))  (:433: fully-masked rows give 0)
//   dP = dO v^T,  dS = P * (dP - delta) [+ P * glse], rounded to the
//   input dtype (:456-460, :533-536)
//   dq = scale * dS k,  dk = scale * dS^T q,  dv = P^T dO (P rounded too)
// with delta = rowsum(out * dO) computed by the caller (`_flash_bwd_rule`
// :828 leaves it to XLA). glse, the cotangent of a returned lse (`_flash_
// lse_bwd_rule` :933-946), adds P * glse with the undropped P (:457-459,
// :534-535). GQA sums dk and dv over the q heads of each kv head's group
// inside one block (:475-483); nothing is repeated in memory. Masking is
// the forward's: causal with the sk - sq offset, the sliding window on the
// same offset, segment ids, fully-masked rows, the additive bias (:437-438,
// :509-510), and with global positions the causal and window tests on
// positions, a tile pair skipped when its position bounds leave no live
// score (`_block_live_dynamic`, in place of the static bounds). Dropout
// (`_dropout_keep`, flash_common.cuh) drops dP and the P of dv: keep ? x
// / (1 - rate) : 0.

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
