// The C entry point shared by the flash forward libraries (flash_fwd.cu
// bf16, flash_fwd_fp16.cu, flash_fwd_fp32.cu): argument checks, then the
// launcher of the dtype's design, `launch_width<T>`, which the including
// header defines (flash_fwd_sm90.cuh for bf16 and fp16,
// flash_fwd32_sm90.cuh for fp32).
//
// The function both designs compute replaces apex_tpu/ops/attention.py
// `_fwd_kernel` (:182), launched by `_flash_fwd_pallas` (`pallas_call` at
// :373): for every (batch, head) and query row, softmax(scale * q k^T +
// mask) v with an online softmax over key tiles (running max m and
// normaliser l in fp32), returning the output in q's dtype and the fp32
// log-sum-exp. The mask follows `_mask_block` (:59-86): causal with the
// sk - sq offset, the sliding window on the same offset, and segment ids
// (a key is masked where q_seg != k_seg), each adding NEG_INF = -1e30.
// Given global positions (q_pos, k_pos: ring and blockwise chunks), the
// causal and window tests compare positions with no offset (:68-73), and
// a key tile is skipped when the bounds of its positions and the query
// tile's leave no live pair (`_block_live_dynamic` :126-137, `tile_live`):
// zig-zag shards are not contiguous, so static bounds do not apply. An
// additive bias (any of the four dimensions broadcast, fp32, bf16 or fp16)
// is added to the scaled scores before the mask (:224-225). GQA reads kv
// head `h / (H / HK)`; K and V are never repeated. A row with every key
// masked writes 0 and lse = NEG_INF (:254-269). Scores are scaled in fp32
// after the product, as at :221-223; P is rounded to the input dtype for
// the P.V product (the reference's `p.astype(v.dtype)`, :249; fp32 keeps
// it), while l sums the fp32 probabilities. Dropout (`_dropout_keep`,
// flash_common.cuh) drops P in P.V alone: kept where the hash of (seed, b
// * H + h, row, col) is >= thresh, divided by 1 - rate; l keeps the
// undropped sum. Any sq and sk run (rows and keys past the end are masked
// in the kernels; the TPU kernel needed blocks that divide the sequence,
// `_pick_block` :51-56).

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
// SQ) fp32. dtype: 0 fp32, 1 bf16, 2 fp16, for q, k, v and out. For fp32, q,
// k and v are the split pass's bf16 part planes (3, B * H, SQ, W) and (3,
// B * HK, SK, W), W the TMA width of D (flash_split3.cu), and out is (B, H,
// SQ, D) fp32. window <= 0
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
