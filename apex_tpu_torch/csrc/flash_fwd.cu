// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces: apex_tpu/ops/attention.py `_fwd_kernel` (:182), launched by
// `_flash_fwd_pallas` (`pallas_call` at :373). Same function: for every
// (batch, head) and query row, softmax(scale * q k^T + mask) v with an
// online softmax over key tiles (running max m and normaliser l in
// fp32), returning the output in q's dtype and the fp32 log-sum-exp.
// The mask follows `_mask_block` (:59-86): causal with the sk - sq
// offset, the sliding window on the same offset, and segment ids
// (a key is masked where q_seg != k_seg), each adding NEG_INF = -1e30.
// GQA reads kv head `h / (H / HK)`; K and V are never repeated. A row
// with every key masked writes 0 and lse = NEG_INF (:254-269). Scores
// are scaled in fp32 after the product, as at :221-223; P is rounded to
// bf16 for the P.V product, while l sums the fp32 probabilities.
//
// Bound on the card: prefill is compute-bound (4 * b * h * sq * sk * d
// flops, about half of that when causal, against 989 TFLOP/s of bf16
// tensor-core rate); single-token decode (sq = 1) is memory-bound
// (reading K and V once, 2 * b * hk * sk * d * 2 bytes at 3.35 TB/s).
//
// Design: one 128-thread block per (64-query tile, batch*head). Each of
// the four warps owns 16 query rows and keeps its Q fragments, its
// 16 x 64 score tile and its 16 x d output accumulator in registers; the
// products run on the tensor cores through `mma.sync` m16n8k16 (bf16 in,
// fp32 accumulate), and the score fragments are re-packed in registers
// as the A operand of P.V, so scores never touch shared or device
// memory. K and V stream through shared memory one 64-key tile at a time
// with 16-byte loads. Tiles wholly above the causal diagonal or wholly
// before the window are never loaded. Any sq and sk work: rows and keys
// past the end are masked inside the kernel (the TPU kernel needed
// blocks that divide the sequence, `_pick_block` :51-56, and fell to
// blocks of 1 on the decode shape sk = L + 1). What this first version
// leaves on the table, for later work: no wgmma or TMA, no double
// buffering of the K/V tiles, and on decode (sq = 1) 63 of the 64 query
// rows of a block are padding, so the decode launch is a memory-bound
// stream of K and V run at a fraction of the card's rate (split-K
// decoding would fix that).

#include "flash_common.cuh"

namespace {

constexpr int kBQ = 64;            // query rows per block (16 per warp)
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 128;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
constexpr int smem_bytes() {
  return (kBQ + 2 * kBK) * (D + kPad) * 2 + kBK * 4;
}

// q: (B, H, SQ, D); k, v: (B, HK, SK, D); q_seg: (B, SQ), k_seg: (B, SK)
// int32 or both null; out: (B, H, SQ, D); lse: (B, H, SQ) fp32.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ k_seg,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int H, int HK, int SQ, int SK,
                     float scale, int causal, int window) {
  constexpr int LD = D + kPad;  // shared-memory row stride (elements)
  constexpr int CH = D / 8;     // 16-byte chunks per row
  constexpr int KS = D / 16;    // k16 steps of q.k^T
  constexpr int NT = kBK / 8;   // n8 tiles of a score row
  constexpr int DT = D / 8;     // n8 tiles of an output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBQ * LD;
  __nv_bfloat16* sV = sK + kBK * LD;
  int* sKs = reinterpret_cast<int*>(sV + kBK * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int bh = blockIdx.y;
  const int bi = bh / H, hi = bh % H;
  const int kvh = hi / (H / HK);
  const int q0 = blockIdx.x * kBQ;
  const int off = SK - SQ;
  const bool has_seg = q_seg != nullptr;

  const __nv_bfloat16* qp = q + (size_t)bh * SQ * D;
  const __nv_bfloat16* kp = k + (size_t)(bi * HK + kvh) * SK * D;
  const __nv_bfloat16* vp = v + (size_t)(bi * HK + kvh) * SK * D;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (q0 + r < SQ)
      val = *reinterpret_cast<const uint4*>(qp + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = val;
  }
  __syncthreads();

  // this thread's rows of the warp's 16-row slab: r0 and r0 + 8
  const int r0 = warp * 16 + g;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qa[kk][0] = ld32(sQ + r0 * LD + kk * 16 + 2 * t);
    qa[kk][1] = ld32(sQ + (r0 + 8) * LD + kk * 16 + 2 * t);
    qa[kk][2] = ld32(sQ + r0 * LD + kk * 16 + 2 * t + 8);
    qa[kk][3] = ld32(sQ + (r0 + 8) * LD + kk * 16 + 2 * t + 8);
  }
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
  const int qs0 = (has_seg && qi0 < SQ) ? q_seg[(size_t)bi * SQ + qi0] : 0;
  const int qs1 = (has_seg && qi1 < SQ) ? q_seg[(size_t)bi * SQ + qi1] : 0;

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // key range this query tile can see: nothing past the causal diagonal
  // of its last row, nothing before the window of its first row
  const int q_last = min(q0 + kBQ, SQ) - 1;
  const int k_end = causal ? min(SK, q_last + off + 1) : SK;
  int k_begin = window > 0 ? max(0, q0 + off - window + 1) : 0;
  k_begin -= k_begin % kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < SK) {
        kv = *reinterpret_cast<const uint4*>(kp + (size_t)(k0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(vp + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * LD + c) = vv;
    }
    if (has_seg) {
      for (int i = tid; i < kBK; i += kThreads)
        sKs[i] = k0 + i < SK ? k_seg[(size_t)bi * SK + k0 + i] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kr = sK + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16_16816(s[j], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = j * 8 + 2 * t + e;
        const int kj = k0 + kl;
        const int ks = has_seg ? sKs[kl] : 0;
        s[j][e] = mask_score(s[j][e] * scale, qi0, kj, off, SK, causal,
                             window, has_seg, qs0, ks);
        s[j][2 + e] = mask_score(s[j][2 + e] * scale, qi1, kj, off, SK,
                                 causal, window, has_seg, qs1, ks);
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = __expf(m0 - mn0), corr1 = __expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = __expf(s[j][0] - mn0);
      s[j][1] = __expf(s[j][1] - mn0);
      s[j][2] = __expf(s[j][2] - mn1);
      s[j][3] = __expf(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    // per-thread partial normalisers; the quad's partials share the
    // same running max, so they are summed once at the end
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= corr0;
      o[j][1] *= corr0;
      o[j][2] *= corr1;
      o[j][3] *= corr1;
    }

    // O += P V: the score accumulators of two adjacent n8 tiles are
    // exactly the A fragment of one k16 step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vr = sV + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const __nv_bfloat16* vc = vr + j * 8;
        const uint32_t b0 = pack_raw(vc, vc + LD);
        const uint32_t b1 = pack_raw(vc + 8 * LD, vc + 9 * LD);
        mma_bf16_16816(o[j], a, b0, b1);
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool valid0 = m0 > kNegInf * 0.5f, valid1 = m1 > kNegInf * 0.5f;
  const float safe0 = l0 > 0.f ? l0 : 1.f, safe1 = l1 > 0.f ? l1 : 1.f;
  __nv_bfloat16* op = out + (size_t)bh * SQ * D;
  if (qi0 < SQ) {
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const float x0 = valid0 ? o[j][0] / safe0 : 0.f;
      const float x1 = valid0 ? o[j][1] / safe0 : 0.f;
      *reinterpret_cast<uint32_t*>(op + (size_t)qi0 * D + j * 8 + 2 * t) =
          pack_bf16(x0, x1);
    }
    if (t == 0)
      lse[(size_t)bh * SQ + qi0] = valid0 ? m0 + logf(safe0) : kNegInf;
  }
  if (qi1 < SQ) {
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const float x0 = valid1 ? o[j][2] / safe1 : 0.f;
      const float x1 = valid1 ? o[j][3] / safe1 : 0.f;
      *reinterpret_cast<uint32_t*>(op + (size_t)qi1 * D + j * 8 + 2 * t) =
          pack_bf16(x0, x1);
    }
    if (t == 0)
      lse[(size_t)bh * SQ + qi1] = valid1 ? m1 + logf(safe1) : kNegInf;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* q_seg,
           const void* k_seg, void* out, void* lse, int B, int H, int HK,
           int SQ, int SK, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((SQ + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(k_seg), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, HK, SQ, SK, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a head_dim other than 32, 64 or 128 or a grid beyond the y limit).
// window <= 0 means no window; q_seg and k_seg are both null or both set.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              const void* q_seg, const void* k_seg,
                              void* out, void* lse, int B, int H, int HK,
                              int SQ, int SK, int D, float scale, int causal,
                              int window, void* stream) {
  if (B == 0 || H == 0 || SQ == 0) return (int)cudaGetLastError();
  if (HK <= 0 || H % HK || B * H > 65535 || SK < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, q_seg, k_seg, out, lse, B, H, HK, SQ, SK,
                        scale, causal, window, s);
    case 64:
      return launch<64>(q, k, v, q_seg, k_seg, out, lse, B, H, HK, SQ, SK,
                        scale, causal, window, s);
    case 128:
      return launch<128>(q, k, v, q_seg, k_seg, out, lse, B, H, HK, SQ, SK,
                         scale, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* apex_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
