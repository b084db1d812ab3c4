// Flash-attention backward for Hopper (sm_90a): bf16 in, fp32 accumulate.
//
// Replaces: apex_tpu/ops/attention.py `_bwd_dq_kernel` (:402, `pallas_call`
// at :657) and `_bwd_dkv_kernel` (:470, `pallas_call` at :711), both
// launched by `_flash_bwd_pallas` (:547). Same function, two kernels as
// there, each recomputing the probabilities from the forward's lse:
//   s  = scale * q k^T + mask            (mask: `_mask_block`, NEG_INF)
//   P  = exp(s - max(lse, NEG_INF / 2))  (:433: fully-masked rows give 0)
//   dP = dO v^T,  dS = P * (dP - delta), rounded to bf16 (:460, :536)
//   dq = scale * dS k,  dk = scale * dS^T q,  dv = bf16(P)^T dO
// with delta = rowsum(out * dO) computed by the caller (`_flash_bwd_rule`
// :828 leaves it to XLA). GQA sums dk and dv over the q heads of each kv
// head's group inside one block (:475-483); nothing is repeated in
// memory. Masking is the forward's: causal with the sk - sq offset, the
// sliding window on the same offset, segment ids, fully-masked rows.
//
// Bound on the card: compute, by a small margin. At b8 h16 s1024 d64
// causal the five products of the gradient are ~43 GFLOP (43 us at
// 989 TFLOP/s); the two-kernel form recomputes q k^T and dO v^T in both
// kernels (~60 GFLOP), against ~117 MB of q, k, v, dO read and dq, dk,
// dv written (35 us at 3.35 TB/s).
//
// Design: the forward's tile and fragment scheme (`flash_common.cuh`).
// dq: one 128-thread block per (64-query tile, batch*head); each warp
// owns 16 query rows and keeps its dq accumulator in registers while it
// walks the 64-key tiles up to the causal diagonal (and from the start
// of the window). dk/dv: one block per (64-key tile, batch*kv head); each
// warp owns 16 keys and keeps dk and dv in registers while the block
// walks every (q head of the group x 64-query tile) from the diagonal
// on. The score tiles are computed transposed there (K Q^T), so P^T and
// dS^T come out of the accumulators already laid out as the left operand
// of dv and dk. No atomics: each output element is written once by one
// thread, so both kernels are deterministic. Q, K, V and dO tiles sit in
// shared memory; fragments are read from it per k16 step, which keeps
// registers for the accumulators. Left for later work: wgmma/TMA,
// double-buffered tiles, and at head_dim 128 the accumulators press on
// the register file.

#include "flash_common.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per tile (16 per warp)
constexpr int kBK = 64;   // keys per tile (16 per warp in dk/dv)
constexpr int kThreads = 128;

template <int D>
constexpr int dq_smem_bytes() {
  return 4 * 64 * (D + kPad) * 2 + kBK * 4;
}

template <int D>
constexpr int dkv_smem_bytes() {
  return 4 * 64 * (D + kPad) * 2 + 3 * kBQ * 4;
}

// q, dO: (B, H, SQ, D); k, v: (B, HK, SK, D) bf16. lse, delta: (B, H, SQ)
// fp32. q_seg: (B, SQ), k_seg: (B, SK) int32 or both null. dq like q.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ q_seg,
                        const int* __restrict__ k_seg,
                        __nv_bfloat16* __restrict__ dq, int H, int HK, int SQ,
                        int SK, float scale, int causal, int window) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;    // k16 steps over head_dim
  constexpr int NT = kBK / 8;   // n8 tiles of a score row
  constexpr int DT = D / 8;     // n8 tiles of a dq row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sO = sQ + kBQ * LD;   // dO
  __nv_bfloat16* sK = sO + kBQ * LD;
  __nv_bfloat16* sV = sK + kBK * LD;
  int* sKs = reinterpret_cast<int*>(sV + kBK * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int bi = bh / H, hi = bh % H;
  const int kvh = hi / (H / HK);
  const int q0 = blockIdx.x * kBQ;
  const int off = SK - SQ;
  const bool has_seg = q_seg != nullptr;

  const __nv_bfloat16* kp = k + (size_t)(bi * HK + kvh) * SK * D;
  const __nv_bfloat16* vp = v + (size_t)(bi * HK + kvh) * SK * D;
  load_tile<D>(sQ, q + (size_t)bh * SQ * D, q0, SQ, kBQ, tid, kThreads);
  load_tile<D>(sO, dout + (size_t)bh * SQ * D, q0, SQ, kBQ, tid, kThreads);

  const int r0 = warp * 16 + g;   // this thread's rows: r0 and r0 + 8
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
  const float* lp = lse + (size_t)bh * SQ;
  const float* dp_ = delta + (size_t)bh * SQ;
  // rows past the end take lse = +inf: their P is 0
  const float l0 = qi0 < SQ ? fmaxf(lp[qi0], kNegInf * 0.5f) : INFINITY;
  const float l1 = qi1 < SQ ? fmaxf(lp[qi1], kNegInf * 0.5f) : INFINITY;
  const float d0 = qi0 < SQ ? dp_[qi0] : 0.f;
  const float d1 = qi1 < SQ ? dp_[qi1] : 0.f;
  const int qs0 = (has_seg && qi0 < SQ) ? q_seg[(size_t)bi * SQ + qi0] : 0;
  const int qs1 = (has_seg && qi1 < SQ) ? q_seg[(size_t)bi * SQ + qi1] : 0;

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int q_last = min(q0 + kBQ, SQ) - 1;
  const int k_end = causal ? min(SK, q_last + off + 1) : SK;
  int k_begin = window > 0 ? max(0, q0 + off - window + 1) : 0;
  k_begin -= k_begin % kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(sK, kp, k0, SK, kBK, tid, kThreads);
    load_tile<D>(sV, vp, k0, SK, kBK, tid, kThreads);
    if (has_seg) {
      for (int i = tid; i < kBK; i += kThreads)
        sKs[i] = k0 + i < SK ? k_seg[(size_t)bi * SK + k0 + i] : 0;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[NT][4], dpv[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dpv[j][0] = dpv[j][1] = dpv[j][2] = dpv[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, sQ, r0, LD, kk, t);
      load_a(ao, sO, r0, LD, kk, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_abt(s[j], aq, sK, j * 8, LD, kk, g, t);
        mma_abt(dpv[j], ao, sV, j * 8, LD, kk, g, t);
      }
    }

    // dS = P (dP - delta), P recomputed from the lse; kept in s
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = j * 8 + 2 * t + e;
        const int kj = k0 + kl;
        const int ks = has_seg ? sKs[kl] : 0;
        const float p0 = __expf(mask_score(s[j][e] * scale, qi0, kj, off, SK,
                                           causal, window, has_seg, qs0, ks) -
                                l0);
        const float p1 = __expf(mask_score(s[j][2 + e] * scale, qi1, kj, off,
                                           SK, causal, window, has_seg, qs1,
                                           ks) -
                                l1);
        s[j][e] = p0 * (dpv[j][e] - d0);
        s[j][2 + e] = p1 * (dpv[j][2 + e] - d1);
      }
    }

    // dq += bf16(dS) K
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int j = 0; j < DT; ++j) mma_ab(acc[j], a, sK, j * 8, LD, kk, g, t);
    }
  }

  __nv_bfloat16* out = dq + (size_t)bh * SQ * D;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (qi0 < SQ)
      *reinterpret_cast<uint32_t*>(out + (size_t)qi0 * D + j * 8 + 2 * t) =
          pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    if (qi1 < SQ)
      *reinterpret_cast<uint32_t*>(out + (size_t)qi1 * D + j * 8 + 2 * t) =
          pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// Same arguments; dk, dv like k. One block per (64-key tile, b*hk).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ q_seg,
                         const int* __restrict__ k_seg,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int HK, int SQ,
                         int SK, float scale, int causal, int window) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;
  constexpr int NT = kBQ / 8;   // n8 tiles of a (transposed) score row
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kBK * LD;
  __nv_bfloat16* sQ = sV + kBK * LD;
  __nv_bfloat16* sO = sQ + kBQ * LD;
  float* sL = reinterpret_cast<float*>(sO + kBQ * LD);
  float* sD = sL + kBQ;
  int* sQs = reinterpret_cast<int*>(sD + kBQ);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bhk = blockIdx.y;
  const int bi = bhk / HK, kvh = bhk % HK;
  const int group = H / HK;
  const int k0 = blockIdx.x * kBK;
  const int off = SK - SQ;
  const bool has_seg = q_seg != nullptr;

  load_tile<D>(sK, k + (size_t)bhk * SK * D, k0, SK, kBK, tid, kThreads);
  load_tile<D>(sV, v + (size_t)bhk * SK * D, k0, SK, kBK, tid, kThreads);

  const int r0 = warp * 16 + g;   // this thread's keys: r0 and r0 + 8
  const int kj0 = k0 + r0, kj1 = kj0 + 8;
  const int ks0 = (has_seg && kj0 < SK) ? k_seg[(size_t)bi * SK + kj0] : 0;
  const int ks1 = (has_seg && kj1 < SK) ? k_seg[(size_t)bi * SK + kj1] : 0;

  float ak[DT][4], av[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    ak[j][0] = ak[j][1] = ak[j][2] = ak[j][3] = 0.f;
    av[j][0] = av[j][1] = av[j][2] = av[j][3] = 0.f;
  }

  // query range that can see this key tile: from the causal diagonal of
  // its first key to the window's end of its last
  const int k_last = min(k0 + kBK, SK) - 1;
  int q_begin = causal ? max(0, k0 - off) : 0;
  q_begin -= q_begin % kBQ;
  const int q_end = window > 0 ? min(SQ, k_last - off + window) : SQ;

  for (int gh = 0; gh < group; ++gh) {
    const int bh = bi * H + kvh * group + gh;
    const __nv_bfloat16* qp = q + (size_t)bh * SQ * D;
    const __nv_bfloat16* op = dout + (size_t)bh * SQ * D;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
      __syncthreads();  // every warp is done with the previous tile
      load_tile<D>(sQ, qp, q0, SQ, kBQ, tid, kThreads);
      load_tile<D>(sO, op, q0, SQ, kBQ, tid, kThreads);
      for (int i = tid; i < kBQ; i += kThreads) {
        const int qi = q0 + i;
        const bool ok = qi < SQ;
        // rows past the end take lse = +inf: their P is 0
        sL[i] = ok ? fmaxf(lse[(size_t)bh * SQ + qi], kNegInf * 0.5f)
                   : INFINITY;
        sD[i] = ok ? delta[(size_t)bh * SQ + qi] : 0.f;
        sQs[i] = (has_seg && ok) ? q_seg[(size_t)bi * SQ + qi] : 0;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
      float s[NT][4], dpv[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dpv[j][0] = dpv[j][1] = dpv[j][2] = dpv[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a_k[4], a_v[4];
        load_a(a_k, sK, r0, LD, kk, t);
        load_a(a_v, sV, r0, LD, kk, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_abt(s[j], a_k, sQ, j * 8, LD, kk, g, t);
          mma_abt(dpv[j], a_v, sO, j * 8, LD, kk, g, t);
        }
      }

      // P^T in s, dS^T in dpv
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = j * 8 + 2 * t + e;
          const int qi = q0 + ql;
          const float L = sL[ql], Dl = sD[ql];
          const int qs = sQs[ql];
          const float p0 = __expf(mask_score(s[j][e] * scale, qi, kj0, off, SK,
                                             causal, window, has_seg, qs,
                                             ks0) -
                                  L);
          const float p1 = __expf(mask_score(s[j][2 + e] * scale, qi, kj1, off,
                                             SK, causal, window, has_seg, qs,
                                             ks1) -
                                  L);
          s[j][e] = p0;
          s[j][2 + e] = p1;
          dpv[j][e] = p0 * (dpv[j][e] - Dl);
          dpv[j][2 + e] = p1 * (dpv[j][2 + e] - Dl);
        }
      }

      // dv += bf16(P)^T dO, dk += bf16(dS)^T Q
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        uint32_t ap[4], ad[4];
        acc_to_a(ap, s, kk);
        acc_to_a(ad, dpv, kk);
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          mma_ab(av[j], ap, sO, j * 8, LD, kk, g, t);
          mma_ab(ak[j], ad, sQ, j * 8, LD, kk, g, t);
        }
      }
    }
  }

  __nv_bfloat16* dkp = dk + (size_t)bhk * SK * D;
  __nv_bfloat16* dvp = dv + (size_t)bhk * SK * D;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = j * 8 + 2 * t;
    if (kj0 < SK) {
      *reinterpret_cast<uint32_t*>(dkp + (size_t)kj0 * D + c) =
          pack_bf16(ak[j][0] * scale, ak[j][1] * scale);
      *reinterpret_cast<uint32_t*>(dvp + (size_t)kj0 * D + c) =
          pack_bf16(av[j][0], av[j][1]);
    }
    if (kj1 < SK) {
      *reinterpret_cast<uint32_t*>(dkp + (size_t)kj1 * D + c) =
          pack_bf16(ak[j][2] * scale, ak[j][3] * scale);
      *reinterpret_cast<uint32_t*>(dvp + (size_t)kj1 * D + c) =
          pack_bf16(av[j][2], av[j][3]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* q_seg,
           const void* k_seg, void* dq, void* dk, void* dv, int B, int H,
           int HK, int SQ, int SK, float scale, int causal, int window,
           cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* ot = static_cast<const bf*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const float* dt = static_cast<const float*>(delta);
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(k_seg);
  constexpr int dq_bytes = dq_smem_bytes<D>();
  constexpr int dkv_bytes = dkv_smem_bytes<D>();
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>, dq_bytes);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dkv_kernel<D>, dkv_bytes);
  if (e != cudaSuccess) return (int)e;
  if (dq != nullptr) {
    dim3 grid((SQ + kBQ - 1) / kBQ, B * H);
    flash_bwd_dq_kernel<D><<<grid, kThreads, dq_bytes, stream>>>(
        qt, kt, vt, ot, lt, dt, qs, ks, static_cast<bf*>(dq), H, HK, SQ, SK,
        scale, causal, window);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (dk != nullptr) {
    dim3 grid((SK + kBK - 1) / kBK, B * HK);
    flash_bwd_dkv_kernel<D><<<grid, kThreads, dkv_bytes, stream>>>(
        qt, kt, vt, ot, lt, dt, qs, ks, static_cast<bf*>(dk),
        static_cast<bf*>(dv), H, HK, SQ, SK, scale, causal, window);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One entry for both kernels: dq null skips the dq kernel, dk (and dv)
// null skips the dk/dv kernel. Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a head_dim other than 32, 64 or
// 128, or a grid beyond the y limit). window <= 0 means no window.
extern "C" int apex_flash_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* q_seg,
                              const void* k_seg, void* dq, void* dk, void* dv,
                              int B, int H, int HK, int SQ, int SK, int D,
                              float scale, int causal, int window,
                              void* stream) {
  if (B == 0 || H == 0 || SQ == 0 || SK == 0) return (int)cudaGetLastError();
  if (HK <= 0 || H % HK || B * H > 65535) return (int)cudaErrorInvalidValue;
  if ((dk == nullptr) != (dv == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, dout, lse, delta, q_seg, k_seg, dq, dk, dv, B,
                        H, HK, SQ, SK, scale, causal, window, s);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, q_seg, k_seg, dq, dk, dv, B,
                        H, HK, SQ, SK, scale, causal, window, s);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, q_seg, k_seg, dq, dk, dv,
                         B, H, HK, SQ, SK, scale, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* apex_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
