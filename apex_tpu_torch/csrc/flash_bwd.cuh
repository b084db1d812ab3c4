// Flash-attention backward for fp32 inputs on `mma.sync` (bf16 and fp16 take
// the wgmma/TMA design of flash_bwd_sm90.cuh, which names this header for
// the function both compute).
//
// Replaces: apex_tpu/ops/attention.py `_bwd_dq_kernel` (:402, `pallas_call`
// at :657) and `_bwd_dkv_kernel` (:470, `pallas_call` at :711), both
// launched by `_flash_bwd_pallas` (:547). Same function, two kernels as
// there, each recomputing the probabilities from the forward's lse:
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
// score (`_block_live_dynamic`, in place of the static bounds).
//
// Bound on the card: compute, by a small margin. At b8 h16 s1024 d64
// causal the five products of the gradient are ~43 GFLOP (43 us at
// 989 TFLOP/s); the two-kernel form recomputes q k^T and dO v^T in both
// kernels (~60 GFLOP), against ~117 MB of q, k, v, dO read and dq, dk,
// dv written (35 us at 3.35 TB/s). fp16 is bf16's; fp32 runs six bf16
// products for each (`flash_common.cuh`) and is bound by the card's 67
// TFLOP/s of fp32 FMA for the same flops. fp32 is the only element type
// instanced here.
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
// registers for the accumulators. fp32 tiles are three bf16 part tiles
// and each product six bf16 products (`flash_common.cuh`); head widths
// below the built ones are zero-padded in shared memory. A head_dim past
// 128 is refused: the part tiles take 96 KB each at D = 256, and dk/dv's
// four would need 384 KB of shared memory.

#pragma once

#include "flash_bwd_api.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per tile (16 per warp)
constexpr int kBK = 64;   // keys per tile (16 per warp in dk/dv)
constexpr int kThreads = 128;

template <typename T, int D, bool EXTRA>
constexpr int dq_smem_bytes() {
  return 4 * tile_elems<T, D>() * 2 + (EXTRA ? 2 : 1) * kBK * 4;
}

template <typename T, int D, bool EXTRA>
constexpr int dkv_smem_bytes() {
  return 4 * tile_elems<T, D>() * 2 + (EXTRA ? 5 : 3) * kBQ * 4;
}

// q, dO: (B, H, SQ, DH); k, v: (B, HK, SK, DH) of T; D is the built width
// >= DH. lse, delta, glse: (B, H, SQ) fp32 (glse may be null). q_seg:
// (B, SQ), k_seg: (B, SK) int32 or both null; q_pos: (SQ,), k_pos:
// (SK,) int32 or both null. dq like q.
// EXTRA = false compiles the bias, position and glse code away (the
// launch picks it when all three are absent), as in the forward.
template <typename T, int D, bool EXTRA>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q,
                        const T* __restrict__ k,
                        const T* __restrict__ v,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ q_seg,
                        const int* __restrict__ k_seg,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos,
                        const float* __restrict__ glse, Bias bias,
                        T* __restrict__ dq, int H, int HK, int SQ,
                        int SK, int DH, float scale, int causal, int window,
                        Dropout dr) {
  using E = Elem<T>;
  constexpr int P = E::kParts;
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;    // k16 steps over head_dim
  constexpr int NT = kBK / 8;   // n8 tiles of a score row
  constexpr int DT = D / 8;     // n8 tiles of a dq row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = typename E::S;
  constexpr int PS = part_stride<T, D>(), TE = tile_elems<T, D>();
  S* sQ = reinterpret_cast<S*>(smem_raw);
  S* sO = sQ + TE;   // dO
  S* sK = sO + TE;
  S* sV = sK + TE;
  int* sKs = reinterpret_cast<int*>(sV + TE);
  int* sKp = sKs + kBK;  // positions of the query tile, then of each key tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int bi = bh / H, hi = bh % H;
  const int kvh = hi / (H / HK);
  const int q0 = blockIdx.x * kBQ;
  const bool has_pos = EXTRA && q_pos != nullptr;
  const int off = has_pos ? 0 : SK - SQ;
  const bool has_seg = q_seg != nullptr;
  const bool has_bias = EXTRA && bias.p != nullptr;
  const bool has_glse = EXTRA && glse != nullptr;
  const long long bbase = bi * bias.sb + hi * bias.sh;

  const T* kp = k + (size_t)(bi * HK + kvh) * SK * DH;
  const T* vp = v + (size_t)(bi * HK + kvh) * SK * DH;
  load_tile<T, D>(sQ, q + (size_t)bh * SQ * DH, q0, SQ, DH, tid,
                  kThreads);
  load_tile<T, D>(sO, dout + (size_t)bh * SQ * DH, q0, SQ, DH, tid,
                  kThreads);

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
  const float* gp = glse + (size_t)bh * SQ;
  const float g0 = (has_glse && qi0 < SQ) ? gp[qi0] : 0.f;
  const float g1 = (has_glse && qi1 < SQ) ? gp[qi1] : 0.f;
  int qr0 = qi0, qr1 = qi1, q_lo = 0, q_hi = 0;
  if (has_pos) {
    qr0 = qi0 < SQ ? q_pos[qi0] : 0;
    qr1 = qi1 < SQ ? q_pos[qi1] : 0;
    load_pos(sKp, q_pos, q0, SQ, tid, kThreads);
    __syncthreads();
    tile_bounds(sKp, min(kBQ, SQ - q0), lane, &q_lo, &q_hi);
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int k_begin = 0, k_end = SK;
  if (!has_pos) {
    const int q_last = min(q0 + kBQ, SQ) - 1;
    if (causal) k_end = min(SK, q_last + off + 1);
    if (window > 0) k_begin = max(0, q0 + off - window + 1);
    k_begin -= k_begin % kBK;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    if (has_pos) {
      load_pos(sKp, k_pos, k0, SK, tid, kThreads);
      __syncthreads();
      int k_lo, k_hi;
      tile_bounds(sKp, min(kBK, SK - k0), lane, &k_lo, &k_hi);
      if (!tile_live(q_lo, q_hi, k_lo, k_hi, window)) continue;
    }
    load_tile<T, D>(sK, kp, k0, SK, DH, tid, kThreads);
    load_tile<T, D>(sV, vp, k0, SK, DH, tid, kThreads);
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
      uint32_t aq[4 * P], ao[4 * P];
      load_a<T, PS>(aq, sQ, r0, LD, kk, t);
      load_a<T, PS>(ao, sO, r0, LD, kk, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_abt<T, PS>(s[j], aq, sK, j * 8, LD, kk, g, t);
        mma_abt<T, PS>(dpv[j], ao, sV, j * 8, LD, kk, g, t);
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
        const int kc = has_pos ? sKp[kl] : kj;
        float x0 = s[j][e] * scale, x1 = s[j][2 + e] * scale;
        if (has_bias && kj < SK) {
          if (qi0 < SQ) x0 = __fadd_rn(x0, bias_at(bias, bbase, qi0, kj));
          if (qi1 < SQ) x1 = __fadd_rn(x1, bias_at(bias, bbase, qi1, kj));
        }
        const float p0 = E::ex(mask_score(x0, qr0, kc, off, kj < SK, causal,
                                           window, has_seg, qs0, ks) -
                                l0);
        const float p1 = E::ex(mask_score(x1, qr1, kc, off, kj < SK, causal,
                                           window, has_seg, qs1, ks) -
                                l1);
        float dp0 = dpv[j][e], dp1 = dpv[j][2 + e];
        if (dr.on) {
          dp0 = dropped(dr, bh, qi0, kj, dp0);
          dp1 = dropped(dr, bh, qi1, kj, dp1);
        }
        s[j][e] = p0 * (dp0 - d0);
        s[j][2 + e] = p1 * (dp1 - d1);
        if (has_glse) {
          s[j][e] = __fadd_rn(s[j][e], __fmul_rn(p0, g0));
          s[j][2 + e] = __fadd_rn(s[j][2 + e], __fmul_rn(p1, g1));
        }
      }
    }

    // dq += dS K (dS rounded to T)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4 * P];
      acc_to_a<T>(a, s, kk);
#pragma unroll
      for (int j = 0; j < DT; ++j)
        mma_ab<T, PS>(acc[j], a, sK, j * 8, LD, kk, g, t);
    }
  }

  T* out = dq + (size_t)bh * SQ * DH;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (qi0 < SQ)
      store_cols<T>(out + (size_t)qi0 * DH, j * 8 + 2 * t, DH,
                    acc[j][0] * scale, acc[j][1] * scale);
    if (qi1 < SQ)
      store_cols<T>(out + (size_t)qi1 * DH, j * 8 + 2 * t, DH,
                    acc[j][2] * scale, acc[j][3] * scale);
  }
}

// Same arguments; dk, dv like k. One block per (64-key tile, b*hk).
template <typename T, int D, bool EXTRA>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ q_seg,
                         const int* __restrict__ k_seg,
                         const int* __restrict__ q_pos,
                         const int* __restrict__ k_pos,
                         const float* __restrict__ glse, Bias bias,
                         T* __restrict__ dk,
                         T* __restrict__ dv, int H, int HK, int SQ,
                         int SK, int DH, float scale, int causal, int window,
                         Dropout dr) {
  using E = Elem<T>;
  constexpr int P = E::kParts;
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;
  constexpr int NT = kBQ / 8;   // n8 tiles of a (transposed) score row
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = typename E::S;
  constexpr int PS = part_stride<T, D>(), TE = tile_elems<T, D>();
  S* sK = reinterpret_cast<S*>(smem_raw);
  S* sV = sK + TE;
  S* sQ = sV + TE;
  S* sO = sQ + TE;
  float* sL = reinterpret_cast<float*>(sO + TE);
  float* sD = sL + kBQ;
  int* sQs = reinterpret_cast<int*>(sD + kBQ);
  float* sG = reinterpret_cast<float*>(sQs + kBQ);   // glse
  int* sQp = reinterpret_cast<int*>(sG + kBQ);       // query positions

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bhk = blockIdx.y;
  const int bi = bhk / HK, kvh = bhk % HK;
  const int group = H / HK;
  const int k0 = blockIdx.x * kBK;
  const bool has_pos = EXTRA && q_pos != nullptr;
  const int off = has_pos ? 0 : SK - SQ;
  const bool has_seg = q_seg != nullptr;
  const bool has_bias = EXTRA && bias.p != nullptr;
  const bool has_glse = EXTRA && glse != nullptr;

  load_tile<T, D>(sK, k + (size_t)bhk * SK * DH, k0, SK, DH, tid,
                  kThreads);
  load_tile<T, D>(sV, v + (size_t)bhk * SK * DH, k0, SK, DH, tid,
                  kThreads);

  const int r0 = warp * 16 + g;   // this thread's keys: r0 and r0 + 8
  const int kj0 = k0 + r0, kj1 = kj0 + 8;
  const int ks0 = (has_seg && kj0 < SK) ? k_seg[(size_t)bi * SK + kj0] : 0;
  const int ks1 = (has_seg && kj1 < SK) ? k_seg[(size_t)bi * SK + kj1] : 0;
  // the columns the causal and window tests compare, and the key tile's
  // position bounds
  int kc0 = kj0, kc1 = kj1, k_lo = 0, k_hi = 0;
  if (has_pos) {
    kc0 = kj0 < SK ? k_pos[kj0] : 0;
    kc1 = kj1 < SK ? k_pos[kj1] : 0;
    load_pos(sQp, k_pos, k0, SK, tid, kThreads);
    __syncthreads();
    tile_bounds(sQp, min(kBK, SK - k0), lane, &k_lo, &k_hi);
  }

  float ak[DT][4], av[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    ak[j][0] = ak[j][1] = ak[j][2] = ak[j][3] = 0.f;
    av[j][0] = av[j][1] = av[j][2] = av[j][3] = 0.f;
  }

  // query range that can see this key tile: from the causal diagonal of
  // its first key to the window's end of its last
  int q_begin = 0, q_end = SQ;
  if (!has_pos) {
    const int k_last = min(k0 + kBK, SK) - 1;
    if (causal) q_begin = max(0, k0 - off);
    q_begin -= q_begin % kBQ;
    if (window > 0) q_end = min(SQ, k_last - off + window);
  }

  for (int gh = 0; gh < group; ++gh) {
    const int bh = bi * H + kvh * group + gh;
    const long long bbase = bi * bias.sb + (kvh * group + gh) * bias.sh;
    const T* qp = q + (size_t)bh * SQ * DH;
    const T* op = dout + (size_t)bh * SQ * DH;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
      __syncthreads();  // every warp is done with the previous tile
      if (has_pos) {
        load_pos(sQp, q_pos, q0, SQ, tid, kThreads);
        __syncthreads();
        int q_lo, q_hi;
        tile_bounds(sQp, min(kBQ, SQ - q0), lane, &q_lo, &q_hi);
        if (!tile_live(q_lo, q_hi, k_lo, k_hi, window)) continue;
      }
      load_tile<T, D>(sQ, qp, q0, SQ, DH, tid, kThreads);
      load_tile<T, D>(sO, op, q0, SQ, DH, tid, kThreads);
      for (int i = tid; i < kBQ; i += kThreads) {
        const int qi = q0 + i;
        const bool ok = qi < SQ;
        // rows past the end take lse = +inf: their P is 0
        sL[i] = ok ? fmaxf(lse[(size_t)bh * SQ + qi], kNegInf * 0.5f)
                   : INFINITY;
        sD[i] = ok ? delta[(size_t)bh * SQ + qi] : 0.f;
        sQs[i] = (has_seg && ok) ? q_seg[(size_t)bi * SQ + qi] : 0;
        if (EXTRA)
          sG[i] = (has_glse && ok) ? glse[(size_t)bh * SQ + qi] : 0.f;
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
        uint32_t a_k[4 * P], a_v[4 * P];
        load_a<T, PS>(a_k, sK, r0, LD, kk, t);
        load_a<T, PS>(a_v, sV, r0, LD, kk, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_abt<T, PS>(s[j], a_k, sQ, j * 8, LD, kk, g, t);
          mma_abt<T, PS>(dpv[j], a_v, sO, j * 8, LD, kk, g, t);
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
          const int qr = has_pos ? sQp[ql] : qi;
          float x0 = s[j][e] * scale, x1 = s[j][2 + e] * scale;
          if (has_bias && qi < SQ) {
            if (kj0 < SK) x0 = __fadd_rn(x0, bias_at(bias, bbase, qi, kj0));
            if (kj1 < SK) x1 = __fadd_rn(x1, bias_at(bias, bbase, qi, kj1));
          }
          const float p0 = E::ex(mask_score(x0, qr, kc0, off, kj0 < SK,
                                             causal, window, has_seg, qs,
                                             ks0) -
                                  L);
          const float p1 = E::ex(mask_score(x1, qr, kc1, off, kj1 < SK,
                                             causal, window, has_seg, qs,
                                             ks1) -
                                  L);
          // dv takes the dropped P, dS the undropped one
          float pv0 = p0, pv1 = p1, dp0 = dpv[j][e], dp1 = dpv[j][2 + e];
          if (dr.on) {
            const bool keep0 = dropout_keep(dr.seed, bh, qi, kj0, dr.thresh);
            const bool keep1 = dropout_keep(dr.seed, bh, qi, kj1, dr.thresh);
            pv0 = keep0 ? __fdiv_rn(p0, dr.keep) : 0.f;
            pv1 = keep1 ? __fdiv_rn(p1, dr.keep) : 0.f;
            dp0 = keep0 ? __fdiv_rn(dp0, dr.keep) : 0.f;
            dp1 = keep1 ? __fdiv_rn(dp1, dr.keep) : 0.f;
          }
          s[j][e] = pv0;
          s[j][2 + e] = pv1;
          dpv[j][e] = p0 * (dp0 - Dl);
          dpv[j][2 + e] = p1 * (dp1 - Dl);
          if (has_glse) {
            const float G = sG[ql];
            dpv[j][e] = __fadd_rn(dpv[j][e], __fmul_rn(p0, G));
            dpv[j][2 + e] = __fadd_rn(dpv[j][2 + e], __fmul_rn(p1, G));
          }
        }
      }

      // dv += P^T dO, dk += dS^T Q (P and dS rounded to T)
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        uint32_t ap[4 * P], ad[4 * P];
        acc_to_a<T>(ap, s, kk);
        acc_to_a<T>(ad, dpv, kk);
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          mma_ab<T, PS>(av[j], ap, sO, j * 8, LD, kk, g, t);
          mma_ab<T, PS>(ak[j], ad, sQ, j * 8, LD, kk, g, t);
        }
      }
    }
  }

  T* dkp = dk + (size_t)bhk * SK * DH;
  T* dvp = dv + (size_t)bhk * SK * DH;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = j * 8 + 2 * t;
    if (kj0 < SK) {
      store_cols<T>(dkp + (size_t)kj0 * DH, c, DH, ak[j][0] * scale,
                    ak[j][1] * scale);
      store_cols<T>(dvp + (size_t)kj0 * DH, c, DH, av[j][0], av[j][1]);
    }
    if (kj1 < SK) {
      store_cols<T>(dkp + (size_t)kj1 * DH, c, DH, ak[j][2] * scale,
                    ak[j][3] * scale);
      store_cols<T>(dvp + (size_t)kj1 * DH, c, DH, av[j][2], av[j][3]);
    }
  }
}

template <typename T, int D, bool EXTRA>
int launch_both(const Args& a, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(a.q);
  const T* kt = static_cast<const T*>(a.k);
  const T* vt = static_cast<const T*>(a.v);
  const T* ot = static_cast<const T*>(a.dout);
  const float* lt = static_cast<const float*>(a.lse);
  const float* dt = static_cast<const float*>(a.delta);
  const int* qs = static_cast<const int*>(a.q_seg);
  const int* ks = static_cast<const int*>(a.k_seg);
  const int* qpos = static_cast<const int*>(a.q_pos);
  const int* kpos = static_cast<const int*>(a.k_pos);
  const float* gl = static_cast<const float*>(a.glse);
  constexpr int dq_bytes = dq_smem_bytes<T, D, EXTRA>();
  constexpr int dkv_bytes = dkv_smem_bytes<T, D, EXTRA>();
  static_assert(dq_bytes <= 227 * 1024 && dkv_bytes <= 227 * 1024,
                "shared memory past the sm_90 limit");
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D, EXTRA>, dq_bytes);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dkv_kernel<T, D, EXTRA>, dkv_bytes);
  if (e != cudaSuccess) return (int)e;
  if (a.dq != nullptr) {
    dim3 grid((a.SQ + kBQ - 1) / kBQ, a.B * a.H);
    flash_bwd_dq_kernel<T, D, EXTRA><<<grid, kThreads, dq_bytes, stream>>>(
        qt, kt, vt, ot, lt, dt, qs, ks, qpos, kpos, gl, a.bias,
        static_cast<T*>(a.dq), a.H, a.HK, a.SQ, a.SK, a.DH, a.scale,
        a.causal, a.window, a.dr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (a.dk != nullptr) {
    dim3 grid((a.SK + kBK - 1) / kBK, a.B * a.HK);
    flash_bwd_dkv_kernel<T, D, EXTRA><<<grid, kThreads, dkv_bytes, stream>>>(
        qt, kt, vt, ot, lt, dt, qs, ks, qpos, kpos, gl, a.bias,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.HK, a.SQ, a.SK,
        a.DH, a.scale, a.causal, a.window, a.dr);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  if (a.q_pos == nullptr && a.glse == nullptr && a.bias.p == nullptr)
    return launch_both<T, D, false>(a, stream);
  return launch_both<T, D, true>(a, stream);
}

// fp32 only: bf16 and fp16 take flash_bwd_sm90.cuh. A head_dim past 128
// is refused (three bf16 part tiles of 96 KB each at D = 256: dk/dv's four
// would take 384 KB of shared memory, against 227 KB).
template <>
int launch_width<float>(const Args& a, cudaStream_t stream) {
  switch (built_width(a.DH)) {
    case 32:
      return launch<float, 32>(a, stream);
    case 64:
      return launch<float, 64>(a, stream);
    case 96:
      return launch<float, 96>(a, stream);
    case 128:
      return launch<float, 128>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
