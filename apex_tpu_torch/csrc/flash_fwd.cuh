// Flash-attention forward for fp32 q, k, v on `mma.sync` (sm_90a), fp32
// softmax. bf16 and fp16 run the wgmma/TMA design of flash_fwd_sm90.cuh;
// fp32 stays here, as `wgmma` has no exact fp32 product.
//
// Replaces: apex_tpu/ops/attention.py `_fwd_kernel` (:182), launched by
// `_flash_fwd_pallas` (`pallas_call` at :373). Same function: for every
// (batch, head) and query row, softmax(scale * q k^T + mask) v with an
// online softmax over key tiles (running max m and normaliser l in
// fp32), returning the output in q's dtype and the fp32 log-sum-exp.
// The mask follows `_mask_block` (:59-86): causal with the sk - sq
// offset, the sliding window on the same offset, and segment ids
// (a key is masked where q_seg != k_seg), each adding NEG_INF = -1e30.
// Given global positions (q_pos, k_pos: ring and blockwise chunks), the
// causal and window tests compare positions with no offset (:68-73), and
// a key tile is skipped when the bounds of its positions and the query
// tile's leave no live pair (`_block_live_dynamic` :126-137): zig-zag
// shards are not contiguous, so the static bounds below do not apply. An
// additive bias (any of the four dimensions broadcast, fp32 or bf16) is
// added to the scaled scores before the mask (:224-225).
// GQA reads kv head `h / (H / HK)`; K and V are never repeated. A row
// with every key masked writes 0 and lse = NEG_INF (:254-269). Scores
// are scaled in fp32 after the product, as at :221-223; P is rounded to
// the input dtype for the P.V product (the reference's `p.astype(v.dtype)`,
// :249), while l sums the fp32 probabilities. fp32 inputs take exact
// products (three bf16 parts a value, `flash_common.cuh`) and the accurate
// exp; any head_dim up to 128 runs, zero-padded in shared memory to the
// next built width (32, 64, 96, 128).
//
// Bound on the card: prefill is compute-bound (4 * b * h * sq * sk * d
// flops, about half of that when causal; fp32 runs six bf16 products for
// each, and its bound is taken at the card's 67 TFLOP/s of fp32 FMA);
// single-token decode (sq = 1) is memory-bound (reading K and V once, 2 *
// b * hk * sk * d * 4 bytes at 3.35 TB/s).
//
// Design: one 128-thread block per (64-query tile, batch*head). Each of
// the four warps owns 16 query rows and keeps its Q fragments, its
// 16 x 64 score tile and its 16 x d output accumulator in registers; the
// products run on the tensor cores through `mma.sync` m16n8k16 (six bf16
// products a value, fp32 accumulate), and the score fragments are re-packed in
// registers as the A operand of P.V, so scores never touch shared or device
// memory. K and V stream through shared memory one 64-key tile at a time
// with 16-byte loads. Tiles wholly above the causal diagonal or wholly
// before the window (by positions, when given) are never loaded. A bias
// is read straight from device memory per score, a quad's four lanes on
// 32 contiguous bytes of a row; a broadcast bias (a key-padding row, one
// (sq, sk) matrix for every head) stays in L1 and L2. The bias and
// position code is a template branch (EXTRA): without them the kernel
// keeps its registers and its speed. Any sq and sk work: rows and keys
// past the end are masked inside the kernel (the TPU kernel needed
// blocks that divide the sequence, `_pick_block` :51-56, and fell to
// blocks of 1 on the decode shape sk = L + 1). What this first version
// leaves on the table, for later work: no wgmma or TMA, no double
// buffering of the K/V tiles, and on decode (sq = 1) 63 of the 64 query
// rows of a block are padding, so the decode launch is a memory-bound
// stream of K and V run at a fraction of the card's rate (split-K
// decoding would fix that).

#pragma once

#include "flash_fwd_api.cuh"

namespace {

constexpr int kBQ = 64;            // query rows per block (16 per warp)
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 128;

template <typename T, int D, bool EXTRA>
constexpr int smem_bytes() {
  return 3 * tile_elems<T, D>() * 2 + (EXTRA ? 2 : 1) * kBK * 4;
}

// q: (B, H, SQ, DH); k, v: (B, HK, SK, DH); q_seg: (B, SQ), k_seg: (B, SK)
// int32 or both null; q_pos: (SQ,), k_pos: (SK,) int32 or both null;
// out: (B, H, SQ, DH); lse: (B, H, SQ) fp32. D is the built width >= DH.
// EXTRA = false compiles the bias and position code away (the launch
// picks it when both are absent), so a call without them runs the kernel
// it ran before they existed.
template <typename T, int D, bool EXTRA>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ q_seg,
                     const int* __restrict__ k_seg,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos, Bias bias,
                     T* __restrict__ out, float* __restrict__ lse, int H,
                     int HK, int SQ, int SK, int DH, float scale, int causal,
                     int window, Dropout dr) {
  using E = Elem<T>;
  constexpr int P = E::kParts;
  constexpr int LD = D + kPad;  // shared-memory row stride (elements)
  constexpr int KS = D / 16;    // k16 steps of q.k^T
  constexpr int NT = kBK / 8;   // n8 tiles of a score row
  constexpr int DT = D / 8;     // n8 tiles of an output row
  // fp32 Q fragments (three parts each) are re-read from shared memory per
  // k16 step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = typename E::S;
  constexpr int PS = part_stride<T, D>(), TE = tile_elems<T, D>();
  S* sQ = reinterpret_cast<S*>(smem_raw);
  S* sK = sQ + TE;
  S* sV = sK + TE;
  int* sKs = reinterpret_cast<int*>(sV + TE);
  int* sKp = sKs + kBK;  // positions of the query tile, then of each key tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int bh = blockIdx.y;
  const int bi = bh / H, hi = bh % H;
  const int kvh = hi / (H / HK);
  const int q0 = blockIdx.x * kBQ;
  const bool has_pos = EXTRA && q_pos != nullptr;
  const int off = has_pos ? 0 : SK - SQ;
  const bool has_seg = q_seg != nullptr;
  const bool has_bias = EXTRA && bias.p != nullptr;
  const long long bbase = bi * bias.sb + hi * bias.sh;

  const T* qp = q + (size_t)bh * SQ * DH;
  const T* kp = k + (size_t)(bi * HK + kvh) * SK * DH;
  const T* vp = v + (size_t)(bi * HK + kvh) * SK * DH;

  load_tile<T, D>(sQ, qp, q0, SQ, DH, tid, kThreads);
  __syncthreads();

  // this thread's rows of the warp's 16-row slab: r0 and r0 + 8
  const int r0 = warp * 16 + g;
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
  const int qs0 = (has_seg && qi0 < SQ) ? q_seg[(size_t)bi * SQ + qi0] : 0;
  const int qs1 = (has_seg && qi1 < SQ) ? q_seg[(size_t)bi * SQ + qi1] : 0;
  // the rows the causal and window tests compare, and the query tile's
  // position bounds
  int qr0 = qi0, qr1 = qi1, q_lo = 0, q_hi = 0;
  if (has_pos) {
    qr0 = qi0 < SQ ? q_pos[qi0] : 0;
    qr1 = qi1 < SQ ? q_pos[qi1] : 0;
    load_pos(sKp, q_pos, q0, SQ, tid, kThreads);
    __syncthreads();
    tile_bounds(sKp, min(kBQ, SQ - q0), lane, &q_lo, &q_hi);
  }

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // key range this query tile can see: nothing past the causal diagonal
  // of its last row, nothing before the window of its first row (with
  // positions, every tile, each tested on its own bounds below)
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

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4 * P];
      load_a<T, PS>(a, sQ, r0, LD, kk, t);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_abt<T, PS>(s[j], a, sK, j * 8, LD, kk, g, t);
    }

    float mx0 = kNegInf, mx1 = kNegInf;
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
        s[j][e] = mask_score(x0, qr0, kc, off, kj < SK, causal, window,
                             has_seg, qs0, ks);
        s[j][2 + e] = mask_score(x1, qr1, kc, off, kj < SK, causal, window,
                                 has_seg, qs1, ks);
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = E::ex(m0 - mn0), corr1 = E::ex(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = E::ex(s[j][0] - mn0);
      s[j][1] = E::ex(s[j][1] - mn0);
      s[j][2] = E::ex(s[j][2] - mn1);
      s[j][3] = E::ex(s[j][3] - mn1);
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
    if (dr.on) {
      // dropout touches only what multiplies V; l keeps the full sum
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + j * 8 + 2 * t + e;
          s[j][e] = dropped(dr, bh, qi0, kj, s[j][e]);
          s[j][2 + e] = dropped(dr, bh, qi1, kj, s[j][2 + e]);
        }
      }
    }

    // O += P V: the score accumulators of two adjacent n8 tiles are
    // exactly the A fragment of one k16 step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4 * P];
      acc_to_a<T>(a, s, kk);
#pragma unroll
      for (int j = 0; j < DT; ++j)
        mma_ab<T, PS>(o[j], a, sV, j * 8, LD, kk, g, t);
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool valid0 = m0 > kNegInf * 0.5f, valid1 = m1 > kNegInf * 0.5f;
  const float safe0 = l0 > 0.f ? l0 : 1.f, safe1 = l1 > 0.f ? l1 : 1.f;
  T* op = out + (size_t)bh * SQ * DH;
  if (qi0 < SQ) {
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const float x0 = valid0 ? o[j][0] / safe0 : 0.f;
      const float x1 = valid0 ? o[j][1] / safe0 : 0.f;
      store_cols<T>(op + (size_t)qi0 * DH, j * 8 + 2 * t, DH, x0, x1);
    }
    if (t == 0)
      lse[(size_t)bh * SQ + qi0] = valid0 ? m0 + logf(safe0) : kNegInf;
  }
  if (qi1 < SQ) {
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const float x0 = valid1 ? o[j][2] / safe1 : 0.f;
      const float x1 = valid1 ? o[j][3] / safe1 : 0.f;
      store_cols<T>(op + (size_t)qi1 * DH, j * 8 + 2 * t, DH, x0, x1);
    }
    if (t == 0)
      lse[(size_t)bh * SQ + qi1] = valid1 ? m1 + logf(safe1) : kNegInf;
  }
}

template <typename T, int D, bool EXTRA>
int launch_one(const Args& a, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D, EXTRA>();
  static_assert(bytes <= 227 * 1024, "shared memory past the sm_90 limit");
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, EXTRA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.SQ + kBQ - 1) / kBQ, a.B * a.H);
  flash_fwd_kernel<T, D, EXTRA><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.q_seg),
      static_cast<const int*>(a.k_seg), static_cast<const int*>(a.q_pos),
      static_cast<const int*>(a.k_pos), a.bias, static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.H, a.HK, a.SQ, a.SK, a.DH, a.scale,
      a.causal, a.window, a.dr);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  if (a.q_pos == nullptr && a.bias.p == nullptr)
    return launch_one<T, D, false>(a, stream);
  return launch_one<T, D, true>(a, stream);
}

template <typename T>
int launch_width(const Args& a, cudaStream_t stream) {
  switch (built_width(a.DH)) {
    case 32:
      return launch<T, 32>(a, stream);
    case 64:
      return launch<T, 64>(a, stream);
    case 96:
      return launch<T, 96>(a, stream);
    case 128:
      return launch<T, 128>(a, stream);
    default:   // fp32's three part tiles would not fit at 256
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
