// Flash-attention forward for Hopper (sm_90a) on warpgroup MMA and TMA: bf16
// or fp16 in, fp32 softmax (fp32 inputs take flash_fwd32_sm90.cuh: `wgmma`
// has no exact fp32 product, so there every product is six bf16 ones).
//
// Replaces: apex_tpu/ops/attention.py `_fwd_kernel` (:182), launched by
// `_flash_fwd_pallas` (`pallas_call` at :373). The function is the
// one flash_fwd_api.cuh sets out: for every (batch, head) and
// query row, softmax(scale q k^T + bias + mask) v with an online softmax
// over key tiles (running max m and normaliser l in fp32), the output in
// q's dtype and the fp32 log-sum-exp. Causal with the sk - sq offset, the
// sliding window, segment ids, the additive bias through its four strides
// (fp32, bf16 or fp16), global positions with dead tiles skipped
// (`tile_live`), dropout by the `dropout_keep` hash on global (b * H + h,
// row, col) with the kept P divided by 1 - rate, GQA with K and V never
// repeated. Scores are scaled in fp32 after the product; P is rounded to
// the input dtype for P V while l sums the fp32 probabilities before
// dropout; a row with no live key writes 0 and lse = NEG_INF. One kernel,
// no atomics: each output element is written once, so a repeated call is
// bitwise equal.
//
// Bound on the card: at GPT-2's training shape (b8 h16 s1024 d64 causal)
// operations and bytes are close: two products of 2 d operations a live
// (query, key) pair take 17 us at 989 TFLOP/s, reading q, k, v and writing
// the output 20 us at 3.35 TB/s; single-token decode is bound by bytes (K
// and V read once: 10 us at b8 h16 sk1025 d64).
//
// Design (sm90_common.cuh has the pieces):
// - Blocks. Two consumer warpgroups over 128 queries (64 each) share each
//   K/V tile; where sq <= 64 (decode, the multi-head attention stacks' 64
//   tokens) a block is one warpgroup over 64, so that no half of it idles.
//   A block keeps 256 threads (ptxas allocates a 288- or 384-thread block
//   at 168 registers, which does not hold a 128-key score tile beside the
//   output), and warp 0 produces between its own tiles. Up to D = 96 two
//   blocks share an SM (128 registers a thread, 64-key tiles; at 96 the
//   bias and position variants spill 4 bytes): the softmax is a chain of
//   dependent steps, and four warps a scheduler instead of two hide it (on
//   the H100 this cut GPT-2's training shape by a fifth and halved the
//   64-token MHA shape). At D = 128 and 256 one block an SM holds the wider
//   O (up to 255 registers; 128- and 64-key tiles). The last query tiles
//   (the most keys under a causal mask) start first.
// - Pipeline. Q is loaded once by TMA. The producer issues each K/V tile
//   (128 keys at D = 128, else 64) into a ring of up to four stages (three
//   at D = 96 and, without key rows, 128; two at 256; for shared memory;
//   no more than the key tiles, so that short sequences keep their blocks
//   small and more of them share an SM),
//   once every consumer warp has released the tile that held the stage:
//   one `arrive.expect_tx` on the stage's mbarrier, and with segment ids or
//   positions the tile's key rows stored beside it by warp 0's lanes. The
//   producer alone decides which tiles exist (the causal and window
//   ranges, `tile_live` on positions) and writes each tile's first key
//   beside it; a tile with k0 = -1 ends the stream, so the two sides never
//   disagree on the count.
// - Products. S = Q K^T is an m64nBKk16 `wgmma` with both operands K-major
//   in shared memory (n128 at D = 128, else n64). O += P V is an
//   m64nDk16 `wgmma` (two of n128 at D = 256) with P rounded in registers
//   to the A operand (`acc_to_a`) and V read MN-major through the
//   transpose bit from the same tile: nothing is transposed. The decode
//   and narrow-head rows past sq and columns past head_dim are zero-filled
//   by TMA; keys past sk give a score of 0, not -inf, and are masked.
// - Epilogue, on the fp32 accumulators, with no branch per score: dropout
//   and the extra inputs (bias, positions) are template flags, and a tile
//   takes one of three paths. OPEN, where every pair of the warpgroup's
//   rows and the tile's keys is live (inside the causal diagonal, no
//   segments, bias, positions or window, no ragged keys): the row max of
//   the raw scores and P = 2^(s scale log2 e - m) in one fma and one ex2.
//   LIMIT, where the only mask is each row's last visible key (the causal
//   diagonal, or sk - 1): one compare a score sets a masked score to -inf,
//   then OPEN's arithmetic; at GPT-2's training shape the diagonal tiles
//   are a fifth of the tiles. GENERAL: the whole mask (`score_masked`:
//   segments, positions, the window) sets -inf on the scaled scores. A
//   masked score's P is then exactly 0. A bias is added in a pass of its
//   own. The running max is kept in log2 units; a row with no live score
//   yet takes 0 as its max, so that its P stays 0. O is rescaled in its
//   registers. Dropout divides by 1 - rate with `div_keep` (the backward's
//   branch-free __fdiv_rn).
// - Output. O / l is cast and written over the warpgroup's own rows of the
//   Q tile in the swizzled layout, then stored by TMA (rows past sq and
//   columns past head_dim are not written); lse is stored beside it.
// - What was tried and dropped, with one block an SM (no gain on the H100
//   at GPT-2's shapes, and slower at D = 128 and 256 where the ring is
//   shallow): issuing the next
//   tile's S product beside this tile's P V so that P V runs under the next
//   softmax, the two warpgroups taking turns to issue their products
//   (ping-pong on named barriers), and a persistent grid walking (query
//   tile, head) items with the next item's Q and tiles loading under this
//   one. Removing the softmax altogether brought the training shape down
//   to the time of its tile traffic (less than half), but neither the ex2s
//   nor the max nor the sum alone moved it by a tenth: the epilogue's
//   dependent chain, at two warps a scheduler, set the pace; hence the
//   second block an SM.

#pragma once

#include <type_traits>

#include "flash_fwd_api.cuh"
#include "sm90_common.cuh"

namespace {

template <int D>
struct FwdShape {
  // up to D = 96 two blocks share an SM (128 registers a thread): 64-key
  // tiles keep the scores, P and O in them (at D = 128 they would spill)
  static constexpr int kBlocksPerSm = D <= 96 ? 2 : 1;
  static constexpr int kBK = D == 128 ? 128 : 64;  // keys a tile
  // the ring's depth: at most four stages, as many as fit in the block's
  // share of shared memory (at D = 128 a third one fits only without key
  // rows)
  static constexpr int kMaxStages = D <= 64 ? 4 : D <= 128 ? 3 : 2;
  static constexpr int kKVBytes = kBK * D * 2;        // one K or V tile
};

// Byte offsets into a block's shared memory (its base aligned to 1024): the
// Q tile of qr rows at 0, then the ring's ns K tiles and ns V tiles, each
// tile's coordinates, its key rows (segment ids, then positions; only where
// the call has them) and the mbarriers.
struct FwdLayout {
  int k, v, meta, rows, bar, bytes;
};
__host__ __device__ constexpr FwdLayout fwd_layout(int d, int bk, int ns,
                                                   int qr, bool key_rows) {
  const int k = qr * d * 2, v = k + ns * bk * d * 2;
  const int meta = v + ns * bk * d * 2;
  const int rows = meta + ns * (int)sizeof(TileMeta);
  const int bar = (rows + (key_rows ? ns * 2 * bk * 4 : 0) + 15) / 16 * 16;
  return FwdLayout{k, v, meta, rows, bar, bar + (2 * ns + 1) * 8 + 1024};
}
constexpr int kSmemLimit = 227 * 1024;

// the softmax's mask paths (see the kernel)
constexpr int kOpen = 0, kLimit = 1, kGeneral = 2;

struct FwdParams {
  const int *q_seg, *k_seg, *q_pos, *k_pos;
  Bias bias;
  float* lse;
  int H, HK, SQ, SK, DH;
  float scale;
  int causal, window;
  Dropout dr;
  int ns;   // the ring's stages (2 to kMaxStages)
};

// S (m64nN, both operands K-major in shared memory)
template <typename T, int N>
__device__ __forceinline__ void ss_row(float (*d)[4], uint64_t a, uint64_t b,
                                       int acc) {
  if constexpr (N == 128)
    Wg<T>::ss128(d, a, b, acc);
  else
    Wg<T>::ss64(d, a, b, acc);
}

// One block per (128 queries, or 64 where sq <= 64; batch * head): one
// consumer warpgroup per 64 queries; warp 0 also produces.
template <typename T, int D, bool EXTRA, bool DROP>
__global__ void __launch_bounds__(256, FwdShape<D>::kBlocksPerSm)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o,
                   const FwdParams p) {
  using Sh = FwdShape<D>;
  constexpr int BK = Sh::kBK, KVB = Sh::kKVBytes;
  constexpr int DT = D / 8, KS = D / 16, NT = BK / 8, RPL = BK / 32;
  const int ng = blockDim.x >> 7;      // consumer warpgroups: 1 or 2
  const int qr = 64 * ng, ns = p.ns;   // Q tile rows, ring stages
  const bool key_rows = p.q_seg != nullptr || (EXTRA && p.q_pos != nullptr);
  const FwdLayout lay = fwd_layout(D, BK, ns, qr, key_rows);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  unsigned char* sQ = sm;
  unsigned char* sK = sm + lay.k;
  unsigned char* sV = sm + lay.v;
  TileMeta* meta = reinterpret_cast<TileMeta*>(sm + lay.meta);
  int* rows_all = reinterpret_cast<int*>(sm + lay.rows);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + lay.bar);
  uint64_t *full = bars, *empty = bars + ns, *q_bar = bars + 2 * ns;

  const int tid = threadIdx.x, lane = tid & 31;
  // warp and warpgroup indices the compiler knows to be uniform, so that it
  // keeps each warpgroup's wgmma sequence whole
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int cw = warp & 3, wt = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int bi = bh / p.H, hi = bh % p.H;
  const int kvh = hi / (p.H / p.HK);
  const int bhk = bi * p.HK + kvh;
  const int SQ = p.SQ, SK = p.SK;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64 * ng;
  const bool has_pos = EXTRA && p.q_pos != nullptr;
  const int off = has_pos ? 0 : SK - SQ;
  const bool has_seg = p.q_seg != nullptr;
  const bool has_bias = EXTRA && p.bias.p != nullptr;

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      // the producer's TMA arrival, and with key rows its other lanes'
      mbar_init(&full[s], key_rows ? 32 : 1);
      mbar_init(&empty[s], 4 * ng);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, ng * 64 * D * 2);
#pragma unroll
    for (int c = 0; c < D / kChunk; ++c)
      for (int h = 0; h < ng; ++h)
        tma_box(sQ + c * qr * 64 + h * 64 * 64, &tm_q, q_bar, c * kChunk,
                q0 + h * 64, bh);
  }

  // the producer's walk: keys these queries can see, nothing past the
  // causal diagonal of the last, nothing before the window of the first
  // (with positions, every tile, each tested on its own bounds)
  int pn = 0, pn_end = SK, issued = 0, pstage = 0;
  uint32_t pphase = 0;
  bool ended = false;
  int q_lo = 0, q_hi = 0;
  if (has_pos) {
    if (warp == 0)
      pos_bounds(p.q_pos, q0, min(64 * ng, SQ - q0), lane, &q_lo, &q_hi);
  } else {
    const int q_last = min(q0 + 64 * ng, SQ) - 1;
    if (p.causal) pn_end = min(SK, q_last + off + 1);
    if (p.window > 0) pn = max(0, q0 + off - p.window + 1);
    pn -= pn % BK;
  }
  auto produce = [&](int target) {
    while (!ended && issued < target) {
      if (has_pos) {
        while (pn < pn_end) {
          int k_lo, k_hi;
          pos_bounds(p.k_pos, pn, min(BK, SK - pn), lane, &k_lo, &k_hi);
          if (tile_live(q_lo, q_hi, k_lo, k_hi, p.window)) break;
          pn += BK;
        }
      }
      const bool end = pn >= pn_end;
      // the tile's key rows, read before the wait so that their latency
      // hides behind it
      int rs[RPL], rp[RPL];
      if (key_rows) {
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          const int kj = pn + lane + 32 * r;
          const bool ok = !end && kj < SK;
          rs[r] = (has_seg && ok) ? p.k_seg[(size_t)bi * SK + kj] : 0;
          rp[r] = (has_pos && ok) ? p.k_pos[kj] : 0;
        }
      }
      mbar_wait(&empty[pstage], pphase ^ 1);
      if (key_rows) {
        int* rows = rows_all + pstage * 2 * BK;
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          rows[lane + 32 * r] = rs[r];
          rows[BK + lane + 32 * r] = rp[r];
        }
        if (lane != 0) mbar_arrive(&full[pstage]);
      }
      if (lane == 0) {
        if (end) {
          meta[pstage].a = -1;
          mbar_arrive(&full[pstage]);
        } else {
          meta[pstage] = TileMeta{pn, 0};
          mbar_expect_tx(&full[pstage], 2 * KVB);
          tma_tile<D, BK>(sK + pstage * KVB, &tm_k, &full[pstage], pn, bhk);
          tma_tile<D, BK>(sV + pstage * KVB, &tm_v, &full[pstage], pn, bhk);
        }
      }
      ended = end;
      pn += BK;
      ++issued;
      if (++pstage == ns) {
        pstage = 0;
        pphase ^= 1;
      }
    }
  };

  const int wq0 = q0 + 64 * wg;
  const int qi0 = wq0 + cw * 16 + g, qi1 = qi0 + 8;
  const int qs0 = (has_seg && qi0 < SQ) ? p.q_seg[(size_t)bi * SQ + qi0] : 0;
  const int qs1 = (has_seg && qi1 < SQ) ? p.q_seg[(size_t)bi * SQ + qi1] : 0;
  const int qr0 = has_pos ? (qi0 < SQ ? p.q_pos[qi0] : 0) : qi0;
  const int qr1 = has_pos ? (qi1 < SQ ? p.q_pos[qi1] : 0) : qi1;
  const long long bbase = bi * p.bias.sb + (long long)hi * p.bias.sh;
  const float scale2 = p.scale * kLog2e;
  // what turns a score (with a bias: the scaled score plus the bias) into
  // log2 units
  const float mul = has_bias ? kLog2e : scale2;
  const KeepDiv kd = keep_div(p.dr.keep);

  float o[DT][4];
  zero_acc<DT>(o);
  // the running max (log2 units) and the partial normaliser of rows qi0
  // and qi1; the quad's partials share the max and are summed at the end
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // Without segment ids, a bias, positions or a window (and with a
  // positive scale), a tile's mask is each row's last visible key: the
  // causal diagonal, or sk - 1 (lim, relative to the tile's first key).
  const bool simple = !has_seg && !has_bias && !has_pos && p.scale > 0.f &&
                      p.window <= 0;
  auto row_limit = [&](int qi) {
    return min(p.causal ? qi + off : INT_MAX - BK, SK - 1);
  };
  const int lim0 = row_limit(qi0), lim1 = row_limit(qi1);

  mbar_wait(q_bar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0;; ++it) {
    if (warp == 0) produce(it + ns);
    mbar_wait(&full[stage], phase);
    const int k0 = *reinterpret_cast<volatile const int*>(&meta[stage].a);
    if (k0 < 0) break;
    // a tile with no live score for this warpgroup's rows adds nothing
    bool live = wq0 < SQ;
    if (!has_pos) {
      const int q_last = min(wq0 + 63, SQ - 1);
      const int k_last = min(k0 + BK, SK) - 1;
      if (p.causal && k0 > q_last + off) live = false;
      if (p.window > 0 && k_last <= wq0 + off - p.window) live = false;
    }
    if (live) {
      const unsigned char* tk = sK + stage * KVB;
      const unsigned char* tv = sV + stage * KVB;
      const int* krow = rows_all + stage * 2 * BK;
      float s[NT][4];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ss_row<T, BK>(s, desc_k_rows(sQ, qr, 64 * wg, kk),
                      desc_k<BK>(tk, 0, kk), kk > 0);
      wg_commit();
      wg_wait0();
      fence_acc<NT>(s);

      if (has_bias) {
        // the scaled scores plus the bias, in place (mul is log2 e)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kj = k0 + j * 8 + 2 * t + (i & 1);
            const int qi = i < 2 ? qi0 : qi1;
            float x = s[j][i] * p.scale;
            if (qi < SQ && kj < SK)
              x = __fadd_rn(x, bias_at(p.bias, bbase, qi, kj));
            s[j][i] = x;
          }
      }
      // OPEN: every pair of this warpgroup's rows and the tile's keys live,
      // no mask test; LIMIT: the simple mask, one compare a score; both
      // fold the scale into the exponent's fma. GENERAL: the whole mask
      // (`score_masked`) on the scaled scores.
      const bool open = simple && k0 + BK <= SK &&
                        (!p.causal || wq0 + off >= k0 + BK - 1);
      auto softmax = [&](auto kind_tag) {
        constexpr int KIND = decltype(kind_tag)::value;
        constexpr bool FOLD = KIND != kGeneral;
        if constexpr (KIND == kLimit) {
          // -inf where the key is past the row's limit
          const int r0 = lim0 - k0, r1 = lim1 - k0;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kl = j * 8 + 2 * t + e;
              if (kl > r0) s[j][e] = -INFINITY;
              if (kl > r1) s[j][2 + e] = -INFINITY;
            }
          }
        }
        if constexpr (KIND == kGeneral) {
          // log2-unit scores, -inf where masked
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kl = j * 8 + 2 * t + e;
              const int kj = k0 + kl;
              const int ks = has_seg ? krow[kl] : 0;
              const int kc = has_pos ? krow[BK + kl] : kj;
              const bool mk0 = score_masked(qr0, kc, off, kj < SK, p.causal,
                                            p.window, has_seg, qs0, ks);
              const bool mk1 = score_masked(qr1, kc, off, kj < SK, p.causal,
                                            p.window, has_seg, qs1, ks);
              s[j][e] = mk0 ? -INFINITY : s[j][e] * mul;
              s[j][2 + e] = mk1 ? -INFINITY : s[j][2 + e] * mul;
            }
          }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        if constexpr (FOLD) {
          // scale > 0: the max of the scaled scores is the scaled max
          mx0 *= scale2;
          mx1 *= scale2;
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        // a row with no live score yet subtracts 0: its P stays 0
        const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
        const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
        const float c0 = ex2_ftz(m0 - mu0), c1 = ex2_ftz(m1 - mu1);
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (FOLD) {
              s[j][e] = ex2_ftz(fmaf(s[j][e], scale2, -mu0));
              s[j][2 + e] = ex2_ftz(fmaf(s[j][2 + e], scale2, -mu1));
            } else {
              s[j][e] = ex2_ftz(s[j][e] - mu0);
              s[j][2 + e] = ex2_ftz(s[j][2 + e] - mu1);
            }
            sum0 += s[j][e];
            sum1 += s[j][2 + e];
          }
        }
        l0 = l0 * c0 + sum0;
        l1 = l1 * c1 + sum1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          o[j][0] *= c0;
          o[j][1] *= c0;
          o[j][2] *= c1;
          o[j][3] *= c1;
        }
      };
      if (open)
        softmax(std::integral_constant<int, kOpen>{});
      else if (simple)
        softmax(std::integral_constant<int, kLimit>{});
      else
        softmax(std::integral_constant<int, kGeneral>{});
      if constexpr (DROP) {
        // dropout touches only what multiplies V; l keeps the full sum
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kj = k0 + j * 8 + 2 * t + e;
            s[j][e] = dropout_keep(p.dr.seed, bh, qi0, kj, p.dr.thresh)
                          ? div_keep(s[j][e], kd)
                          : 0.f;
            s[j][2 + e] = dropout_keep(p.dr.seed, bh, qi1, kj, p.dr.thresh)
                              ? div_keep(s[j][2 + e], kd)
                              : 0.f;
          }
        }
      }

      // O += P V, P rounded to T
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<T>(a[kk], s, kk);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        rs_row<T, D, BK>(o, a[kk], tv, kk);
      wg_commit();
      wg_wait0();
      fence_acc<DT>(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == ns) {
      stage = 0;
      phase ^= 1;
    }
  }

  // O / l in T over this warpgroup's rows of the Q tile (64-byte swizzle:
  // 16-byte unit u of row r at u ^ ((r >> 1) & 3)), then TMA stores it
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  constexpr float kValid = kNegInf * 0.5f * kLog2e;
  const bool v0 = m0 > kValid, v1 = m1 > kValid;
  const float safe0 = l0 > 0.f ? l0 : 1.f, safe1 = l1 > 0.f ? l1 : 1.f;
  wg_sync(wg);   // every S product of this warpgroup has read its Q rows
  unsigned char* so = sQ + wg * 64 * 64;   // chunk c at c * qr * 64
  const int r0 = cw * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    unsigned char* chunk = so + (j >> 2) * qr * 64;
    uint32_t w0, w1;
    Elem<T>::from_pair(&w0, v0 ? o[j][0] / safe0 : 0.f,
                       v0 ? o[j][1] / safe0 : 0.f);
    Elem<T>::from_pair(&w1, v1 ? o[j][2] / safe1 : 0.f,
                       v1 ? o[j][3] / safe1 : 0.f);
    *reinterpret_cast<uint32_t*>(chunk + r0 * 64 +
                                 (((j & 3) ^ ((r0 >> 1) & 3)) << 4) + 4 * t) =
        w0;
    *reinterpret_cast<uint32_t*>(chunk + r1 * 64 +
                                 (((j & 3) ^ ((r1 >> 1) & 3)) << 4) + 4 * t) =
        w1;
  }
  fence_async_shared();
  wg_sync(wg);
  if (wt == 0 && wq0 < SQ) {
#pragma unroll
    for (int c = 0; c < D / kChunk; ++c)
      tma_store_box(&tm_o, so + c * qr * 64, c * kChunk, wq0, bh);
    bulk_commit();
  }
  if (t == 0) {
    float* lp = p.lse + (size_t)bh * SQ;
    if (qi0 < SQ) lp[qi0] = v0 ? m0 * kLn2 + logf(safe0) : kNegInf;
    if (qi1 < SQ) lp[qi1] = v1 ? m1 * kLn2 + logf(safe1) : kNegInf;
  }
  if (wt == 0 && wq0 < SQ) bulk_wait_read();
}

template <typename T, int D, bool EXTRA, bool DROP>
int launch_sm90(const Args& a, cudaStream_t stream) {
  if (a.DH % 8 || a.DH < kChunk) return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr)
    return (int)cudaErrorSharedObjectSymbolNotFound;
  constexpr CUtensorMapDataType ty = Wg<T>::kMapType;
  CUtensorMap tq, tk, tv, to;
  if (!encode_map(&tq, ty, a.q, a.B * a.H, a.SQ, a.DH) ||
      !encode_map(&tk, ty, a.k, a.B * a.HK, a.SK, a.DH) ||
      !encode_map(&tv, ty, a.v, a.B * a.HK, a.SK, a.DH) ||
      !encode_map(&to, ty, a.out, a.B * a.H, a.SQ, a.DH))
    return (int)cudaErrorInvalidValue;
  using Sh = FwdShape<D>;
  // one warpgroup a block where sq <= 64, else two over 128 queries; a ring
  // no deeper than the key tiles (short sequences keep their blocks small,
  // so that more of them share an SM), and at least two stages
  const int ng = a.SQ <= 64 ? 1 : 2;
  const bool key_rows = a.q_seg != nullptr || a.q_pos != nullptr;
  const int tiles = (a.SK + Sh::kBK - 1) / Sh::kBK;
  int ns = tiles < 2 ? 2 : tiles < Sh::kMaxStages ? tiles : Sh::kMaxStages;
  while (ns > 2 && fwd_layout(D, Sh::kBK, ns, 64 * ng, key_rows).bytes >
                       kSmemLimit / Sh::kBlocksPerSm)
    --ns;
  const FwdParams p{static_cast<const int*>(a.q_seg),
                    static_cast<const int*>(a.k_seg),
                    static_cast<const int*>(a.q_pos),
                    static_cast<const int*>(a.k_pos),
                    a.bias, static_cast<float*>(a.lse), a.H, a.HK, a.SQ,
                    a.SK, a.DH, a.scale, a.causal, a.window, a.dr, ns};
  static_assert(fwd_layout(D, Sh::kBK, 2, 128, true).bytes <= kSmemLimit,
                "shared memory past the sm_90 limit");
  cudaError_t e = allow_smem(flash_fwd_sm90<T, D, EXTRA, DROP>, kSmemLimit);
  if (e != cudaSuccess) return (int)e;
  const int bytes = fwd_layout(D, Sh::kBK, ns, 64 * ng, key_rows).bytes;
  dim3 grid((a.SQ + 64 * ng - 1) / (64 * ng), a.B * a.H);
  flash_fwd_sm90<T, D, EXTRA, DROP>
      <<<grid, 128 * ng, bytes, stream>>>(tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

// EXTRA (bias or positions) and DROP (dropout) are template flags: without
// them the kernel carries none of their code
template <typename T, int D>
int launch_extra(const Args& a, cudaStream_t stream) {
  const bool extra = a.q_pos != nullptr || a.bias.p != nullptr;
  if (a.dr.on)
    return extra ? launch_sm90<T, D, true, true>(a, stream)
                 : launch_sm90<T, D, false, true>(a, stream);
  return extra ? launch_sm90<T, D, true, false>(a, stream)
               : launch_sm90<T, D, false, false>(a, stream);
}

template <typename T>
int launch_width(const Args& a, cudaStream_t stream) {
  switch (built_width(a.DH)) {
    case 32:
      return launch_extra<T, 32>(a, stream);
    case 64:
      return launch_extra<T, 64>(a, stream);
    case 96:
      return launch_extra<T, 96>(a, stream);
    case 128:
      return launch_extra<T, 128>(a, stream);
    case 256:
      return launch_extra<T, 256>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
