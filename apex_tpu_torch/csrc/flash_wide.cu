// Flash attention, forward and backward, at the head widths the wgmma/TMA
// kernels are not built for: fp32 past 128 and bf16 or fp16 past 256, any
// head_dim >= 1 (attention.py `wide_route` picks this library by dtype and
// head_dim alone; every other width keeps its wgmma kernel).
//
// Replaces, at those widths: apex_tpu/ops/attention.py `_fwd_kernel` (:182,
// `pallas_call` at :373), `_bwd_dq_kernel` (:402, :657) and
// `_bwd_dkv_kernel` (:470, :711). The functions are the ones
// flash_fwd_api.cuh and flash_bwd_api.cuh set out, with the same arguments
// and the same feature set: GQA, segment ids (both sides, or key side only
// with every query in segment 0), causal with the sk - sq offset, the
// window, global positions (tiles skipped by `tile_live` on their position
// bounds), the additive bias in every broadcast shape (`bias_at`), dropout
// by the reference's hash (`dropout_keep`, divided by 1 - rate through
// `div_keep`) and the lse cotangent. A row with no live key writes 0 and
// lse NEG_INF; its gradients are 0.
//
// Arithmetic: fp32 on the CUDA cores, 16-bit inputs widened as they are
// staged. Products are fma chains (the order and the contraction differ
// from the plain versions' einsums: the tests hold the kernels to 1e-5 of
// each output's largest |value| in fp32). The forward keeps P in fp32 for
// P V, as the plain forward does; the backward rounds dS and the P of dV to
// the input dtype before their products, as the plain backward and the
// reference's kernels do.
//
// Design (simple: making it fast is later work):
// - A block is 256 threads over a 64-row tile and one 64-column chunk of
//   the output: grid (ceil(D / 64), row tiles, heads). Each thread holds a
//   4 x 4 micro-tile (rows ty + 16 i, columns tx + 16 j), so an output chunk
//   is 16 fp32 registers a thread and D has no limit but memory.
// - Scores (and dP) are summed over the whole of D in 32-column chunks
//   staged through shared memory as fp32 (64 x 33 floats an operand, the
//   pad keeping the column reads free of bank conflicts). Every column
//   chunk's block recomputes them: ceil(D / 64) times the score products of
//   a kernel that kept all of D in one block, the price of holding no
//   64 x D accumulator.
// - Forward: an online softmax over 64-key tiles (running max and
//   normaliser a row, O rescaled in registers), P written to shared memory
//   and multiplied by the staged 64 x 64 chunk of V.
// - dq: P recomputed from the lse (clamped at NEG_INF / 2), dP = dO V^T,
//   dS into shared memory, dq += dS K over the key tiles; dq scaled once.
// - dk/dv: one block per 64 keys of a kv head, walking the q heads of its
//   group and their query tiles; S^T and dP^T, then dv += P^T dO and
//   dk += dS^T Q, one after the other through one shared tile.
// - Shared memory 33.5 KB a block (two staging tiles, which also hold the
//   output operand's 64 x 64 chunk, and the P / dS tile): static.
// Bound on the card: the other flash kernels' (chip_smoke.py phase 14g):
// the larger of the bytes over 3.35 TB/s and the products (2 d a live pair
// and product) over 989 TFLOP/s in bf16 and fp16, 989 / 6 in fp32 (exact
// products on the tensor cores). This design does them on the CUDA cores
// (67 TFLOP/s of fp32 fma) and recomputes the scores once a column chunk,
// so it sits far above that bound; a tensor-core design is later work.

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kTile = 64;       // rows of a query or key tile
constexpr int kCols = 64;       // output columns of a block
constexpr int kDepth = 32;      // columns of a staged score-product chunk
constexpr int kThreads = 256;
constexpr int kPadA = kDepth + 1;
constexpr int kPadB = kTile + 1;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

// x rounded to T and widened again (the plain backward's `.to(dtype)`)
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f<T>(Elem<T>::from_f(x));
}

struct WideArgs {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta, *glse;
  const int *q_seg, *k_seg, *q_pos, *k_pos;
  Bias bias;
  void *out, *dq, *dk, *dv;
  float* lse;
  int B, H, HK, SQ, SK, D;
  float scale;
  int causal, window;
  Dropout dr;
};

// Rows r0 .. r0 + 63 and columns c0 .. c0 + W - 1 of a (rows, D) matrix
// into dst (row pitch P floats) as fp32, 0 outside the matrix.
template <typename T, int W, int P>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int rows, int c0, int D) {
  for (int i = threadIdx.x; i < kTile * W; i += kThreads) {
    const int r = i / W, c = i - (i / W) * W;
    const int rr = r0 + r, cc = c0 + c;
    dst[r * P + c] =
        (rr < rows && cc < D) ? to_f<T>(src[(size_t)rr * D + cc]) : 0.f;
  }
}

// acc[i][j] += sum over the staged depth of a[ty + 16 i][.] b[tx + 16 j][.]
__device__ __forceinline__ void dot_chunk(float (&acc)[4][4], const float* a,
                                          const float* b, int ty, int tx) {
#pragma unroll 8
  for (int kk = 0; kk < kDepth; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kPadA + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kPadA + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc (rows r0 of a and b's rows r1, both 64) = a b^T summed over all D
// columns of the two (rows, D) matrices, staged through sa and sb
template <typename T>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], float* sa,
                                         float* sb, const T* a, int ra,
                                         int rows_a, const T* b, int rb,
                                         int rows_b, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < D; c0 += kDepth) {
    __syncthreads();
    stage<T, kDepth, kPadA>(sa, a, ra, rows_a, c0, D);
    stage<T, kDepth, kPadA>(sb, b, rb, rows_b, c0, D);
    __syncthreads();
    dot_chunk(acc, sa, sb, ty, tx);
  }
}

// out[i][j] += sum over 64 of p[ty + 16 i][k] m[k][tx + 16 j]
__device__ __forceinline__ void tile_mul(float (&out)[4][4], const float* p,
                                         const float* m, int ty, int tx) {
#pragma unroll 8
  for (int kk = 0; kk < kTile; ++kk) {
    float pv[4], mv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * kPadB + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) mv[j] = m[kk * kPadB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(pv[i], mv[j], out[i][j]);
  }
}

// the max and the sum over the 16 lanes (tx) that share a row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whether a (query tile, key tile) pair can hold an unmasked score: the
// static causal and window bounds, or `tile_live` on the position bounds
// (every warp reduces the same positions, so the block agrees).
__device__ __forceinline__ bool pair_live(const WideArgs& p, int q0, int k0,
                                          int off) {
  const int q_last = min(q0 + kTile, p.SQ) - 1;
  const int k_last = min(k0 + kTile, p.SK) - 1;
  if (p.q_pos != nullptr) {
    const int lane = threadIdx.x & 31;
    int q_lo, q_hi, k_lo, k_hi;
    pos_bounds(p.q_pos, q0, q_last - q0 + 1, lane, &q_lo, &q_hi);
    pos_bounds(p.k_pos, k0, k_last - k0 + 1, lane, &k_lo, &k_hi);
    return tile_live(q_lo, q_hi, k_lo, k_hi, p.window);
  }
  if (p.causal && k0 > q_last + off) return false;
  if (p.window > 0 && k_last <= q0 + off - p.window) return false;
  return true;
}

// the scaled score of (qi, kj) plus the bias, or -inf where it is masked
__device__ __forceinline__ float score(const WideArgs& p, float s,
                                       long long bbase, int b, int qi,
                                       int kj, int off) {
  const bool q_ok = qi < p.SQ, k_ok = kj < p.SK;
  if (!q_ok || !k_ok) return -INFINITY;
  const bool has_seg = p.q_seg != nullptr;
  const int qs = has_seg ? p.q_seg[(size_t)b * p.SQ + qi] : 0;
  const int ks = has_seg ? p.k_seg[(size_t)b * p.SK + kj] : 0;
  const int row = p.q_pos ? p.q_pos[qi] : qi;
  const int col = p.k_pos ? p.k_pos[kj] : kj;
  if (score_masked(row, col, off, true, p.causal, p.window, has_seg, qs, ks))
    return -INFINITY;
  float x = __fmul_rn(s, p.scale);
  if (p.bias.p != nullptr) x = __fadd_rn(x, bias_at(p.bias, bbase, qi, kj));
  return x;
}

// -- forward ------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_wide_fwd(const WideArgs p) {
  __shared__ float s_stage[2 * kTile * kPadA];  // Q, K chunks; V's chunk
  __shared__ float s_p[kTile * kPadB];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c0 = blockIdx.x * kCols, q0 = blockIdx.y * kTile;
  const int bh = blockIdx.z, b = bh / p.H, h = bh - b * p.H;
  const int hk = h / (p.H / p.HK);
  const int off = p.q_pos ? 0 : p.SK - p.SQ;
  const T* q = static_cast<const T*>(p.q) + (size_t)bh * p.SQ * p.D;
  const T* k = static_cast<const T*>(p.k) + ((size_t)b * p.HK + hk) * p.SK * p.D;
  const T* v = static_cast<const T*>(p.v) + ((size_t)b * p.HK + hk) * p.SK * p.D;
  const long long bbase = b * p.bias.sb + (long long)h * p.bias.sh;
  const KeepDiv kd = keep_div(p.dr.keep);

  float o[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < p.SK; k0 += kTile) {
    if (!pair_live(p, q0, k0, off)) continue;
    float s[4][4];
    tile_dot<T>(s, s_stage, s_stage + kTile * kPadA, q, q0, p.SQ, k, k0,
                p.SK, p.D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score(p, s[i][j], bbase, b, qi, k0 + tx + 16 * j, off);
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      // a row with no live score yet subtracts 0: its P stays 0
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float c = expf(__fsub_rn(m[i], mu));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(__fsub_rn(s[i][j], mu));
        sum += e;
        float pv = e;
        // dropout touches only what multiplies V; l keeps the full sum
        if (p.dr.on) {
          const int kj = k0 + tx + 16 * j;
          pv = dropout_keep(p.dr.seed, bh, qi, kj, p.dr.thresh)
                   ? div_keep(e, kd) : 0.f;
        }
        s_p[(ty + 16 * i) * kPadB + tx + 16 * j] = pv;
      }
      l[i] = l[i] * c + sum;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= c;
    }
    __syncthreads();
    stage<T, kCols, kPadB>(s_stage, v, k0, p.SK, c0, p.D);
    __syncthreads();
    tile_mul(o, s_p, s_stage, ty, tx);
    __syncthreads();
  }

  // O / l and the lse; a row with no live key writes 0 and NEG_INF
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    const float li = row_sum(l[i]);
    const bool valid = m[i] > kNegInf * 0.5f;
    const float safe = li > 0.f ? li : 1.f;
    if (qi >= p.SQ) continue;
    T* orow = static_cast<T*>(p.out) + ((size_t)bh * p.SQ + qi) * p.D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < p.D) orow[c] = Elem<T>::from_f(valid ? o[i][j] / safe : 0.f);
    }
    if (blockIdx.x == 0 && tx == 0)
      p.lse[(size_t)bh * p.SQ + qi] = valid ? m[i] + logf(safe) : kNegInf;
  }
}

// -- dq -----------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_wide_dq(const WideArgs p) {
  __shared__ float s_stage[2 * kTile * kPadA];  // Q/K, dO/V chunks; K's
  __shared__ float s_p[kTile * kPadB];          // dS
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c0 = blockIdx.x * kCols, q0 = blockIdx.y * kTile;
  const int bh = blockIdx.z, b = bh / p.H, h = bh - b * p.H;
  const int hk = h / (p.H / p.HK);
  const int off = p.q_pos ? 0 : p.SK - p.SQ;
  const size_t qb = (size_t)bh * p.SQ * p.D;
  const size_t kb = ((size_t)b * p.HK + hk) * p.SK * p.D;
  const T* q = static_cast<const T*>(p.q) + qb;
  const T* dout = static_cast<const T*>(p.dout) + qb;
  const T* k = static_cast<const T*>(p.k) + kb;
  const T* v = static_cast<const T*>(p.v) + kb;
  const long long bbase = b * p.bias.sb + (long long)h * p.bias.sh;
  const KeepDiv kd = keep_div(p.dr.keep);

  float lse[4], dlt[4], gl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    const size_t r = (size_t)bh * p.SQ + min(qi, p.SQ - 1);
    lse[i] = fmaxf(p.lse_in[r], kNegInf * 0.5f);
    dlt[i] = p.delta[r];
    gl[i] = p.glse ? p.glse[r] : 0.f;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float* sa = s_stage;
  float* sb = s_stage + kTile * kPadA;
  for (int k0 = 0; k0 < p.SK; k0 += kTile) {
    if (!pair_live(p, q0, k0, off)) continue;
    float s[4][4], dp[4][4];
    tile_dot<T>(s, sa, sb, q, q0, p.SQ, k, k0, p.SK, p.D, ty, tx);
    tile_dot<T>(dp, sa, sb, dout, q0, p.SQ, v, k0, p.SK, p.D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float x = score(p, s[i][j], bbase, b, qi, kj, off);
        const float pp = x == -INFINITY ? 0.f : expf(__fsub_rn(x, lse[i]));
        float d = dp[i][j];
        if (p.dr.on)
          d = dropout_keep(p.dr.seed, bh, qi, kj, p.dr.thresh)
                  ? div_keep(d, kd) : 0.f;
        float ds = __fmul_rn(pp, __fsub_rn(d, dlt[i]));
        if (p.glse) ds = __fadd_rn(ds, __fmul_rn(pp, gl[i]));
        s_p[(ty + 16 * i) * kPadB + tx + 16 * j] = round_t<T>(ds);
      }
    }
    __syncthreads();
    stage<T, kCols, kPadB>(s_stage, k, k0, p.SK, c0, p.D);
    __syncthreads();
    tile_mul(acc, s_p, s_stage, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.SQ) continue;
    T* row = static_cast<T*>(p.dq) + qb + (size_t)qi * p.D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < p.D) row[c] = Elem<T>::from_f(__fmul_rn(acc[i][j], p.scale));
    }
  }
}

// -- dk / dv ------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_wide_dkv(const WideArgs p) {
  __shared__ float s_stage[2 * kTile * kPadA];  // K/Q, V/dO chunks; dO's, Q's
  __shared__ float s_p[kTile * kPadB];          // P^T, then dS^T
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c0 = blockIdx.x * kCols, k0 = blockIdx.y * kTile;
  const int bhk = blockIdx.z, b = bhk / p.HK, hk = bhk - b * p.HK;
  const int group = p.H / p.HK;
  const int off = p.q_pos ? 0 : p.SK - p.SQ;
  const size_t kb = (size_t)bhk * p.SK * p.D;
  const T* k = static_cast<const T*>(p.k) + kb;
  const T* v = static_cast<const T*>(p.v) + kb;
  const KeepDiv kd = keep_div(p.dr.keep);
  float* sa = s_stage;
  float* sb = s_stage + kTile * kPadA;

  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g, bh = b * p.H + h;
    const size_t qb = (size_t)bh * p.SQ * p.D;
    const T* q = static_cast<const T*>(p.q) + qb;
    const T* dout = static_cast<const T*>(p.dout) + qb;
    const long long bbase = b * p.bias.sb + (long long)h * p.bias.sh;
    for (int q0 = 0; q0 < p.SQ; q0 += kTile) {
      if (!pair_live(p, q0, k0, off)) continue;
      // S^T and dP^T: rows are this block's keys, columns the tile's queries
      float s[4][4], dp[4][4];
      tile_dot<T>(s, sa, sb, k, k0, p.SK, q, q0, p.SQ, p.D, ty, tx);
      tile_dot<T>(dp, sa, sb, v, k0, p.SK, dout, q0, p.SQ, p.D, ty, tx);
      float ds[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + tx + 16 * j;
        const size_t r = (size_t)bh * p.SQ + min(qi, p.SQ - 1);
        const float L = fmaxf(p.lse_in[r], kNegInf * 0.5f);
        const float dl = p.delta[r];
        const float gl = p.glse ? p.glse[r] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kj = k0 + ty + 16 * i;
          const float x = score(p, s[i][j], bbase, b, qi, kj, off);
          const float pp = x == -INFINITY ? 0.f : expf(__fsub_rn(x, L));
          const bool kept =
              !p.dr.on || dropout_keep(p.dr.seed, bh, qi, kj, p.dr.thresh);
          float d = dp[i][j];
          float pv = pp;
          if (p.dr.on) {
            d = kept ? div_keep(d, kd) : 0.f;
            pv = kept ? div_keep(pp, kd) : 0.f;
          }
          float dsv = __fmul_rn(pp, __fsub_rn(d, dl));
          if (p.glse) dsv = __fadd_rn(dsv, __fmul_rn(pp, gl));
          ds[i][j] = round_t<T>(dsv);
          s_p[(ty + 16 * i) * kPadB + tx + 16 * j] = round_t<T>(pv);
        }
      }
      // dv += P^T dO
      __syncthreads();
      stage<T, kCols, kPadB>(s_stage, dout, q0, p.SQ, c0, p.D);
      __syncthreads();
      tile_mul(dv, s_p, s_stage, ty, tx);
      __syncthreads();
      // dk += dS^T Q
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s_p[(ty + 16 * i) * kPadB + tx + 16 * j] = ds[i][j];
      stage<T, kCols, kPadB>(s_stage, q, q0, p.SQ, c0, p.D);
      __syncthreads();
      tile_mul(dk, s_p, s_stage, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= p.SK) continue;
    T* krow = static_cast<T*>(p.dk) + kb + (size_t)kj * p.D;
    T* vrow = static_cast<T*>(p.dv) + kb + (size_t)kj * p.D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= p.D) continue;
      krow[c] = Elem<T>::from_f(__fmul_rn(dk[i][j], p.scale));
      vrow[c] = Elem<T>::from_f(dv[i][j]);
    }
  }
}

template <typename T>
int launch_fwd(const WideArgs& a, cudaStream_t s) {
  const dim3 grid((a.D + kCols - 1) / kCols, (a.SQ + kTile - 1) / kTile,
                  a.B * a.H);
  flash_wide_fwd<T><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const WideArgs& a, cudaStream_t s) {
  const int cols = (a.D + kCols - 1) / kCols;
  if (a.dq != nullptr) {
    const dim3 grid(cols, (a.SQ + kTile - 1) / kTile, a.B * a.H);
    flash_wide_dq<T><<<grid, kThreads, 0, s>>>(a);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (a.dk != nullptr) {
    const dim3 grid(cols, (a.SK + kTile - 1) / kTile, a.B * a.HK);
    flash_wide_dkv<T><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// the argument checks the wgmma entries make (flash_fwd_api.cuh,
// flash_bwd_api.cuh); 0 where the call may go on
int check_args(int B, int H, int HK, int D, const void* q_pos,
               const void* k_pos, int causal) {
  if (HK <= 0 || H % HK || B * H > 65535 || D < 1)
    return (int)cudaErrorInvalidValue;
  if ((q_pos == nullptr) != (k_pos == nullptr) || (q_pos && !causal))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// The forward: the arguments of `apex_flash_fwd` (flash_fwd_api.cuh), with
// q, k, v and out of `dtype` (0 fp32, 1 bf16, 2 fp16) at their own head_dim
// D (no padding, no part planes).
extern "C" int apex_flash_wide_fwd(
    const void* q, const void* k, const void* v, const void* q_seg,
    const void* k_seg, const void* q_pos, const void* k_pos, const void* bias,
    int bias_dtype, long long sb, long long sh, long long sq, long long sk,
    void* out, void* lse, int B, int H, int HK, int SQ, int SK, int D,
    int dtype, float scale, int causal, int window, int dropout,
    uint32_t seed, uint32_t thresh, float keep, void* stream) {
  if (B == 0 || H == 0 || SQ == 0) return (int)cudaGetLastError();
  if (SK < 1) return (int)cudaErrorInvalidValue;
  if (const int err = check_args(B, H, HK, D, q_pos, k_pos, causal))
    return err;
  const WideArgs a{q, k, v, nullptr, nullptr, nullptr, nullptr,
                   static_cast<const int*>(q_seg),
                   static_cast<const int*>(k_seg),
                   static_cast<const int*>(q_pos),
                   static_cast<const int*>(k_pos),
                   Bias{bias, bias_dtype, sb, sh, sq, sk},
                   out, nullptr, nullptr, nullptr,
                   static_cast<float*>(lse), B, H, HK, SQ, SK, D, scale,
                   causal, window, Dropout{dropout, seed, thresh, keep}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(a, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(a, s);
  if (dtype == 2) return launch_fwd<__half>(a, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: the arguments of `apex_flash_bwd` (flash_bwd_api.cuh); dq
// null skips the dq kernel, dk (and dv) null the dk/dv kernel.
extern "C" int apex_flash_wide_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* q_seg, const void* k_seg,
    const void* q_pos, const void* k_pos, const void* glse, const void* bias,
    int bias_dtype, long long sb, long long sh, long long sq, long long sk,
    void* dq, void* dk, void* dv, int B, int H, int HK, int SQ, int SK, int D,
    int dtype, float scale, int causal, int window, int dropout,
    uint32_t seed, uint32_t thresh, float keep, void* stream) {
  if (B == 0 || H == 0 || SQ == 0 || SK == 0) return (int)cudaGetLastError();
  if ((dk == nullptr) != (dv == nullptr)) return (int)cudaErrorInvalidValue;
  if (const int err = check_args(B, H, HK, D, q_pos, k_pos, causal))
    return err;
  const WideArgs a{q, k, v, dout,
                   static_cast<const float*>(lse),
                   static_cast<const float*>(delta),
                   static_cast<const float*>(glse),
                   static_cast<const int*>(q_seg),
                   static_cast<const int*>(k_seg),
                   static_cast<const int*>(q_pos),
                   static_cast<const int*>(k_pos),
                   Bias{bias, bias_dtype, sb, sh, sq, sk},
                   nullptr, dq, dk, dv, nullptr, B, H, HK, SQ, SK, D, scale,
                   causal, window, Dropout{dropout, seed, thresh, keep}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(a, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(a, s);
  if (dtype == 2) return launch_bwd<__half>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* apex_flash_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
