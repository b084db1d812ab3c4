// Stochastic rounding to bf16 and the two bit streams that drive it,
// shared by the optimizer kernels (csrc/fused_adam.cu, fused_lamb.cu,
// fused_sgd.cu, adagrad_novograd.cu, lamb_segment.cu), the standalone
// cast (csrc/stochastic_round.cu) and csrc/dropout.cu.
//
// The reference writes a bf16 master with stochastic rounding in two
// ways, and the port matches each bit for bit:
//
// - apex_tpu/multi_tensor/engine.py `stochastic_round_cast` (:48-67),
//   the stream of the engine's xla/interpret paths (`fused_elementwise`
//   with `sr_outputs`, :412, :453): key = fold_in(PRNGKey(seed), salt)
//   (two uint32 words, computed on the host: the seed is the optimizer's
//   host-side step count), then jax.random.bits over each element's flat
//   index i: `sr_bits_threefry(k0, k1, i)`.
// - apex_tpu/multi_tensor/segmented.py `_small_segment_pass` (:235-261):
//   the murmur3 finalizer over the global flat index, the seed times
//   0x9E3779B9: `sr_bits_murmur(seed, i)`.
//
// The reference's compiled-TPU engine path draws the TPU's hardware
// generator instead (`pltpu.prng_seed` / `pltpu.stochastic_round`,
// engine.py:289-294); no other device can reproduce that stream, so the
// port holds its kernels to the xla/interpret stream.
//
// Both add 16 random bits below the bf16 mantissa boundary and truncate:
// E[result] is the fp32 value. A non-finite value takes a nearest cast
// (adding bits to an inf or nan pattern could change its class).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t sr_rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// jax.random's threefry2x32 (jax/_src/prng.py `_threefry2x32_lowering`)
// of the counter pair (hi, lo) under the key (k0, k1): its two output
// words in (hi, lo).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& hi, uint32_t& lo) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = hi + k0, x1 = lo + k1;
#define APEX_TF_ROUND(r) \
  x0 += x1;              \
  x1 = sr_rotl(x1, r) ^ x0;
  APEX_TF_ROUND(13) APEX_TF_ROUND(15) APEX_TF_ROUND(26) APEX_TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  APEX_TF_ROUND(17) APEX_TF_ROUND(29) APEX_TF_ROUND(16) APEX_TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  APEX_TF_ROUND(13) APEX_TF_ROUND(15) APEX_TF_ROUND(26) APEX_TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  APEX_TF_ROUND(17) APEX_TF_ROUND(29) APEX_TF_ROUND(16) APEX_TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  APEX_TF_ROUND(13) APEX_TF_ROUND(15) APEX_TF_ROUND(26) APEX_TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef APEX_TF_ROUND
  hi = x0;
  lo = x1;
}

// The xor of threefry2x32's two output words (`bits` at 32-bit width,
// JAX 0.9.0 with jax_threefry_partitionable).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t hi, uint32_t lo) {
  threefry2x32(k0, k1, hi, lo);
  return hi ^ lo;
}

// jax.random.bits(key, shape)[i] for the flat index i: the counters are
// i's high and low words.
__device__ __forceinline__ uint32_t sr_bits_threefry(uint32_t k0, uint32_t k1,
                                                     int64_t i) {
  return threefry_bits(k0, k1, (uint32_t)((uint64_t)i >> 32),
                       (uint32_t)(uint64_t)i);
}

// The segment kernel's counter hash (segmented.py:244-255), on uint32:
// the index wraps at 2^32 as the reference's uint32 iota does.
__device__ __forceinline__ uint32_t sr_bits_murmur(uint32_t seed, int64_t i) {
  uint32_t h = (uint32_t)(uint64_t)i ^ (seed * 0x9E3779B9u);
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// fp32 -> bf16 by adding the low 16 bits of `bits` and truncating; a
// non-finite x rounds to nearest.
__device__ __forceinline__ __nv_bfloat16 sr_to_bf16(float x, uint32_t bits) {
  if (!isfinite(x)) return __float2bfloat16_rn(x);
  const uint32_t t = (__float_as_uint(x) + (bits & 0xFFFFu)) & 0xFFFF0000u;
  return __ushort_as_bfloat16((unsigned short)(t >> 16));
}

// Four consecutive values of a parameter buffer of fp32 or bf16, read as
// fp32 (one 16-byte or 8-byte load: the element index i is a multiple of
// four and the buffer 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* p, int64_t i) {
  return *reinterpret_cast<const float4*>(p + i);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int64_t i) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p + i);
  float4 f;
  f.x = __uint_as_float(raw.x << 16);
  f.y = __uint_as_float(raw.x & 0xFFFF0000u);
  f.z = __uint_as_float(raw.y << 16);
  f.w = __uint_as_float(raw.y & 0xFFFF0000u);
  return f;
}
__device__ __forceinline__ float load1(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// The key of a bf16 output's stream: threefry words (k0, k1) and the
// offset of the buffer's element 0 in that stream (a large leaf's slice
// of a segmented layout starts its own stream at its first element).
struct SrKey {
  uint32_t k0, k1;
  int64_t base;
};

// The stream key of an int32 seed (read as uint32) and a salt:
// fold_in(PRNGKey(seed), salt), the device side of the port's
// `engine.sr_key_words`; base 0.
__device__ __forceinline__ SrKey sr_fold_in_key(uint32_t seed,
                                                uint32_t salt) {
  uint32_t hi = 0, lo = salt;
  threefry2x32(0u, seed, hi, lo);
  return SrKey{hi, lo, 0};
}

// Store four consecutive values at element i (a multiple of four): fp32
// as they are; bf16 stochastically rounded with the threefry bits of
// stream indices i - key.base .. i - key.base + 3.
__device__ __forceinline__ void store4(float* p, int64_t i, float4 v,
                                       const SrKey&) {
  *reinterpret_cast<float4*>(p + i) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, int64_t i, float4 v,
                                       const SrKey& k) {
  const int64_t j = i - k.base;
  const uint32_t a = __bfloat16_as_ushort(
      sr_to_bf16(v.x, sr_bits_threefry(k.k0, k.k1, j)));
  const uint32_t b = __bfloat16_as_ushort(
      sr_to_bf16(v.y, sr_bits_threefry(k.k0, k.k1, j + 1)));
  const uint32_t c = __bfloat16_as_ushort(
      sr_to_bf16(v.z, sr_bits_threefry(k.k0, k.k1, j + 2)));
  const uint32_t d = __bfloat16_as_ushort(
      sr_to_bf16(v.w, sr_bits_threefry(k.k0, k.k1, j + 3)));
  *reinterpret_cast<uint2*>(p + i) = make_uint2(a | (b << 16), c | (d << 16));
}
__device__ __forceinline__ void store1(float* p, int64_t i, float v,
                                       const SrKey&) {
  p[i] = v;
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, int64_t i, float v,
                                       const SrKey& k) {
  p[i] = sr_to_bf16(v, sr_bits_threefry(k.k0, k.k1, i - k.base));
}
