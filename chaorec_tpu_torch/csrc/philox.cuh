// Counter-based dropout bits shared by csrc/fused_mha.cu and
// csrc/fused_mha_bwd.cu.
//
// The bit that keeps or drops attention weight (g, i, j) is a function of
// (seed, g, i, j) alone: Philox4x32-10 (Salmon et al., SC'11) with counter
// (j / 4, i, g, 0) and key (seed_lo, seed_hi); word j % 4 of the result is
// compared with keep * 2^32. Any kernel, whatever its thread layout, and
// the plain PyTorch version (ops/fused_attn.py:philox4x32) draw the same
// bit. One call serves four neighbouring keys, and no index is a single
// 32-bit linear one, so a training launch's ~4.4e9 weights never wrap.
//
// This replaces the TPU kernel's hardware PRNG, seeded once per
// (group, query block) in chaorec_tpu/ops/pallas_attn.py:_fwd_kernel.

#pragma once

#include <stdint.h>

namespace chaorec {

struct Philox4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return {c0, c1, c2, c3};
}

// The four keep bits of keys 4*j4 .. 4*j4+3 for query row i of group g,
// as a 4-bit set (bit c is key 4*j4 + c).
__device__ __forceinline__ unsigned keep_bits4(uint32_t j4, uint32_t i,
                                               uint32_t g, uint64_t seed,
                                               uint32_t thresh) {
  const Philox4 r = philox4x32_10(j4, i, g, 0u, static_cast<uint32_t>(seed),
                                  static_cast<uint32_t>(seed >> 32));
  return (r.x < thresh ? 1u : 0u) | (r.y < thresh ? 2u : 0u) |
         (r.z < thresh ? 4u : 0u) | (r.w < thresh ? 8u : 0u);
}

// The ten round keys of a seed, for a kernel that draws many words from
// one seed: philox4x32_10_keyed then spends no instruction on the key
// schedule, and gives the words of philox4x32_10 bit for bit.
struct PhiloxKeys {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ PhiloxKeys philox_keys(uint64_t seed) {
  PhiloxKeys keys;
  uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    keys.k0[r] = k0;
    keys.k1[r] = k1;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return keys;
}

__device__ __forceinline__ Philox4 philox4x32_10_keyed(uint32_t c0, uint32_t c1,
                                                       uint32_t c2, uint32_t c3,
                                                       const PhiloxKeys& keys) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ keys.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ keys.k1[r];
    c3 = lo0;
  }
  return {c0, c1, c2, c3};
}

}  // namespace chaorec
