// Threefry-2x32-20 counter cipher as __device__ functions: the device twin
// of repro_torch/kernels/rng/rng.py, and the CUDA counterpart of the cipher
// that src/repro/kernels/rng/rng.py:71-132 traces into the Pallas kernel
// _mh_fused_kernel.  Everything is uint32 add/xor/rotate, so the draws are
// bit-identical to the host version by construction; chip_smoke.py holds
// them against the Random123 known-answer vectors and against the host
// version on 1M random counters.

#pragma once

#include <cstdint>

namespace repro {

constexpr uint32_t kParity = 0x1BD11BDAu;    // Threefish C240, 2x32 slice
constexpr uint32_t kUSalt = 0x554E4946u;     // "UNIF": the accept uniform
constexpr uint32_t kFlipSalt = 0x464C4950u;  // "FLIP": bit-plane i is +i

// Rounds 4i..4i+3 rotate by row i % 2; folded to constants by the unroll.
__host__ __device__ constexpr int rotation(int i, int j) {
  return (i % 2 == 0) ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                      : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// One block: counter (x0, x1) under key (k0, k1), in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rotation(i, j));
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// Fold absolute step t into the chain key.
__device__ __forceinline__ void step_key(uint32_t k0, uint32_t k1, uint32_t t,
                                         uint32_t& s0, uint32_t& s1) {
  s0 = t;
  s1 = 0u;
  threefry2x32(k0, k1, s0, s1);
}

// One uint32 of stream `salt` at `site` under a step key.
__device__ __forceinline__ uint32_t raw_draw(uint32_t s0, uint32_t s1,
                                             uint32_t site, uint32_t salt) {
  uint32_t x0 = site, x1 = salt;
  threefry2x32(s0, s1, x0, x1);
  return x0;
}

// u in [0, 1): the top 24 bits of the U-stream draw times 2^-24 (exact).
__device__ __forceinline__ float uniform_at(uint32_t s0, uint32_t s1,
                                            uint32_t site) {
  return static_cast<float>(raw_draw(s0, s1, site, kUSalt) >> 8) *
         (1.0f / 16777216.0f);
}

// Flip word: bit i is (draw of stream FLIP_SALT + i) < p_u32.  NB is nbits
// when it is known at compile time (the planes are then fully unrolled, so
// their independent blocks overlap), else 0 and the loop is unrolled by 4.
template <int NB = 0>
__device__ __forceinline__ uint32_t flips_at(uint32_t s0, uint32_t s1,
                                             uint32_t site, int nbits,
                                             uint32_t p_u32) {
  uint32_t word = 0u;
  if (NB > 0) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const uint32_t d = raw_draw(s0, s1, site, kFlipSalt + static_cast<uint32_t>(i));
      word |= static_cast<uint32_t>(d < p_u32) << i;
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < nbits; ++i) {
      const uint32_t d = raw_draw(s0, s1, site, kFlipSalt + static_cast<uint32_t>(i));
      word |= static_cast<uint32_t>(d < p_u32) << i;
    }
  }
  return word;
}

}  // namespace repro
