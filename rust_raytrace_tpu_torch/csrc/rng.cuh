// Threefry-2x32 in uint32, bitwise equal to jax.random's threefry2x32 and to
// the port's int64 torch emulation (utils/rng.py:threefry2x32): 20 rounds in
// five blocks of four, the key schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
// injected after each block with the block's count (Salmon et al., SC'11).
//
// The keys are host words (utils/rng.fold_in), passed to a kernel as
// scalars; only the counter lives on the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ void threefry_mix(uint32_t& x0, uint32_t& x1,
                                             int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// both output words of the counter (x0, x1) under the key (k0, k1)
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
    if (block % 2 == 0) {
      threefry_mix(x0, x1, 13);
      threefry_mix(x0, x1, 15);
      threefry_mix(x0, x1, 26);
      threefry_mix(x0, x1, 6);
    } else {
      threefry_mix(x0, x1, 17);
      threefry_mix(x0, x1, 29);
      threefry_mix(x0, x1, 16);
      threefry_mix(x0, x1, 24);
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
  }
  return make_uint2(x0, x1);
}

// A uniform in [0, 1) keyed by the stream position q (the JAX
// `_pos_uniform`, ops/camera.py:pos_uniform): word 0 of the counter (q, 0),
// its top 24 bits times 2^-24 (both steps exact in float32).
__device__ __forceinline__ float pos_uniform(uint32_t k0, uint32_t k1,
                                             uint32_t q) {
  const uint32_t bits = threefry2x32(k0, k1, q, 0u).x;
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

}  // namespace rt
