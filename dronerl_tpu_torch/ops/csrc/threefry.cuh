// Threefry-2x32 with 20 rounds, bit-exact with jax.random's threefry2x32
// and with dronerl_tpu/ops/step_kernel.py::threefry2x32 (same rotations,
// same key-schedule injections). jax.random's partitionable layout hashes
// the flat output index i as the counter pair (0, i); split() keeps both
// output words, uniform() keeps (w0 ^ w1) >> 9 as a 23-bit mantissa.
#pragma once

#include <cstdint>

namespace dronerl {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ Key threefry2x32(Key key, uint32_t x0,
                                            uint32_t x1) {
  const uint32_t ks0 = key.k0;
  const uint32_t ks1 = key.k1;
  const uint32_t ks2 = key.k0 ^ key.k1 ^ 0x1BD11BDAu;
  x0 += ks0;
  x1 += ks1;
#define DR_TF_ROUND(r) \
  x0 += x1;            \
  x1 = rotl32(x1, r);  \
  x1 ^= x0;
#define DR_TF_R0 DR_TF_ROUND(13) DR_TF_ROUND(15) DR_TF_ROUND(26) DR_TF_ROUND(6)
#define DR_TF_R1 DR_TF_ROUND(17) DR_TF_ROUND(29) DR_TF_ROUND(16) DR_TF_ROUND(24)
  DR_TF_R0
  x0 += ks1;
  x1 += ks2 + 1u;
  DR_TF_R1
  x0 += ks2;
  x1 += ks0 + 2u;
  DR_TF_R0
  x0 += ks0;
  x1 += ks1 + 3u;
  DR_TF_R1
  x0 += ks1;
  x1 += ks2 + 4u;
  DR_TF_R0
  x0 += ks2;
  x1 += ks0 + 5u;
#undef DR_TF_R1
#undef DR_TF_R0
#undef DR_TF_ROUND
  return Key{x0, x1};
}

// Row i of jax.random.split(key, n).
__device__ __forceinline__ Key split_row(Key key, uint32_t i) {
  return threefry2x32(key, 0u, i);
}

// 23 random mantissa bits of element i of jax.random.uniform(key, shape):
// the float is bitcast(bits | 0x3f800000) - 1, strictly increasing in them.
__device__ __forceinline__ uint32_t uniform_bits(Key key, uint32_t i) {
  const Key w = threefry2x32(key, 0u, i);
  return (w.k0 ^ w.k1) >> 9;
}

__device__ __forceinline__ float bits_to_unit_float(uint32_t bits23) {
  return __uint_as_float(bits23 | 0x3F800000u) - 1.0f;
}

}  // namespace dronerl
