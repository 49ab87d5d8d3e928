// Threefry-2x32, bit-exact with jax.random's threefry2x32 at 20 rounds and
// with dronerl_tpu/ops/step_kernel.py::threefry2x32 at every round count
// it takes (same rotations, same key-schedule injections, a multiple of 4
// rounds in [4, 20]: each group of four rotations followed by its
// injection). jax.random's partitionable layout hashes the flat output
// index i as the counter pair (0, i); split() keeps both output words,
// uniform() keeps (w0 ^ w1) >> 9 as a 23-bit mantissa.
//
// The round count is a template parameter. Its defaults are compile-time
// constants of the build (-D, see ops/_build.py), given only where they
// are not 20: DR_RNG_ROUNDS for every hash of the env side (the per-env
// keys and splits, the spawn fields, the reset chain), DR_ACTOR_ROUNDS for
// the epsilon-greedy actor's uniform field (DR_RNG_ROUNDS unless given),
// the fast-RNG mode's reduced-round Threefry-2x32-R.
#pragma once

#include <cstdint>

#if !defined(DR_RNG_ROUNDS)
#define DR_RNG_ROUNDS 20
#endif
#if !defined(DR_ACTOR_ROUNDS)
#define DR_ACTOR_ROUNDS DR_RNG_ROUNDS
#endif

namespace dronerl {

constexpr int RNG_ROUNDS = DR_RNG_ROUNDS;
constexpr int ACTOR_ROUNDS = DR_ACTOR_ROUNDS;

__host__ __device__ constexpr bool valid_rounds(int r) { return r % 4 == 0 && r >= 4 && r <= 20; }
static_assert(valid_rounds(RNG_ROUNDS) && valid_rounds(ACTOR_ROUNDS),
              "threefry rounds: a multiple of 4 in [4, 20]");

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

struct Key {
  uint32_t k0, k1;
};

template <int ROUNDS = RNG_ROUNDS>
__device__ __forceinline__ Key threefry2x32(Key key, uint32_t x0, uint32_t x1) {
  static_assert(valid_rounds(ROUNDS), "threefry rounds: a multiple of 4 in [4, 20]");
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
  if constexpr (ROUNDS >= 8) {
    DR_TF_R1
    x0 += ks2;
    x1 += ks0 + 2u;
  }
  if constexpr (ROUNDS >= 12) {
    DR_TF_R0
    x0 += ks0;
    x1 += ks1 + 3u;
  }
  if constexpr (ROUNDS >= 16) {
    DR_TF_R1
    x0 += ks1;
    x1 += ks2 + 4u;
  }
  if constexpr (ROUNDS >= 20) {
    DR_TF_R0
    x0 += ks2;
    x1 += ks0 + 5u;
  }
#undef DR_TF_R1
#undef DR_TF_R0
#undef DR_TF_ROUND
  return Key{x0, x1};
}

// Row i of jax.random.split(key, n).
template <int ROUNDS = RNG_ROUNDS>
__device__ __forceinline__ Key split_row(Key key, uint32_t i) {
  return threefry2x32<ROUNDS>(key, 0u, i);
}

// 23 random mantissa bits of element i of jax.random.uniform(key, shape):
// the float is bitcast(bits | 0x3f800000) - 1, strictly increasing in them.
template <int ROUNDS = RNG_ROUNDS>
__device__ __forceinline__ uint32_t uniform_bits(Key key, uint32_t i) {
  const Key w = threefry2x32<ROUNDS>(key, 0u, i);
  return (w.k0 ^ w.k1) >> 9;
}

__device__ __forceinline__ float bits_to_unit_float(uint32_t bits23) {
  return __uint_as_float(bits23 | 0x3F800000u) - 1.0f;
}

}  // namespace dronerl
