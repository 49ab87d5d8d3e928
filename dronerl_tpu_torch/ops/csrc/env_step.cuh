// The env's constants and the small helpers every env kernel shares.
//
// The kernels (full_tick.cu: B1, B3; env_kernel.cu: B4, B5) run one warp
// per env on env_warp.cuh, which includes this header for the env's
// compile-time constants, the object and move codes, the reward weights,
// jnp's gather index (wrap_clamp) and the observation's element type and
// shape.
//
// Semantics are the JAX package's core.step / core.reset / core.observe,
// bit for bit, quirks included (see env_warp.cuh).
//
// The env is compile-time (-D, see ops/_build.py), as the TPU kernels are
// specialised on static EnvParams. Build without --use_fast_math: the
// charge channel's divide by 100 and the float compares must stay IEEE.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "threefry.cuh"

#if !defined(DR_GRID) || !defined(DR_NDRONES) || !defined(DR_RADIUS) ||   \
    !defined(DR_NPACKETS) || !defined(DR_NDROPZONES) ||                     \
    !defined(DR_NSTATIONS) || !defined(DR_NSKYSCRAPERS) ||                  \
    !defined(DR_CHARGE_UP) || !defined(DR_DISCHARGE)
#error "build through dronerl_tpu_torch/ops/_build.py (it passes the -D set)"
#endif

namespace dronerl {

constexpr int G = DR_GRID;
constexpr int C = G * G;
constexpr int N = DR_NDRONES;
constexpr int R = DR_RADIUS;
constexpr int W = 2 * R + 1;
constexpr int NUM_CH = 6;
// The observation: the drone's window of W x W cells, or with DR_GLOBAL
// (wrapper="global") the whole board of G x G cells, 6 channels a cell.
#if defined(DR_GLOBAL)
constexpr bool GLOBAL = true;
#else
constexpr bool GLOBAL = false;
#endif
constexpr int OBS = (GLOBAL ? C : W * W) * NUM_CH;
// The drones whose observations a tick writes (collect_drones, -D
// DR_COLLECT where it is not 1): the first COLLECT drones' views as row
// groups of OBS rows, drone-major (the global view once for each).
#if !defined(DR_COLLECT)
#define DR_COLLECT 1
#endif
constexpr int COLLECT = DR_COLLECT;
constexpr int NPACK = DR_NPACKETS;
constexpr int NDROP = DR_NDROPZONES;
constexpr int NSTAT = DR_NSTATIONS;
constexpr int NSKY = DR_NSKYSCRAPERS;
constexpr int CHARGE_UP = DR_CHARGE_UP;
constexpr int DISCHARGE = DR_DISCHARGE;
constexpr int NUM_ACTIONS = 5;

static_assert(NPACK >= N, "the step respawn needs num_packets >= n_drones");
static_assert(COLLECT >= 1 && COLLECT <= N, "collect_drones in [1, n_drones]");

enum Code : int { EMPTY = 0, SKYSCRAPER = 2, STATION = 3, DROPZONE = 4, PACKET = 5 };
enum Move : int { LEFT = 0, DOWN = 1, RIGHT = 2, UP = 3, STAY = 4 };

struct Rewards {
  float pickup;
  float delivery;
  float crash;
  float charge;
};

__device__ __forceinline__ int wrap_clamp(int i) {
  i = i < 0 ? i + G : i;
  return i < 0 ? 0 : (i > G - 1 ? G - 1 : i);
}

// ---------------------------------------------------------------------------
// Observation buffers (f32 or bf16)

template <typename T>
__device__ __forceinline__ float obs_load(const T* p);
template <>
__device__ __forceinline__ float obs_load<float>(const float* p) {
  return __ldg(p);  // callers never read what the same launch writes
}
template <>
__device__ __forceinline__ float obs_load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void obs_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void obs_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace dronerl
