// The env step with the caller's actions, for every env, in one launch:
// one kernel in two layouts, each with its own entry point.
//
// * tick_launch replaces dronerl_tpu/ops/fused_tick.py::_tick_kernel
//   (launched by tick_fused, B4): feature-major state, ground (C, E) int8
//   and drone fields and actions (N, E), and the observation of the
//   stepped state (the window, or with DR_GLOBAL the whole board) into a
//   new (OBS, E) f32 array. Env e steps with row e of
//   split(step_key, E), the same row as the full tick's S[e]. With
//   DR_COLLECT = k the first k drones' observations go into a (k OBS, E)
//   array, drone-major; with DR_RNG_ROUNDS every hash runs that many
//   threefry rounds (threefry.cuh). No actor and
//   no reset: the fused engine resets outside the kernel, in plain PyTorch,
//   as the JAX trainer does in XLA.
// * step_launch replaces dronerl_tpu/ops/step_kernel.py::_step_kernel
//   (launched by step_batch_fused, B5): row-major EnvState, ground (E, C)
//   int8 and drone fields and actions (E, N). Bit-equal to vmap(core.step)
//   over split(step_key, E). Where obs_out is not null it also writes the
//   first COLLECT drones' observations of the stepped state, the jnp
//   engine's (E, COLLECT, OBS) f32 array, row-major: drone i of env e at
//   obs_out[(e COLLECT + i) OBS + f]: core.observe_batch(state', params,
//   COLLECT), bit for bit but the charge channel, which B4's pass computes
//   alike (within 1.3e-7). That observation exists within the tick
//   kernels' 256 cells and 32 drones (TICK); beyond them a launch with an
//   obs_out is refused.
//
// Both run the full tick kernel's design (full_tick.cu) without its actor
// and its reset:
//
// * A block owns EB consecutive envs and stages their board, drone fields
//   and actions into shared memory with cp.async (env_tile.cuh); one
//   thread an env hashes its ground and air keys while the copies are in
//   flight.
// * One warp steps one env at a time on env_warp.cuh: lanes own cells,
//   every spawn pick is a warp reduction, the drones live on lanes and
//   meet through shuffles, nothing is kept in local memory.
// * The state, rewards and dones go back from the tiles the same way.
//
// The layout is a template parameter. Feature-major (B4): each field's
// rows of the block's EB columns move as 16-byte chunks into (K, EB)
// tiles, and the observation is one block-wide pass (observe_tile) that
// writes the f32 observation straight to obs_out with
// row stride E: neighbouring threads write neighbouring envs, so the
// stores coalesce with no observation tile in shared memory. Row-major
// (B5): a block's part of an (E, K) field is one contiguous span of EB K
// elements at e0 K, moved flat; lane l of the warp of env el reads its
// cells at s_board[el * C + l + 32 k], stride 1 and free of bank
// conflicts; its observation is the same block-wide pass on env-major
// tiles, each env's features written contiguously at env stride COLLECT
// OBS (observe_tile's kEnvMajor).
//
// Limits: the row-major step takes JAX's step_kernel limits, up to 512
// cells and 64 drones; the feature-major tick takes the tick kernels' 256
// cells and 32 drones (ops/fused_tick.py kernel_problems). A block is 64
// envs and 512 threads, as the full tick kernel's: two blocks an SM (at
// most 64 registers a thread) up to 128 cells and 32 drones, one (at most
// 128) beyond, where env_warp.cuh's wide body (above 256 cells or 32
// drones: up to 16 cells and 2 drones a lane) or the narrow body's
// per-drone loops at 5 to 8 cells a lane need the registers. Other shapes
// measured within a few percent (scripts/torch_env_variants.py).
//
// What bounds them on the H100: the tick, the bytes (about 1.5 KB per env
// at grid 9 and 4 drones, the 294-row f32 observation written, the state
// read and written, the actions read, the rewards and dones written); the
// step, the operations (2 C threefry hashes per env, and each spawn pick a
// warp reduction over the board). Every byte moves once.

#include "env_tile.cuh"
#include "env_warp.cuh"

namespace dronerl {

static_assert(C <= 512 && N <= 64, "the kernel takes <= 512 cells, <= 64 drones");

// Mirrors EnvArgs in ops/fused_tick.py field by field. obs_out is
// (COLLECT OBS, E) in the feature-major layout and (E, COLLECT, OBS) or
// null (no observation) in the row-major one.
struct EnvArgs {
  const int8_t* ground_in;
  const int32_t* ax_in;
  const int32_t* ay_in;
  const int8_t* carry_in;
  const float* charge_in;
  const int32_t* actions;
  int8_t* ground_out;
  int32_t* ax_out;
  int32_t* ay_out;
  int8_t* carry_out;
  float* charge_out;
  float* rewards;
  int8_t* dones;
  float* obs_out;
  const uint32_t* key;  // the step key's two words, in device memory
  int num_envs;
  float pickup_reward;
  float delivery_reward;
  float crash_reward;
  float charge_reward;
};

// ---------------------------------------------------------------------------
// Block geometry and the shared-memory layout

// The wide body, and boards of more than 4 cells a lane (whose per-drone
// loops spill at 64 registers), run one block an SM: up to 128 registers.
constexpr bool LARGE = warp::WIDE || warp::KC > 4;
// The feature-major tick, and the row-major step's observation, exist
// within the tick kernels' limits only; conditions that depend on a
// template parameter keep them from being instantiated beyond them.
constexpr bool TICK = C <= 256 && N <= 32;
constexpr int EB = 64;                     // envs a block
constexpr int BLOCK = 512;                 // threads a block
constexpr int MIN_BLOCKS = LARGE ? 1 : 2;  // resident blocks an SM
constexpr int WARPS = BLOCK / 32;
using Tile = BlockTile<EB, BLOCK>;

// Byte offsets of the block's tiles: the board, the drones' fields (x, y,
// charge, action, reward; carry, done) and the keys (ground and air).
struct Layout {
  static constexpr int OFF_X = up16(C * EB);
  static constexpr int OFF_Y = OFF_X + N * EB * 4;
  static constexpr int OFF_CHARGE = OFF_Y + N * EB * 4;
  static constexpr int OFF_ACTION = OFF_CHARGE + N * EB * 4;
  static constexpr int OFF_REWARD = OFF_ACTION + N * EB * 4;
  static constexpr int OFF_KEYS = OFF_REWARD + N * EB * 4;
  static constexpr int OFF_CARRY = OFF_KEYS + 4 * EB * 4;
  static constexpr int OFF_DONE = OFF_CARRY + up16(N * EB);
  static constexpr int TOTAL = OFF_DONE + up16(N * EB);
};

// Where entry k of env el of a K-entry field lies in the block's tile.
template <bool kFeatureMajor>
__device__ __forceinline__ int at(int el, int k, int K) {
  return kFeatureMajor ? k * EB + el : el * K + k;
}

// Start copying the block's envs [e0, e0 + ne) of a K-entry field into
// its tile.
template <bool kFeatureMajor, typename U>
__device__ __forceinline__ void stage(U* tile, const U* src, int K, int E, int e0, int ne) {
  if constexpr (kFeatureMajor) {
    Tile::template stage_rows<U, EB>(tile, src, E, e0, K, ne);
  } else {
    Tile::template stage_flat<U>(tile, src + (long long)e0 * K, ne * K);
  }
}

// Store the block's envs of a K-entry field from its tile.
template <bool kFeatureMajor, typename U>
__device__ __forceinline__ void store(U* dst, const U* tile, int K, int E, int e0, int ne) {
  if constexpr (kFeatureMajor) {
    Tile::template store_rows<U, EB>(dst, tile, E, e0, K, ne);
  } else {
    Tile::template store_flat<U>(dst + (long long)e0 * K, tile, ne * K);
  }
}

// ---------------------------------------------------------------------------
// The kernel

template <bool kFeatureMajor>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) env_kernel(const EnvArgs a) {
  constexpr bool FM = kFeatureMajor;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_board = reinterpret_cast<int8_t*>(smem);
  int32_t* s_x = reinterpret_cast<int32_t*>(smem + Layout::OFF_X);
  int32_t* s_y = reinterpret_cast<int32_t*>(smem + Layout::OFF_Y);
  float* s_charge = reinterpret_cast<float*>(smem + Layout::OFF_CHARGE);
  int32_t* s_act = reinterpret_cast<int32_t*>(smem + Layout::OFF_ACTION);
  float* s_reward = reinterpret_cast<float*>(smem + Layout::OFF_REWARD);
  uint32_t* s_keys = reinterpret_cast<uint32_t*>(smem + Layout::OFF_KEYS);
  int8_t* s_carry = reinterpret_cast<int8_t*>(smem + Layout::OFF_CARRY);
  int8_t* s_done = reinterpret_cast<int8_t*>(smem + Layout::OFF_DONE);

  const int E = a.num_envs;
  const int e0 = blockIdx.x * EB;
  const int ne = min(EB, E - e0);

  // --- stage the state and the actions (in flight while the keys hash) -----
  stage<FM>(s_board, a.ground_in, C, E, e0, ne);
  stage<FM>(s_x, a.ax_in, N, E, e0, ne);
  stage<FM>(s_y, a.ay_in, N, E, e0, ne);
  stage<FM>(s_carry, a.carry_in, N, E, e0, ne);
  stage<FM>(s_charge, a.charge_in, N, E, e0, ne);
  stage<FM>(s_act, a.actions, N, E, e0, ne);

  // --- keys: row e of split(step_key, E), one thread an env ----------------
  // The key is read by pointer, so that a CUDA graph's launch reads each
  // replay's key (a block passed by value would freeze the capture's).
  if ((int)threadIdx.x < ne) {
    const int el = threadIdx.x;
    const Key step_key{__ldg(a.key), __ldg(a.key + 1)};
    const Key env_key = split_row(step_key, (uint32_t)(e0 + el));
    // core.step: key, respawn_key = split(key); then split(key) again.
    const Key nk = split_row(env_key, 0u);
    const Key ground_key = split_row(env_key, 1u);
    const Key air_key = split_row(nk, 1u);
    s_keys[0 * EB + el] = ground_key.k0;
    s_keys[1 * EB + el] = ground_key.k1;
    s_keys[2 * EB + el] = air_key.k0;
    s_keys[3 * EB + el] = air_key.k1;
  }
  cp_async_wait_all();
  __syncthreads();

  // --- the step: one warp an env -------------------------------------------
  const int warp_id = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Rewards rw{a.pickup_reward, a.delivery_reward, a.crash_reward, a.charge_reward};
#pragma unroll 1
  for (int el = warp_id; el < ne; el += WARPS) {
    int g[warp::KC];
    uint32_t sky = 0u;  // the lane's cells that hold a skyscraper
#pragma unroll
    for (int k = 0; k < warp::KC; ++k) {
      const int c = warp::cell_of(k);
      g[k] = c < C ? s_board[at<FM>(el, c, C)] : EMPTY;
      sky |= (g[k] == SKYSCRAPER ? 1u : 0u) << k;
    }
    warp::Drone d[warp::DPL];
    int act[warp::DPL];
#pragma unroll
    for (int s = 0; s < warp::DPL; ++s) {
      const int i = lane + 32 * s;
      d[s] = warp::Drone{0, 0, false, 100.0f};
      act[s] = STAY;
      if (i < N) {
        const int j = at<FM>(el, i, N);
        d[s] = warp::Drone{s_x[j], s_y[j], s_carry[j] != 0, s_charge[j]};
        act[s] = s_act[j];
      }
    }
    const Key ground_key{s_keys[0 * EB + el], s_keys[1 * EB + el]};
    const Key air_key{s_keys[2 * EB + el], s_keys[3 * EB + el]};
    uint32_t u[warp::KC], ua[warp::KC];
    float reward[warp::DPL];
    bool done[warp::DPL];
    warp::step_env(
        ground_key, air_key, act, s_board + at<FM>(el, 0, C), FM ? EB : 1,
        [sky](int k) { return (sky >> k & 1u) != 0u; }, g, d, reward, done, rw, u, ua);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < warp::KC; ++k) {
      const int c = warp::cell_of(k);
      if (c < C) s_board[at<FM>(el, c, C)] = (int8_t)g[k];
    }
#pragma unroll
    for (int s = 0; s < warp::DPL; ++s) {
      const int i = lane + 32 * s;
      if (i < N) {
        const int j = at<FM>(el, i, N);
        s_x[j] = d[s].x;
        s_y[j] = d[s].y;
        s_carry[j] = d[s].carrying ? 1 : 0;
        s_charge[j] = d[s].charge;
        s_reward[j] = reward[s];
        s_done[j] = done[s] ? 1 : 0;
      }
    }
  }
  __syncthreads();

  // --- the observation, the state, rewards and dones ----------------------
  if constexpr (FM) {
    // Drone i's observation into rows [i OBS, (i + 1) OBS).
#pragma unroll 1
    for (int i = 0; i < COLLECT; ++i) {
      warp::observe_tile<EB, BLOCK>(i, a.obs_out + (long long)i * OBS * E + e0, (long long)E,
                                    s_board, s_x, s_y, s_carry, s_charge, ne);
    }
  } else if constexpr (FM || TICK) {
    // Drone i of env e at ((e COLLECT + i) OBS, +OBS).
    if (a.obs_out != nullptr) {
#pragma unroll 1
      for (int i = 0; i < COLLECT; ++i) {
        warp::observe_tile<EB, BLOCK, true>(
            i, a.obs_out + ((long long)e0 * COLLECT + i) * OBS, (long long)COLLECT * OBS, s_board,
            s_x, s_y, s_carry, s_charge, ne);
      }
    }
  }
  store<FM>(a.ground_out, s_board, C, E, e0, ne);
  store<FM>(a.ax_out, s_x, N, E, e0, ne);
  store<FM>(a.ay_out, s_y, N, E, e0, ne);
  store<FM>(a.carry_out, s_carry, N, E, e0, ne);
  store<FM>(a.charge_out, s_charge, N, E, e0, ne);
  store<FM>(a.rewards, s_reward, N, E, e0, ne);
  store<FM>(a.dones, s_done, N, E, e0, ne);
}

// Internal linkage: a static local of a template with external linkage is
// one process-wide (GNU unique) object, shared by every library built from
// this source, so a second env's library would never set its limit.
namespace {

template <bool kFeatureMajor>
cudaError_t configure() {
  static const cudaError_t err = cudaFuncSetAttribute(
      env_kernel<kFeatureMajor>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout::TOTAL);
  return err;
}

}  // namespace

template <bool kFeatureMajor>
int launch(const EnvArgs* args, void* stream) {
  if (args->num_envs <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = configure<kFeatureMajor>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((args->num_envs + EB - 1) / EB);
  env_kernel<kFeatureMajor>
      <<<grid, BLOCK, Layout::TOTAL, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

template <bool kFeatureMajor>
int blocks_per_sm() {
  int n = 0;
  if (configure<kFeatureMajor>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, env_kernel<kFeatureMajor>, BLOCK,
                                                    Layout::TOTAL) != cudaSuccess) {
    return -1;
  }
  return n;
}

template <bool kTick = TICK>
int tick(const EnvArgs* args, void* stream) {
  if constexpr (kTick) {
    if (args->obs_out == nullptr) return (int)cudaErrorInvalidValue;
    return launch<true>(args, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

template <bool kTick = TICK>
int tick_blocks_per_sm() {
  if constexpr (kTick) {
    return blocks_per_sm<true>();
  } else {
    return -1;
  }
}

}  // namespace dronerl

extern "C" int tick_launch(const dronerl::EnvArgs* args, void* stream) {
  return dronerl::tick(args, stream);
}

extern "C" int step_launch(const dronerl::EnvArgs* args, void* stream) {
  if (!dronerl::TICK && args->obs_out != nullptr) return (int)cudaErrorInvalidValue;
  return dronerl::launch<false>(args, stream);
}

extern "C" const char* env_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The block's shape: out[0] envs, out[1] threads, out[2] dynamic shared
// memory in bytes, and the resident blocks an SM of the feature-major tick
// out[3] (-1 where this env has none) and of the row-major step out[4].
extern "C" void env_block_shape(int* out) {
  using namespace dronerl;
  out[0] = EB;
  out[1] = BLOCK;
  out[2] = Layout::TOTAL;
  out[3] = tick_blocks_per_sm();
  out[4] = blocks_per_sm<false>();
}
