// The env step with the caller's actions, for every env, in one launch:
// one kernel in two layouts, each with its own entry point.
//
// * tick_launch replaces dronerl_tpu/ops/fused_tick.py::_tick_kernel
//   (launched by tick_fused, B4): feature-major state, ground (C, E) int8
//   and drone fields and actions (N, E), and the window observation of the
//   stepped state into a new (294, E) f32 array. Env e steps with row e of
//   split(step_key, E), the same row as the full tick's S[e]. No actor and
//   no reset: the fused engine resets outside the kernel, in plain PyTorch,
//   as the JAX trainer does in XLA.
// * step_launch replaces dronerl_tpu/ops/step_kernel.py::_step_kernel
//   (launched by step_batch_fused, B5): row-major EnvState, ground (E, C)
//   int8 and drone fields and actions (E, N), no observation. Bit-equal to
//   vmap(core.step) over split(step_key, E).
//
// Both: per-env threefry keys, move / crash / battery / pickup / delivery,
// packet, dropzone and drone respawns (the full tick's physics,
// env_step.cuh), one thread per env on its board and drones held in local
// arrays. The layout is a template parameter: it sets where thread e loads
// and stores cell c and drone i (c * E + e feature-major, e * C + c
// row-major) and whether it writes the observation. The TPU kernels'
// sentinel-ladder top-k and last-writer scatter emulation are the shared
// argmax-and-retire picker and the per-drone last-writer flags.
//
// Limits: the row-major step takes JAX's step_kernel limits, up to 512
// cells and 64 drones (a thread then keeps 2 x 512 bytes of board and 2 KB
// of spawn uniforms in local memory); the feature-major tick takes the
// tick kernels' 256 cells and 32 drones (ops/fused_tick.py kernel_problems).
//
// What bounds them on the H100:
// * the tick: the bytes, about 1.5 KB per env (the 294-row f32 observation
//   written, the state read and written, the actions read, rewards and
//   dones written), 97 MB at 65,536 envs; its operations (about 166
//   threefry hashes per env) come second. Every global load and store
//   coalesces across a warp and every byte moves once.
// * the step: the operations, the same 166 hashes per env against about
//   300 bytes of state at 81 cells and 4 drones. Row-major loads do not
//   coalesce across a warp (neighbouring threads read addresses C bytes
//   apart); each thread's row comes through L1 in a few sectors. Staging a
//   block's rows through shared memory is the next step.

#include "env_step.cuh"

namespace dronerl {

static_assert(C <= 512 && N <= 64, "the kernel takes <= 512 cells, <= 64 drones");

// Mirrors EnvArgs in ops/fused_tick.py field by field. obs_out is unused
// (null) in the row-major layout.
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
  int num_envs;
  uint32_t key0;
  uint32_t key1;
  float pickup_reward;
  float delivery_reward;
  float crash_reward;
  float charge_reward;
};

// Where env e's entry k of a K-entry field lies.
template <bool kFeatureMajor>
__device__ __forceinline__ long long at(int e, int k, int K, int E) {
  return kFeatureMajor ? (long long)k * E + e : (long long)e * K + k;
}

template <bool kFeatureMajor>
__global__ void __launch_bounds__(THREADS) env_kernel(const EnvArgs a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int E = a.num_envs;
  if (e >= E) return;
  const Key env_key = split_row(Key{a.key0, a.key1}, (uint32_t)e);

  int8_t g0[C];  // the board at the start of the step
  int8_t g[C];   // the board being stepped
  for (int c = 0; c < C; ++c) g0[c] = g[c] = a.ground_in[at<kFeatureMajor>(e, c, C, E)];
  int act[N], ax[N], ay[N];
  bool carrying[N];
  float charge[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const long long d = at<kFeatureMajor>(e, i, N, E);
    act[i] = a.actions[d];
    ax[i] = a.ax_in[d];
    ay[i] = a.ay_in[d];
    carrying[i] = a.carry_in[d] != 0;
    charge[i] = a.charge_in[d];
  }

  uint32_t u[C];
  float reward[N];
  bool done[N];
  const Rewards rw{a.pickup_reward, a.delivery_reward, a.crash_reward, a.charge_reward};
  step_env(env_key, act, g0, g, ax, ay, carrying, charge, reward, done, rw, u);

  for (int c = 0; c < C; ++c) a.ground_out[at<kFeatureMajor>(e, c, C, E)] = g[c];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const long long d = at<kFeatureMajor>(e, i, N, E);
    a.ax_out[d] = ax[i];
    a.ay_out[d] = ay[i];
    a.carry_out[d] = carrying[i] ? 1 : 0;
    a.charge_out[d] = charge[i];
    a.rewards[d] = reward[i];
    a.dones[d] = done[i] ? 1 : 0;
  }
  if constexpr (kFeatureMajor) write_obs(a.obs_out + e, (long long)E, g, ax, ay, carrying, charge);
}

template <bool kFeatureMajor>
int launch(const EnvArgs* args, void* stream) {
  if (args->num_envs <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((args->num_envs + THREADS - 1) / THREADS);
  env_kernel<kFeatureMajor><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

}  // namespace dronerl

extern "C" int tick_launch(const dronerl::EnvArgs* args, void* stream) {
  using namespace dronerl;
  if (C > 256 || N > 32 || args->obs_out == nullptr) return (int)cudaErrorInvalidValue;
  return launch<true>(args, stream);
}

extern "C" int step_launch(const dronerl::EnvArgs* args, void* stream) {
  return dronerl::launch<false>(args, stream);
}

extern "C" const char* env_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
