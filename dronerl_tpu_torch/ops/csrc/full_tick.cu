// One training tick's env side for every env, in one launch.
//
// Replaces dronerl_tpu/ops/fused_tick.py::_full_kernel (without its
// in-kernel TD branch, which is td_adam.cu) in both of its launches:
//
// * full_tick_ring_launch: as full_tick_fused_ring launches it (B1). The
//   observation is read from the replay ring at read_col and the next one
//   written into the same ring at write_col, in place (other ring columns
//   keep their contents).
// * full_tick_launch: as full_tick_fused launches it (B3). The observation
//   is read from obs_t (294, E) f32 and the next one written into a new
//   array of the same shape.
//
// Both run one kernel: per-env threefry keys, the epsilon-greedy dense-Q
// actor reading obs_in's column, move / crash / battery / pickup /
// delivery, packet, dropzone and drone respawns, the optional full reset,
// and the window observation stored into obs_out's column (env_step.cuh).
//
// Design: one thread per env. State is feature-major (field, env), so
// thread e reads ground[c * E + e] and writes obs_out[row * ld + col + e]:
// neighbouring threads touch neighbouring addresses and every global load
// and store coalesces. Each thread keeps its env's board (C bytes) and one
// field of C spawn uniforms in local memory.
//
// What bounds it on the H100: for the (16,16) net the bytes (the 294-row
// observation read and the next one written, about 1.2 KB per env and tick
// in bf16, 2.4 KB in f32, plus the state); for the (128,64) net the f32 Q
// forward, about 92k FLOP per env on the CUDA cores, plus about 170
// threefry hashes per env. The design keeps every byte to one read and one
// write and spends no shared memory; the actor's weights are read through
// the read-only cache as warp-uniform broadcasts, and f32 observations
// through it too (obs_in is never written by the launch that reads it: the
// ring launch's read and write columns are disjoint or equal, and a thread
// writes its column after its actor has read it). Weights in shared memory
// and a wgmma actor are the next steps.
//
// The net widths are compile-time constants too (-D, see ops/_build.py).

#include "env_step.cuh"

#if !defined(DR_NLAYERS)
#error "build through dronerl_tpu_torch/ops/_build.py (it passes the net -D set)"
#endif

namespace dronerl {

constexpr int MAX_LAYERS = 8;
// Layer widths: obs_dim, hidden..., num_actions (unused entries are 0).
constexpr int DIMS[MAX_LAYERS + 1] = {DR_DIM0, DR_DIM1, DR_DIM2, DR_DIM3, DR_DIM4,
                                      DR_DIM5, DR_DIM6, DR_DIM7, DR_DIM8};
constexpr int NL = DR_NLAYERS;

static_assert(C <= 256 && N <= 32, "the kernel takes <= 256 cells, <= 32 drones");
static_assert(NL >= 1 && NL <= MAX_LAYERS, "1..8 dense layers");
static_assert(DIMS[0] == OBS, "the first width is the window observation");
static_assert(DIMS[NL] == NUM_ACTIONS, "the last width is the action count");

// Mirrors _TickArgs in ops/fused_tick.py field by field.
struct TickArgs {
  const void* obs_in;
  void* obs_out;
  const int8_t* ground_in;
  const int32_t* ax_in;
  const int32_t* ay_in;
  const int8_t* carry_in;
  const float* charge_in;
  const float* eps;
  int8_t* ground_out;
  int32_t* ax_out;
  int32_t* ay_out;
  int8_t* carry_out;
  float* charge_out;
  float* rewards;
  int8_t* dones;
  int32_t* actions;
  const float* w[MAX_LAYERS];
  const float* b[MAX_LAYERS];
  long long in_ld;
  long long read_col;
  long long out_ld;
  long long write_col;
  int num_envs;
  int obs_bf16;
  uint32_t key0;
  uint32_t key1;
  int do_reset;
  float pickup_reward;
  float delivery_reward;
  float crash_reward;
  float charge_reward;
};

// ---------------------------------------------------------------------------
// Actor: the dense Q forward of one env's observation, in f32.

// acc[j] += w[j] * x for one weight row (OUT contiguous floats), four
// weights a load where the row is 16-byte aligned (OUT % 4 == 0). The
// address is the same in every thread of a warp: one broadcast load.
template <int OUT>
__device__ __forceinline__ void fma_row(const float* __restrict__ w, float x, float* acc) {
  if constexpr (OUT % 4 == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
    for (int j = 0; j < OUT / 4; ++j) {
      const float4 v = __ldg(w4 + j);
      acc[4 * j + 0] = fmaf(v.x, x, acc[4 * j + 0]);
      acc[4 * j + 1] = fmaf(v.y, x, acc[4 * j + 1]);
      acc[4 * j + 2] = fmaf(v.z, x, acc[4 * j + 2]);
      acc[4 * j + 3] = fmaf(v.w, x, acc[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < OUT; ++j) acc[j] = fmaf(__ldg(w + j), x, acc[j]);
  }
}

template <int IN, int OUT, bool RELU>
__device__ __forceinline__ void dense_layer(const float* x, float* y, const float* __restrict__ w,
                                            const float* __restrict__ b) {
  float acc[OUT];
#pragma unroll
  for (int j = 0; j < OUT; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < IN; ++i) fma_row<OUT>(w + i * OUT, x[i], acc);
#pragma unroll
  for (int j = 0; j < OUT; ++j) {
    const float v = acc[j] + __ldg(b + j);
    y[j] = RELU ? fmaxf(v, 0.0f) : v;
  }
}

template <int L>
__device__ __forceinline__ void hidden_layers(const float* x, float* q, const TickArgs& a) {
  if constexpr (L == NL - 1) {
    dense_layer<DIMS[L], DIMS[L + 1], false>(x, q, a.w[L], a.b[L]);
  } else {
    float h[DIMS[L + 1]];
    dense_layer<DIMS[L], DIMS[L + 1], true>(x, h, a.w[L], a.b[L]);
    hidden_layers<L + 1>(h, q, a);
  }
}

// The first layer streams the observation straight from its column.
template <typename T>
__device__ int greedy_action(const T* col, long long ld, const TickArgs& a) {
  constexpr int H = DIMS[1];
  float acc[H];
#pragma unroll
  for (int j = 0; j < H; ++j) acc[j] = 0.0f;
#pragma unroll 2
  for (int i = 0; i < OBS; ++i) fma_row<H>(a.w[0] + i * H, obs_load(col + (long long)i * ld), acc);
  float q[NUM_ACTIONS];
  if constexpr (NL == 1) {
#pragma unroll
    for (int j = 0; j < NUM_ACTIONS; ++j) q[j] = acc[j] + __ldg(a.b[0] + j);
  } else {
#pragma unroll
    for (int j = 0; j < H; ++j) acc[j] = fmaxf(acc[j] + __ldg(a.b[0] + j), 0.0f);
    hidden_layers<1>(acc, q, a);
  }
  int best = 0;
#pragma unroll
  for (int j = 1; j < NUM_ACTIONS; ++j) {
    if (q[j] > q[best]) best = j;
  }
  return best;
}

// ---------------------------------------------------------------------------
// The tick

template <typename T>
__global__ void __launch_bounds__(THREADS) full_tick_kernel(const TickArgs a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int E = a.num_envs;
  if (e >= E) return;

  // --- keys: rows of split(step_key, E + 2) -----------------------------
  const Key step_key{a.key0, a.key1};
  const Key env_key = split_row(step_key, (uint32_t)e);
  const Key actor_key = split_row(step_key, (uint32_t)E);

  // --- epsilon-greedy actor ---------------------------------------------
  int act[N];
  float u0;
  {
    float u_act[N + 1];
#pragma unroll
    for (int r = 0; r <= N; ++r) {
      u_act[r] = bits_to_unit_float(uniform_bits(actor_key, (uint32_t)(r * E + e)));
    }
    u0 = u_act[0];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int v = (int)floorf(u_act[i + 1] * (float)NUM_ACTIONS);
      act[i] = v < 0 ? 0 : (v > NUM_ACTIONS - 1 ? NUM_ACTIONS - 1 : v);
    }
  }
  if (!(u0 < __ldg(a.eps))) {
    act[0] = greedy_action(static_cast<const T*>(a.obs_in) + a.read_col + e, a.in_ld, a);
  }

  // --- load the env ------------------------------------------------------
  int8_t g0[C];  // the board at the start of the tick
  int8_t g[C];   // the board being stepped
  for (int c = 0; c < C; ++c) g0[c] = g[c] = a.ground_in[(long long)c * E + e];
  int ax[N], ay[N];
  bool carrying[N];
  float charge[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ax[i] = a.ax_in[i * E + e];
    ay[i] = a.ay_in[i * E + e];
    carrying[i] = a.carry_in[i * E + e] != 0;
    charge[i] = a.charge_in[i * E + e];
  }

  // --- the step ------------------------------------------------------------
  uint32_t u[C];
  float reward[N];
  bool done[N];
  const Rewards rw{a.pickup_reward, a.delivery_reward, a.crash_reward, a.charge_reward};
  step_env(env_key, act, g0, g, ax, ay, carrying, charge, reward, done, rw, u);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a.rewards[i * E + e] = reward[i];
    a.dones[i * E + e] = done[i] ? 1 : 0;
    a.actions[i * E + e] = act[i];
  }

  // --- core.reset with row e of split(S[E + 1], E) -------------------------
  if (a.do_reset) {
    reset_env(split_row(split_row(step_key, (uint32_t)(E + 1)), (uint32_t)e), g, ax, ay,
              carrying, charge, u);
  }

  // --- store the state and the next observation ---------------------------
  for (int c = 0; c < C; ++c) a.ground_out[(long long)c * E + e] = g[c];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a.ax_out[i * E + e] = ax[i];
    a.ay_out[i * E + e] = ay[i];
    a.carry_out[i * E + e] = carrying[i] ? 1 : 0;
    a.charge_out[i * E + e] = charge[i];
  }
  write_obs(static_cast<T*>(a.obs_out) + a.write_col + e, a.out_ld, g, ax, ay, carrying, charge);
}

int launch(const TickArgs* args, void* stream) {
  if (args->num_envs <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((args->num_envs + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->obs_bf16) {
    full_tick_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(*args);
  } else {
    full_tick_kernel<float><<<grid, THREADS, 0, s>>>(*args);
  }
  return (int)cudaGetLastError();
}

}  // namespace dronerl

// B1: the replay ring is both obs_in and obs_out.
extern "C" int full_tick_ring_launch(const dronerl::TickArgs* args, void* stream) {
  return dronerl::launch(args, stream);
}

// B3: obs_t in, a new obs_t' out (f32, distinct buffers).
extern "C" int full_tick_launch(const dronerl::TickArgs* args, void* stream) {
  if (args->obs_bf16 || args->obs_in == args->obs_out) return (int)cudaErrorInvalidValue;
  return dronerl::launch(args, stream);
}

extern "C" const char* full_tick_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
