// One training tick's env side for every env, in one launch.
//
// Replaces dronerl_tpu/ops/fused_tick.py::_full_kernel as launched by
// full_tick_fused_ring (the ring launch, without the in-kernel TD branch):
// per-env threefry keys, the epsilon-greedy dense-Q actor reading the
// replay ring at read_col, move / crash / battery / pickup / delivery,
// packet, dropzone and drone respawns, the egocentric window observation,
// the optional full reset, and the store of the next observation into the
// ring at write_col, in place (other ring columns keep their contents).
//
// Design: one thread per env. State is feature-major (field, env), so
// thread e reads ground[c * E + e] and writes ring[row * ld + col + e]:
// neighbouring threads touch neighbouring addresses and every global load
// and store coalesces. Each thread keeps its env's board (C bytes) and one
// field of C spawn uniforms in local memory and runs the TPU kernel's
// semantics directly: a spawn is k argmax-and-retire rounds over the
// vacant cells, ties to the lowest index (lax.top_k's stable order),
// compared on the 23 mantissa bits the uniform float is made from.
//
// What bounds it on the H100: for the (16,16) net the bytes (the 294-row
// observation read from the ring and written back, about 1.5 KB per env
// and tick with f32 state); for the (128,64) net the f32 Q forward, about
// 92k FLOP per env on the CUDA cores, plus about 170 threefry hashes per
// env. The design keeps every byte to one read and one write and spends
// no shared memory; the actor's weights are read through the read-only
// cache as warp-uniform broadcasts. Weights in shared memory and a wgmma
// actor are the next steps.
//
// The env, the window and the net widths are compile-time constants (-D,
// see ops/_build.py), as the TPU kernel is specialised on static EnvParams.
// Build without --use_fast_math: the charge channel's divide by 100 and the
// float compares must stay IEEE.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "threefry.cuh"

#if !defined(DR_GRID) || !defined(DR_NDRONES) || !defined(DR_RADIUS) ||   \
    !defined(DR_NPACKETS) || !defined(DR_NDROPZONES) ||                     \
    !defined(DR_NSTATIONS) || !defined(DR_NSKYSCRAPERS) ||                  \
    !defined(DR_CHARGE_UP) || !defined(DR_DISCHARGE) || !defined(DR_NLAYERS)
#error "build through dronerl_tpu_torch/ops/_build.py (it passes the -D set)"
#endif

namespace dronerl {

constexpr int G = DR_GRID;
constexpr int C = G * G;
constexpr int N = DR_NDRONES;
constexpr int R = DR_RADIUS;
constexpr int W = 2 * R + 1;
constexpr int NUM_CH = 6;
constexpr int OBS = W * W * NUM_CH;
constexpr int NPACK = DR_NPACKETS;
constexpr int NDROP = DR_NDROPZONES;
constexpr int NSTAT = DR_NSTATIONS;
constexpr int NSKY = DR_NSKYSCRAPERS;
constexpr int CHARGE_UP = DR_CHARGE_UP;
constexpr int DISCHARGE = DR_DISCHARGE;
constexpr int NUM_ACTIONS = 5;
constexpr int MAX_LAYERS = 8;
// Layer widths: obs_dim, hidden..., num_actions (unused entries are 0).
constexpr int DIMS[MAX_LAYERS + 1] = {DR_DIM0, DR_DIM1, DR_DIM2, DR_DIM3, DR_DIM4,
                                      DR_DIM5, DR_DIM6, DR_DIM7, DR_DIM8};
constexpr int NL = DR_NLAYERS;
constexpr int cmax(int x, int y) { return x > y ? x : y; }
constexpr int MAX_FILL = cmax(cmax(NPACK, NDROP), cmax(NSTAT, NSKY));
constexpr int THREADS = 128;

static_assert(C <= 256 && N <= 32, "the kernel takes <= 256 cells, <= 32 drones");
static_assert(NPACK >= N, "the step respawn needs num_packets >= n_drones");
static_assert(NL >= 1 && NL <= MAX_LAYERS, "1..8 dense layers");
static_assert(DIMS[0] == OBS, "the first width is the window observation");
static_assert(DIMS[NL] == NUM_ACTIONS, "the last width is the action count");

enum Code : int { EMPTY = 0, SKYSCRAPER = 2, STATION = 3, DROPZONE = 4, PACKET = 5 };
enum Move : int { LEFT = 0, DOWN = 1, RIGHT = 2, UP = 3, STAY = 4 };

// Mirrors _TickArgs in ops/fused_tick.py field by field.
struct TickArgs {
  void* ring;
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
  long long ring_ld;
  long long read_col;
  long long write_col;
  int num_envs;
  int ring_bf16;
  uint32_t key0;
  uint32_t key1;
  int do_reset;
  float pickup_reward;
  float delivery_reward;
  float crash_reward;
  float charge_reward;
};

__device__ __forceinline__ int wrap_clamp(int i) {
  i = i < 0 ? i + G : i;
  return i < 0 ? 0 : (i > G - 1 ? G - 1 : i);
}

// ---------------------------------------------------------------------------
// Ring access

template <typename T>
__device__ __forceinline__ float ring_load(const T* p);
template <>
__device__ __forceinline__ float ring_load<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float ring_load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void ring_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void ring_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// Spawns

// The C uniforms of one field, as 23-bit mantissas.
__device__ __forceinline__ void uniform_field(Key key, uint32_t* u) {
#pragma unroll 4
  for (int c = 0; c < C; ++c) u[c] = uniform_bits(key, (uint32_t)c);
}

// Iterated argmax-and-retire over the spawn order of top_k(where(valid, u,
// -inf), k): valid cells by u descending, ties to the lowest index, then
// the invalid cells in index order.
struct Picker {
  uint32_t valid[(C + 31) / 32];
  uint32_t taken[(C + 31) / 32];

  __device__ __forceinline__ bool is_valid(int c) const {
    return (valid[c >> 5] >> (c & 31)) & 1u;
  }
  __device__ __forceinline__ bool is_taken(int c) const {
    return (taken[c >> 5] >> (c & 31)) & 1u;
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < (C + 31) / 32; ++i) valid[i] = taken[i] = 0u;
  }
  __device__ __forceinline__ void set_valid(int c) { valid[c >> 5] |= 1u << (c & 31); }

  __device__ int next(const uint32_t* u) {
    int best = -1;
    uint32_t best_u = 0;
    for (int c = 0; c < C; ++c) {
      if (is_valid(c) && !is_taken(c) && (best < 0 || u[c] > best_u)) {
        best = c;
        best_u = u[c];
      }
    }
    if (best < 0) {
      for (int c = 0; c < C; ++c) {
        if (!is_taken(c)) {
          best = c;
          break;
        }
      }
    }
    taken[best >> 5] |= 1u << (best & 31);
    return best;
  }
};

// place_on_ground with k = K slots whose first ROUNDS fills are fills[s]
// and the rest 0: ROUNDS picks, then the only effect of the zero slots,
// erasing the occupied cells ranked in [ROUNDS, K) of the spawn order.
template <int ROUNDS, int K>
__device__ void ground_spawn(int8_t* g, const uint32_t* u, const int8_t* fills) {
  Picker pick;
  pick.clear();
  int n_vacant = 0;
  for (int c = 0; c < C; ++c) {
    if (g[c] == EMPTY) {
      pick.set_valid(c);
      ++n_vacant;
    }
  }
  if (K > ROUNDS) {
    int rank = n_vacant;
    for (int c = 0; c < C; ++c) {
      if (!pick.is_valid(c)) {
        if (rank >= ROUNDS && rank < K) g[c] = EMPTY;
        ++rank;
      }
    }
  }
  // The erased cells were ranked after every pick, so the order of the two
  // steps does not matter; picks read the vacancy fixed above.
  for (int s = 0; s < ROUNDS; ++s) g[pick.next(u)] = fills[s];
}

// place_in_air: drones at the -1 sentinel take candidate s = their slot.
// Occupancy is marked transposed (cell x * G + y, -1 wrapping to G - 1)
// and skyscrapers of `board` are excluded: the reference env's quirks.
__device__ void air_spawn(const uint32_t* u, const int8_t* board, int* ax, int* ay) {
  Picker pick;
  pick.clear();
  uint32_t occupied[(C + 31) / 32];
#pragma unroll
  for (int i = 0; i < (C + 31) / 32; ++i) occupied[i] = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int cell = wrap_clamp(ax[i]) * G + wrap_clamp(ay[i]);
    occupied[cell >> 5] |= 1u << (cell & 31);
  }
  for (int c = 0; c < C; ++c) {
    if (!((occupied[c >> 5] >> (c & 31)) & 1u) && board[c] != SKYSCRAPER) pick.set_valid(c);
  }
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
    const int cand = pick.next(u);
    if (ax[i] == -1) ax[i] = cand / G;
    if (ay[i] == -1) ay[i] = cand % G;
  }
}

// ---------------------------------------------------------------------------
// Observation

template <typename T>
__device__ void write_obs(T* col, long long ld, const int8_t* g, const int* ax,
                          const int* ay, const bool* carrying, const float* charge) {
  const int cy = ay[0];
  const int cx = ax[0];
#pragma unroll 1
  for (int p = 0; p < W * W; ++p) {
    const int wy = cy + p / W - R;
    const int wx = cx + p % W - R;
    const bool inside = wy >= 0 && wy < G && wx >= 0 && wx < G;
    int code = SKYSCRAPER;
    float chg = 0.0f;  // charge + 1 where a drone is, else 0
    if (inside) {
      code = g[wy * G + wx];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (ay[i] == wy && ax[i] == wx) chg = charge[i] + 1.0f;
      }
    }
    bool is_packet = code == PACKET;
    if (p == (W * W) / 2) is_packet = is_packet || carrying[0];
    const float frac = fminf(fmaxf(chg - 1.0f, 0.0f), 100.0f) / 100.0f;
    T* out = col + (long long)p * NUM_CH * ld;
    ring_store(out + 0 * ld, chg > 0.0f ? 1.0f : 0.0f);
    ring_store(out + 1 * ld, is_packet ? 1.0f : 0.0f);
    ring_store(out + 2 * ld, code == DROPZONE ? 1.0f : 0.0f);
    ring_store(out + 3 * ld, code == STATION ? 1.0f : 0.0f);
    ring_store(out + 4 * ld, frac);
    ring_store(out + 5 * ld, code == SKYSCRAPER ? 1.0f : 0.0f);
  }
}

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

// The first layer streams the observation straight from the ring column.
template <typename T>
__device__ int greedy_action(const T* col, long long ld, const TickArgs& a) {
  constexpr int H = DIMS[1];
  float acc[H];
#pragma unroll
  for (int j = 0; j < H; ++j) acc[j] = 0.0f;
#pragma unroll 2
  for (int i = 0; i < OBS; ++i) fma_row<H>(a.w[0] + i * H, ring_load(col + (long long)i * ld), acc);
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
  T* ring = static_cast<T*>(a.ring);

  // --- keys: rows of split(step_key, E + 2) -----------------------------
  const Key step_key{a.key0, a.key1};
  const Key env_key = split_row(step_key, (uint32_t)e);
  const Key actor_key = split_row(step_key, (uint32_t)E);
  // core.step: key, respawn_key = split(key); then split(key) again.
  const Key nk = split_row(env_key, 0u);
  const Key ground_key = split_row(env_key, 1u);
  const Key air_key = split_row(nk, 1u);

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
  if (!(u0 < __ldg(a.eps))) act[0] = greedy_action(ring + a.read_col + e, a.ring_ld, a);

  // --- load the env ------------------------------------------------------
  int8_t g0[C];  // the board at the start of the tick
  int8_t g[C];   // the board being stepped
  for (int c = 0; c < C; ++c) g0[c] = g[c] = a.ground_in[(long long)c * E + e];
  int ax[N], ay[N];
  bool carry0[N];
  float charge[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ax[i] = a.ax_in[i * E + e];
    ay[i] = a.ay_in[i * E + e];
    carry0[i] = a.carry_in[i * E + e] != 0;
    charge[i] = a.charge_in[i * E + e];
  }

  // --- move and crashes --------------------------------------------------
  int nx[N], ny[N], target[N];
  bool off[N], done[N], carrying[N], picked[N], delivered[N], charging[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int dy = act[i] == UP ? -1 : (act[i] == DOWN ? 1 : 0);
    const int dx = act[i] == LEFT ? -1 : (act[i] == RIGHT ? 1 : 0);
    ny[i] = ay[i] + dy;
    nx[i] = ax[i] + dx;
    off[i] = ny[i] < 0 || ny[i] >= G || nx[i] < 0 || nx[i] >= G;
    // jnp gathers wrap -1 and clamp; every such drone is collided anyway.
    target[i] = g0[wrap_clamp(ny[i]) * G + wrap_clamp(nx[i])];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    bool hit_drone = false;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j != i && nx[j] == nx[i] && ny[j] == ny[i]) hit_drone = true;
    }
    const bool collided = off[i] || (target[i] == SKYSCRAPER && !off[i]) || hit_drone;

    // --- battery ---------------------------------------------------------
    charging[i] = target[i] == STATION && !collided;
    const bool discharging = !charging[i] && !collided;
    float ch = charge[i] + (float)(charging[i] ? CHARGE_UP : 0);
    ch = fminf(fmaxf(ch, 0.0f), 100.0f);
    ch = ch - (float)(discharging ? DISCHARGE : 0);
    ch = fminf(fmaxf(ch, 0.0f), 100.0f);
    done[i] = collided || ch == 0.0f;
    charge[i] = done[i] ? 100.0f : ch;

    // --- pickup and delivery ---------------------------------------------
    picked[i] = target[i] == PACKET && !done[i] && !carry0[i];
    carrying[i] = (carry0[i] && !done[i]) || picked[i];
    delivered[i] = target[i] == DROPZONE && !done[i] && carry0[i];
    carrying[i] = carrying[i] && !delivered[i];
  }

  // zeros.at[new_y, new_x].set(flags): -1 wraps, off-board writers drop,
  // the last writer to a cell wins (pickup lifts, delivered dropzones).
  int wcell[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = ny[i] < 0 ? ny[i] + G : ny[i];
    const int c = nx[i] < 0 ? nx[i] + G : nx[i];
    wcell[i] = (r >= 0 && r < G && c >= 0 && c < G) ? r * G + c : -1;
  }
  bool lift[N], consume[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    bool last = wcell[i] >= 0;
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      if (wcell[j] == wcell[i]) last = false;
    }
    lift[i] = last && picked[i];
    consume[i] = last && delivered[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (lift[i]) g[wcell[i]] = EMPTY;
  }

  // --- packet and dropzone respawns: one uniform field for both (the
  // reference env's key quirk), num_packets slots each -------------------
  uint32_t u[C];
  uniform_field(ground_key, u);
  int8_t fills[N];
#pragma unroll
  for (int i = 0; i < N; ++i) fills[i] = (delivered[i] || (done[i] && carry0[i])) ? PACKET : EMPTY;
  ground_spawn<N, NPACK>(g, u, fills);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (consume[i]) g[wcell[i]] = EMPTY;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) fills[i] = delivered[i] ? DROPZONE : EMPTY;
  ground_spawn<N, NPACK>(g, u, fills);

  // --- rewards, then dead drones respawn in the air -----------------------
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // The env's sum, term by term in f32 (each product is exact).
    a.rewards[i * E + e] = a.crash_reward * (done[i] ? 1.0f : 0.0f) +
                           a.pickup_reward * (picked[i] ? 1.0f : 0.0f) +
                           a.delivery_reward * (delivered[i] ? 1.0f : 0.0f) +
                           a.charge_reward * (charging[i] ? 1.0f : 0.0f);
    a.dones[i * E + e] = done[i] ? 1 : 0;
    a.actions[i * E + e] = act[i];
    if (done[i]) nx[i] = ny[i] = -1;
  }
  uniform_field(air_key, u);
  air_spawn(u, g0, nx, ny);

  // Respawned drones pick up a packet under them, indexed transposed [x, y].
  bool up[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    up[i] = done[i] && g[wrap_clamp(nx[i]) * G + wrap_clamp(ny[i])] == PACKET;
    carrying[i] = carrying[i] || up[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (up[i]) g[wrap_clamp(nx[i]) * G + wrap_clamp(ny[i])] = EMPTY;
  }

  if (a.do_reset) {
    // --- core.reset with row e of split(S[E + 1], E) -----------------------
    Key k = split_row(split_row(step_key, (uint32_t)(E + 1)), (uint32_t)e);
    Key placement[5];
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      placement[s] = split_row(k, 1u);
      k = split_row(k, 0u);
    }
    for (int c = 0; c < C; ++c) g[c] = EMPTY;
    int8_t fill[MAX_FILL];
#define DR_RESET_SPAWN(slot, COUNT, CODE)                  \
  uniform_field(placement[slot], u);                       \
  for (int s = 0; s < COUNT; ++s) fill[s] = CODE;         \
  ground_spawn<COUNT, COUNT>(g, u, fill);
    DR_RESET_SPAWN(0, NPACK, PACKET)
    DR_RESET_SPAWN(1, NDROP, DROPZONE)
    DR_RESET_SPAWN(2, NSTAT, STATION)
    DR_RESET_SPAWN(3, NSKY, SKYSCRAPER)
#undef DR_RESET_SPAWN
#pragma unroll
    for (int i = 0; i < N; ++i) nx[i] = ny[i] = -1;
    uniform_field(placement[4], u);
    air_spawn(u, g, nx, ny);
    // Auto-pickup without reward, indexed [y, x] (not transposed at reset).
#pragma unroll
    for (int i = 0; i < N; ++i) {
      carrying[i] = g[ny[i] * G + nx[i]] == PACKET;
      charge[i] = 100.0f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (carrying[i]) g[ny[i] * G + nx[i]] = EMPTY;
    }
  }

  // --- store the state and the next observation ---------------------------
  for (int c = 0; c < C; ++c) a.ground_out[(long long)c * E + e] = g[c];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a.ax_out[i * E + e] = nx[i];
    a.ay_out[i * E + e] = ny[i];
    a.carry_out[i * E + e] = carrying[i] ? 1 : 0;
    a.charge_out[i * E + e] = charge[i];
  }
  write_obs(ring + a.write_col + e, a.ring_ld, g, nx, ny, carrying, charge);
}

}  // namespace dronerl

extern "C" int full_tick_ring_launch(const dronerl::TickArgs* args, void* stream) {
  using namespace dronerl;
  if (args->num_envs <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((args->num_envs + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->ring_bf16) {
    full_tick_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(*args);
  } else {
    full_tick_kernel<float><<<grid, THREADS, 0, s>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* full_tick_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

