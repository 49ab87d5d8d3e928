// One env's tick on the device: the physics, the spawns, the periodic
// reset and the window observation, shared by every env kernel.
//
// full_tick.cu (the training tick's env side with the actor), tick_kernel.cu
// (the tick with the caller's actions) and step_kernel.cu (the row-major
// step without observation) include this header and differ only in where
// they load and store an env and in what they add around step_env(): each
// runs one thread per env on the env's board and drones held in local
// arrays, so the functions below take and return those arrays.
//
// Semantics are the JAX package's core.step / core.reset / core.observe,
// bit for bit, quirks included: a spawn is k argmax-and-retire rounds over
// the vacant cells, ties to the lowest index (lax.top_k's stable order),
// compared on the 23 mantissa bits the uniform float is made from; jnp's
// scatter and gather semantics (wrap -1, clamp, drop off-board writes, the
// last writer wins) are written out per drone.
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
constexpr int OBS = W * W * NUM_CH;
constexpr int NPACK = DR_NPACKETS;
constexpr int NDROP = DR_NDROPZONES;
constexpr int NSTAT = DR_NSTATIONS;
constexpr int NSKY = DR_NSKYSCRAPERS;
constexpr int CHARGE_UP = DR_CHARGE_UP;
constexpr int DISCHARGE = DR_DISCHARGE;
constexpr int NUM_ACTIONS = 5;
constexpr int cmax(int x, int y) { return x > y ? x : y; }
constexpr int MAX_FILL = cmax(cmax(NPACK, NDROP), cmax(NSTAT, NSKY));
constexpr int THREADS = 128;

static_assert(NPACK >= N, "the step respawn needs num_packets >= n_drones");

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
// erasing the occupied cells ranked in [ROUNDS, K) of the spawn order
// (a board with fewer vacant cells than slots).
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
// The step

// core.step of one env with its key (row e of split(step_key, E)) and the
// drones' actions. g0 is the board at the start of the tick and g a copy
// of it, stepped in place; ax, ay, carrying and charge hold the drones at
// the start and the end of the tick. u is scratch for one uniform field.
__device__ __forceinline__ void step_env(Key env_key, const int* act, const int8_t* g0,
                                         int8_t* g, int* ax, int* ay, bool* carrying,
                                         float* charge, float* reward, bool* done,
                                         const Rewards& rw, uint32_t* u) {
  // core.step: key, respawn_key = split(key); then split(key) again.
  const Key nk = split_row(env_key, 0u);
  const Key ground_key = split_row(env_key, 1u);
  const Key air_key = split_row(nk, 1u);

  // --- move and crashes --------------------------------------------------
  int nx[N], ny[N], target[N];
  bool off[N], carry0[N], picked[N], delivered[N], charging[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    carry0[i] = carrying[i];
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
    reward[i] = rw.crash * (done[i] ? 1.0f : 0.0f) + rw.pickup * (picked[i] ? 1.0f : 0.0f) +
                rw.delivery * (delivered[i] ? 1.0f : 0.0f) +
                rw.charge * (charging[i] ? 1.0f : 0.0f);
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
    ax[i] = nx[i];
    ay[i] = ny[i];
  }
}

// core.reset of one env with its key (row e of split(reset_key, E)).
__device__ __forceinline__ void reset_env(Key k, int8_t* g, int* ax, int* ay, bool* carrying,
                                          float* charge, uint32_t* u) {
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
  for (int i = 0; i < N; ++i) ax[i] = ay[i] = -1;
  uniform_field(placement[4], u);
  air_spawn(u, g, ax, ay);
  // Auto-pickup without reward, indexed [y, x] (not transposed at reset).
#pragma unroll
  for (int i = 0; i < N; ++i) {
    carrying[i] = g[ay[i] * G + ax[i]] == PACKET;
    charge[i] = 100.0f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (carrying[i]) g[ay[i] * G + ax[i]] = EMPTY;
  }
}

// ---------------------------------------------------------------------------
// Observation

// core.observe's window of drone 0, flattened (position, channel), into
// the column `col` of a feature-major buffer with leading dimension ld.
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
    obs_store(out + 0 * ld, chg > 0.0f ? 1.0f : 0.0f);
    obs_store(out + 1 * ld, is_packet ? 1.0f : 0.0f);
    obs_store(out + 2 * ld, code == DROPZONE ? 1.0f : 0.0f);
    obs_store(out + 3 * ld, code == STATION ? 1.0f : 0.0f);
    obs_store(out + 4 * ld, frac);
    obs_store(out + 5 * ld, code == SKYSCRAPER ? 1.0f : 0.0f);
  }
}

}  // namespace dronerl
