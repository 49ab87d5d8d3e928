// One env's tick run by one warp: the physics, the spawns and the
// periodic reset, for the tick kernels built on a block tile of envs
// staged through shared memory (full_tick.cu), with the block-wide window
// observation at the end.
//
// The semantics are env_step.cuh's (core.step / core.reset / core.observe
// bit for bit, quirks included); only the mapping onto threads differs:
//
// * Lanes own cells: lane l holds cells c = l + 32 k, k < KC, with their
//   board bytes and both spawn fields' uniforms in registers (static
//   indices only, so nothing goes to local memory).
// * Lane i < N holds drone i; the drones meet through shuffles.
// * A spawn pick is one warp reduction over the packed key
//   0x80000000 | u23 << 8 | (255 - c) of the candidate cells still
//   untaken: the largest key is top_k's next element (u descending, ties
//   to the lowest index). When no candidate is left, top_k's -inf tail
//   is the lowest untaken index, one __reduce_min_sync.
// * The occupied-cell rank of a spawn with more slots than vacant cells
//   is a ballot and a prefix popcount.
// * The board at the start of the tick stays in the block's shared tile
//   (column e, row stride EB) for the drones' target lookups; the board
//   being stepped is in the lanes' registers.
// * The window observation is a block-wide pass over (position, env)
//   items once every env of the tile has stepped (observe_tile): a warp
//   per env would leave most lanes of its last pass idle and serialise
//   the drone lookups.

#pragma once

#include "env_step.cuh"

namespace dronerl {
namespace warp {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int KC = (C + 31) / 32;  // cells a lane owns
static_assert(C <= 256, "the packed pick key holds 8 bits of cell index");
static_assert(N <= 32, "one lane per drone");

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int cell_of(int k) { return lane_id() + 32 * k; }

// v of lane i.
__device__ __forceinline__ int from(int v, int i) { return __shfl_sync(FULL, v, i); }

// The uniform field of `key` at the lane's cells, as 23-bit mantissas.
__device__ __forceinline__ void lane_field(Key key, uint32_t* u) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int c = cell_of(k);
    u[k] = c < C ? uniform_bits(key, (uint32_t)c) : 0u;
  }
}

// Set cell `cell` of the stepped board to `v` (the owner lane writes), as
// selects so that the board stays in registers.
__device__ __forceinline__ void set_cell(int* g, int cell, int v) {
  const bool owner = (cell & 31) == lane_id();
#pragma unroll
  for (int k = 0; k < KC; ++k) g[k] = owner && k == (cell >> 5) ? v : g[k];
}

// Whether cell `cell` of the stepped board holds `code` (warp-uniform).
__device__ __forceinline__ bool cell_is(const int* g, int cell, int code) {
  bool hit = false;
#pragma unroll
  for (int k = 0; k < KC; ++k) hit |= cell_of(k) == cell && g[k] == code;
  return __ballot_sync(FULL, hit) != 0u;
}

// The next cell of top_k(where(valid, u, -inf), .)'s order: `valid` and
// `taken` are the lane's bit sets over k. Marks the pick taken.
__device__ __forceinline__ int pick_next(const uint32_t* u, uint32_t valid, uint32_t& taken) {
  uint32_t best = 0u;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if ((valid & ~taken) >> k & 1u) {
      best = max(best, 0x80000000u | (u[k] << 8) | (uint32_t)(255 - cell_of(k)));
    }
  }
  best = __reduce_max_sync(FULL, best);
  int cell;
  if (best != 0u) {
    cell = 255 - (int)(best & 255u);
  } else {
    uint32_t low = 0xFFFFFFFFu;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if (cell_of(k) < C && !(taken >> k & 1u)) low = min(low, (uint32_t)cell_of(k));
    }
    cell = (int)__reduce_min_sync(FULL, low);
  }
  if ((cell & 31) == lane_id()) taken |= 1u << (cell >> 5);
  return cell;
}

// place_on_ground with K slots whose first ROUNDS fills are fill(s) and
// the rest 0 (env_step.cuh's ground_spawn): ROUNDS picks over the vacant
// cells, and the occupied cells ranked in [ROUNDS, K) erased.
template <int ROUNDS, int K, typename Fill>
__device__ __forceinline__ void ground_spawn(int* g, const uint32_t* u, Fill fill) {
  uint32_t valid = 0u;
  uint32_t occupied[KC];
  int n_vacant = 0;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const bool inside = cell_of(k) < C;
    const bool vacant = inside && g[k] == EMPTY;
    valid |= (vacant ? 1u : 0u) << k;
    n_vacant += __popc(__ballot_sync(FULL, vacant));
    occupied[k] = __ballot_sync(FULL, inside && !vacant);
  }
  if (K > ROUNDS) {
    const uint32_t below = (1u << lane_id()) - 1u;
    int base = n_vacant;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int rank = base + __popc(occupied[k] & below);
      if ((occupied[k] >> lane_id() & 1u) && rank >= ROUNDS && rank < K) g[k] = EMPTY;
      base += __popc(occupied[k]);
    }
  }
  uint32_t taken = 0u;
#pragma unroll 1
  for (int s = 0; s < ROUNDS; ++s) {
    const int v = fill(s);
    set_cell(g, pick_next(u, valid, taken), v);
  }
}

// place_in_air (env_step.cuh's air_spawn): lane i < N holds drone i at
// (ax, ay); drones at the -1 sentinel take candidate i.
__device__ __forceinline__ void air_spawn(const uint32_t* u, const int* board, int& ax, int& ay) {
  uint32_t occupied = 0u;
  const int mine = wrap_clamp(ax) * G + wrap_clamp(ay);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int cell = from(mine, i);
#pragma unroll
    for (int k = 0; k < KC; ++k) occupied |= (cell_of(k) == cell ? 1u : 0u) << k;
  }
  uint32_t valid = 0u;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const bool ok = cell_of(k) < C && !(occupied >> k & 1u) && board[k] != SKYSCRAPER;
    valid |= (ok ? 1u : 0u) << k;
  }
  uint32_t taken = 0u;
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
    const int cand = pick_next(u, valid, taken);
    if (lane_id() == i) {
      if (ax == -1) ax = cand / G;
      if (ay == -1) ay = cand % G;
    }
  }
}

// One drone's state on its lane.
struct Drone {
  int x, y;
  bool carrying;
  float charge;
};

// core.step of one env (env_step.cuh's step_env). g0 is the env's column
// of the block's board tile (the board at the start of the tick, row
// stride `ld`), g0r the lane's cells of it and g the same cells, stepped
// in place. Lane i < N: drone i with action `act`; it gets its reward
// and done. u and ua are the lane's scratch for the two uniform fields.
__device__ __forceinline__ void step_env(Key ground_key, Key air_key, int act,
                                         const int8_t* g0, int ld, const int* g0r, int* g,
                                         Drone& d, float& reward, bool& done,
                                         const Rewards& rw, uint32_t* u, uint32_t* ua) {
  const int lane = lane_id();
  // Both fields first: their hashes are independent of the step.
  lane_field(ground_key, u);
  lane_field(air_key, ua);

  // --- move and crashes ----------------------------------------------------
  const bool carry0 = d.carrying;
  const int dy = act == UP ? -1 : (act == DOWN ? 1 : 0);
  const int dx = act == LEFT ? -1 : (act == RIGHT ? 1 : 0);
  int ny = d.y + dy;
  int nx = d.x + dx;
  const bool off = ny < 0 || ny >= G || nx < 0 || nx >= G;
  const int target = g0[(wrap_clamp(ny) * G + wrap_clamp(nx)) * ld];
  bool hit_drone = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int xj = from(nx, j);
    const int yj = from(ny, j);
    if (j != lane && xj == nx && yj == ny) hit_drone = true;
  }
  const bool collided = off || (target == SKYSCRAPER && !off) || hit_drone;

  // --- battery -------------------------------------------------------------
  const bool charging = target == STATION && !collided;
  const bool discharging = !charging && !collided;
  float ch = d.charge + (float)(charging ? CHARGE_UP : 0);
  ch = fminf(fmaxf(ch, 0.0f), 100.0f);
  ch = ch - (float)(discharging ? DISCHARGE : 0);
  ch = fminf(fmaxf(ch, 0.0f), 100.0f);
  done = collided || ch == 0.0f;
  d.charge = done ? 100.0f : ch;

  // --- pickup and delivery -------------------------------------------------
  const bool picked = target == PACKET && !done && !carry0;
  bool carrying = (carry0 && !done) || picked;
  const bool delivered = target == DROPZONE && !done && carry0;
  carrying = carrying && !delivered;

  // zeros.at[new_y, new_x].set(flags): -1 wraps, off-board writers drop,
  // the last writer to a cell wins.
  const int wr = ny < 0 ? ny + G : ny;
  const int wc = nx < 0 ? nx + G : nx;
  const int wcell = (wr >= 0 && wr < G && wc >= 0 && wc < G) ? wr * G + wc : -1;
  bool last = wcell >= 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (from(wcell, j) == wcell && j > lane) last = false;
  }
  const bool lift = last && picked && lane < N;
  const bool consume = last && delivered && lane < N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int cell = from(wcell, i);
    if (from((int)lift, i)) set_cell(g, cell, EMPTY);
  }

  // --- packet and dropzone respawns: one field for both --------------------
  const int fill1 = (delivered || (done && carry0)) ? PACKET : EMPTY;
  ground_spawn<N, NPACK>(g, u, [=](int s) { return from(fill1, s); });
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int cell = from(wcell, i);
    if (from((int)consume, i)) set_cell(g, cell, EMPTY);
  }
  const int fill2 = delivered ? DROPZONE : EMPTY;
  ground_spawn<N, NPACK>(g, u, [=](int s) { return from(fill2, s); });

  // --- rewards, then dead drones respawn in the air -------------------------
  reward = rw.crash * (done ? 1.0f : 0.0f) + rw.pickup * (picked ? 1.0f : 0.0f) +
           rw.delivery * (delivered ? 1.0f : 0.0f) + rw.charge * (charging ? 1.0f : 0.0f);
  if (done) nx = ny = -1;
  air_spawn(ua, g0r, nx, ny);

  // Respawned drones pick up a packet under them, indexed transposed [x, y].
  const int under = wrap_clamp(nx) * G + wrap_clamp(ny);
  bool up = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool hit = cell_is(g, from(under, i), PACKET);
    if (lane == i) up = done && hit;
  }
  d.carrying = carrying || up;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int cell = from(under, i);
    if (from((int)up, i)) set_cell(g, cell, EMPTY);
  }
  d.x = nx;
  d.y = ny;
}

// core.reset of one env (env_step.cuh's reset_env) from its five
// placement keys.
__device__ __forceinline__ void reset_env(const Key* placement, int* g, Drone& d, uint32_t* u) {
#pragma unroll
  for (int k = 0; k < KC; ++k) g[k] = EMPTY;
#define DR_RESET_SPAWN(slot, COUNT, CODE) \
  lane_field(placement[slot], u);         \
  ground_spawn<COUNT, COUNT>(g, u, [](int) { return (int)CODE; });
  DR_RESET_SPAWN(0, NPACK, PACKET)
  DR_RESET_SPAWN(1, NDROP, DROPZONE)
  DR_RESET_SPAWN(2, NSTAT, STATION)
  DR_RESET_SPAWN(3, NSKY, SKYSCRAPER)
#undef DR_RESET_SPAWN
  d.x = d.y = -1;
  lane_field(placement[4], u);
  air_spawn(u, g, d.x, d.y);
  // Auto-pickup without reward, indexed [y, x] (not transposed at reset).
  const int under = d.y * G + d.x;
  bool up = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool hit = cell_is(g, from(under, i), PACKET);
    if (lane_id() == i) up = hit;
  }
  d.carrying = up;
  d.charge = 100.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int cell = from(under, i);
    if (from((int)up, i)) set_cell(g, cell, EMPTY);
  }
}

// core.observe's window of drone 0 of every env of a block tile, flattened
// (position, channel), into the tile's columns (row stride `ld`): thread
// t of THREADS takes the (position p, env el) items p * EBT + el = t,
// t + THREADS, ..., so neighbouring threads touch neighbouring envs. The
// board is the (C, EBT) tile, the drones the (N, EBT) tiles.
template <int EBT, int THREADS, typename T>
__device__ __forceinline__ void observe_tile(T* obs, int ld, const int8_t* board, const int* xs,
                                             const int* ys, const int8_t* carry,
                                             const float* charge) {
#pragma unroll 2
  for (int it = threadIdx.x; it < W * W * EBT; it += THREADS) {
    const int p = it / EBT, el = it % EBT;
    const int wy = ys[el] + p / W - R;
    const int wx = xs[el] + p % W - R;
    const bool inside = wy >= 0 && wy < G && wx >= 0 && wx < G;
    int code = SKYSCRAPER;
    float chg = 0.0f;  // charge + 1 where a drone is, else 0
    if (inside) {
      code = board[(wy * G + wx) * EBT + el];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (ys[i * EBT + el] == wy && xs[i * EBT + el] == wx) chg = charge[i * EBT + el] + 1.0f;
      }
    }
    bool is_packet = code == PACKET;
    if (p == (W * W) / 2) is_packet = is_packet || carry[el] != 0;
    T* out = obs + p * NUM_CH * ld + el;
    obs_store(out + 0 * ld, chg > 0.0f ? 1.0f : 0.0f);
    obs_store(out + 1 * ld, is_packet ? 1.0f : 0.0f);
    obs_store(out + 2 * ld, code == DROPZONE ? 1.0f : 0.0f);
    obs_store(out + 3 * ld, code == STATION ? 1.0f : 0.0f);
    obs_store(out + 4 * ld, fminf(fmaxf(chg - 1.0f, 0.0f), 100.0f) / 100.0f);
    obs_store(out + 5 * ld, code == SKYSCRAPER ? 1.0f : 0.0f);
  }
}

}  // namespace warp
}  // namespace dronerl
