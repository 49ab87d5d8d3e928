// One env's tick run by one warp: the physics, the spawns and the
// periodic reset, for the kernels built on a block tile of envs staged
// through shared memory (full_tick.cu: B1, B3; env_kernel.cu: B4, B5),
// with the block-wide window observation at the end.
//
// The semantics are the JAX package's core.step / core.reset /
// core.observe, bit for bit, quirks included: a spawn is k
// argmax-and-retire rounds over the vacant cells, ties to the lowest
// index (lax.top_k's stable order), compared on the 23 mantissa bits the
// uniform float is made from; jnp's scatter and gather semantics (wrap -1,
// clamp, drop off-board writes, the last writer wins) are written out per
// drone. The mapping onto threads:
//
// * Lanes own cells: lane l holds cells c = l + 32 k, k < KC, with their
//   board bytes and the spawn fields' uniforms in registers (static
//   indices only, so nothing goes to local memory).
// * Drone i lives on lane i & 31, in slot i >> 5 of the DPL slots a lane
//   holds; the drones meet through shuffles.
// * A spawn pick is one warp reduction over a packed key of the candidate
//   cells still untaken: the largest key is top_k's next element (u
//   descending, ties to the lowest index). When no candidate is left,
//   top_k's -inf tail is the lowest untaken index, one __reduce_min_sync.
// * The occupied-cell rank of a spawn with more slots than vacant cells
//   is a ballot and a prefix popcount.
// * The board at the start of the tick stays in the block's shared tile
//   (the env's cells at stride `ld`) for the drones' target lookups; the
//   board being stepped is in the lanes' registers.
// * The observation is a block-wide pass over (position, env) items once
//   every env of the tile has stepped (observe_tile: a drone's window, or
//   with DR_GLOBAL the whole board), one pass for each collected drone: a
//   warp per env would leave most lanes of its last pass idle and
//   serialise the drone lookups.
//
// Two bodies, chosen at compile time. The narrow one (C <= 256, N <= 32:
// B1, B3, B4, and B5 on small boards) keys a pick 0x80000000 | u23 << 8 |
// (255 - c), where 0 means "no candidate left". The wide one (up to 512
// cells and 64 drones: B5 on larger boards) keys it u23 << 9 | (511 - c),
// where every value, 0 included, is a real candidate, so a spawn counts
// its candidates (a ballot popcount) and round s has one while s < that
// count. The wide body also walks only the drones a sparse event concerns
// (lifts, consumes, respawn pickups) by ballot, skips the spawn rounds
// that change nothing (a 0 fill onto a vacant cell, an air pick after the
// last drone to place), marks the drones' cells by shift, and above 8
// cells a lane hashes the air field into the ground field's registers
// after the ground spawns.

#pragma once

#include "env_step.cuh"

namespace dronerl {
namespace warp {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int KC = (C + 31) / 32;   // cells a lane owns
constexpr int DPL = (N + 31) / 32;  // drone slots a lane holds
constexpr bool WIDE = C > 256 || N > 32;
static_assert(C <= 512, "the wide pick key holds 9 bits of cell index");
static_assert(N <= 64, "at most two drone slots a lane");

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int cell_of(int k) { return lane_id() + 32 * k; }

// v of lane i.
__device__ __forceinline__ int from(int v, int i) { return __shfl_sync(FULL, v, i); }

// v of drone i (warp-uniform i), from its lane's slot i >> 5.
template <typename V>
__device__ __forceinline__ int of_drone(const V* v, int i) {
  if constexpr (DPL == 1) {
    return from((int)v[0], i);
  } else {
    return from((int)(i < 32 ? v[0] : v[1]), i & 31);
  }
}

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

// The cells of every drone whose flag is set become EMPTY: cells[s] and
// flags[s] are the lane's slots (flags false off the drones).
__device__ __forceinline__ void erase_where(int* g, const int* cells, const bool* flags) {
  if constexpr (!WIDE) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int cell = from(cells[0], i);
      if (from((int)flags[0], i)) set_cell(g, cell, EMPTY);
    }
  } else {
#pragma unroll
    for (int s = 0; s < DPL; ++s) {
#pragma unroll 1
      for (uint32_t m = __ballot_sync(FULL, flags[s]); m != 0u; m &= m - 1u) {
        set_cell(g, from(cells[s], __ffs(m) - 1), EMPTY);
      }
    }
  }
}

// One past the highest drone index whose flag is set, 0 if none
// (warp-uniform): flags[s] is the lane's slot s.
__device__ __forceinline__ int past_last(const bool* flags) {
  int n = 0;
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    const uint32_t m = __ballot_sync(FULL, flags[s] && lane_id() + 32 * s < N);
    if (m != 0u) n = 32 * s + 32 - __clz(m);
  }
  return n;
}

// The spawn rounds up to the last drone whose fill is not EMPTY: all N
// in the narrow body, which runs every round.
__device__ __forceinline__ int live_rounds(const int* fill) {
  if constexpr (!WIDE) {
    return N;
  } else {
    bool some[DPL];
#pragma unroll
    for (int s = 0; s < DPL; ++s) some[s] = fill[s] != EMPTY;
    return past_last(some);
  }
}

// The lowest cell not yet taken (top_k's -inf tail).
__device__ __forceinline__ int lowest_untaken(uint32_t taken) {
  uint32_t low = 0xFFFFFFFFu;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if (cell_of(k) < C && !(taken >> k & 1u)) low = min(low, (uint32_t)cell_of(k));
  }
  return (int)__reduce_min_sync(FULL, low);
}

// The next cell of top_k(where(valid, u, -inf), .)'s order: `valid` and
// `taken` are the lane's bit sets over k; `candidate` (the wide body's
// count, warp-uniform) says whether an untaken valid cell is left. Marks
// the pick taken.
__device__ __forceinline__ int pick_next(const uint32_t* u, uint32_t valid, uint32_t& taken,
                                         bool candidate) {
  int cell;
  if constexpr (!WIDE) {
    uint32_t best = 0u;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if ((valid & ~taken) >> k & 1u) {
        best = max(best, 0x80000000u | (u[k] << 8) | (uint32_t)(255 - cell_of(k)));
      }
    }
    best = __reduce_max_sync(FULL, best);
    cell = best != 0u ? 255 - (int)(best & 255u) : lowest_untaken(taken);
  } else if (candidate) {
    uint32_t best = 0u;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if ((valid & ~taken) >> k & 1u) {
        best = max(best, (u[k] << 9) | (uint32_t)(511 - cell_of(k)));
      }
    }
    cell = 511 - (int)(__reduce_max_sync(FULL, best) & 511u);
  } else {
    cell = lowest_untaken(taken);
  }
  if ((cell & 31) == lane_id()) taken |= 1u << (cell >> 5);
  return cell;
}

// place_on_ground with K slots whose first ROUNDS fills are fill(s) and
// the rest 0: ROUNDS picks over the vacant cells, and the occupied cells
// ranked in [ROUNDS, K) of the spawn order erased (a board with fewer
// vacant cells than slots). The erased cells were ranked after every
// pick, so the order of the two steps does not matter; picks read the
// vacancy fixed at the start. fill(s) is 0 from round `live` on: the
// wide body skips those rounds that still have a candidate (each writes
// 0 onto a vacant cell).
template <int ROUNDS, int K, typename Fill>
__device__ __forceinline__ void ground_spawn(int* g, const uint32_t* u, Fill fill,
                                             int live = ROUNDS) {
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
    if constexpr (WIDE) {
      if (s == live && s < n_vacant) {
        // Rounds [live, n_vacant) would take the rest of the vacant cells.
        taken |= valid;
        s = n_vacant;
        if (s >= ROUNDS) break;
      }
    }
    const int v = fill(s);
    set_cell(g, pick_next(u, valid, taken, s < n_vacant), v);
  }
}

// place_in_air: the lane's slots hold drones at (ax[s], ay[s]); drones at
// the -1 sentinel take candidate i = their index. Occupancy is marked
// transposed (cell x * G + y, -1 wrapping to G - 1) and cells where
// is_sky(k) are excluded: the reference env's quirks.
template <typename Sky>
__device__ __forceinline__ void air_spawn(const uint32_t* u, Sky is_sky, int* ax, int* ay) {
  uint32_t occupied = 0u;
  int mine[DPL];
#pragma unroll
  for (int s = 0; s < DPL; ++s) mine[s] = wrap_clamp(ax[s]) * G + wrap_clamp(ay[s]);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int cell = of_drone(mine, i);
    if constexpr (!WIDE) {
#pragma unroll
      for (int k = 0; k < KC; ++k) occupied |= (cell_of(k) == cell ? 1u : 0u) << k;
    } else {
      occupied |= ((cell & 31) == lane_id() ? 1u : 0u) << (cell >> 5);
    }
  }
  uint32_t valid = 0u;
  int n_valid = 0;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const bool ok = cell_of(k) < C && !(occupied >> k & 1u) && !is_sky(k);
    valid |= (ok ? 1u : 0u) << k;
    if constexpr (WIDE) n_valid += __popc(__ballot_sync(FULL, ok));
  }
  // The wide body stops after the last drone to place: later picks place
  // none.
  int rounds = N;
  if constexpr (WIDE) {
    bool unplaced[DPL];
#pragma unroll
    for (int s = 0; s < DPL; ++s) unplaced[s] = ax[s] == -1 || ay[s] == -1;
    rounds = past_last(unplaced);
  }
  uint32_t taken = 0u;
#pragma unroll 1
  for (int i = 0; i < rounds; ++i) {
    const int cand = pick_next(u, valid, taken, i < n_valid);
#pragma unroll
    for (int s = 0; s < DPL; ++s) {
      if (lane_id() + 32 * s == i) {
        if (ax[s] == -1) ax[s] = cand / G;
        if (ay[s] == -1) ay[s] = cand % G;
      }
    }
  }
}

// One drone's state.
struct Drone {
  int x, y;
  bool carrying;
  float charge;
};

// core.step of one env. g0 points at the env's first cell in the block's
// board tile (the board at the start of the tick, cell stride `ld`);
// is_sky(k) says whether the lane's cell k held a skyscraper then; g holds
// the lane's cells, stepped in place. Slot s of a lane whose drone index
// lane + 32 s < N is that drone with action act[s]; it gets its reward
// and done. u and ua are the lane's scratch for the two uniform fields
// (above KC = 8 the air field reuses u, and ua is not touched).
template <typename Sky>
__device__ __forceinline__ void step_env(Key ground_key, Key air_key, const int* act,
                                         const int8_t* g0, int ld, Sky is_sky, int* g,
                                         Drone* d, float* reward, bool* done,
                                         const Rewards& rw, uint32_t* u, uint32_t* ua) {
  const int lane = lane_id();
  uint32_t* const air = KC > 8 ? u : ua;
  // The fields' hashes are independent of the step: both first where the
  // registers allow.
  lane_field(ground_key, u);
  if constexpr (KC <= 8) lane_field(air_key, air);

  // --- move and crashes ----------------------------------------------------
  bool carry0[DPL], hit_drone[DPL];
  int nx[DPL], ny[DPL], target[DPL];
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    carry0[s] = d[s].carrying;
    const int dy = act[s] == UP ? -1 : (act[s] == DOWN ? 1 : 0);
    const int dx = act[s] == LEFT ? -1 : (act[s] == RIGHT ? 1 : 0);
    ny[s] = d[s].y + dy;
    nx[s] = d[s].x + dx;
    target[s] = g0[(wrap_clamp(ny[s]) * G + wrap_clamp(nx[s])) * ld];
    hit_drone[s] = false;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int xj = of_drone(nx, j);
    const int yj = of_drone(ny, j);
#pragma unroll
    for (int s = 0; s < DPL; ++s) {
      if (j != lane + 32 * s && xj == nx[s] && yj == ny[s]) hit_drone[s] = true;
    }
  }

  bool picked[DPL], delivered[DPL], charging[DPL], carrying[DPL];
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    const bool off = ny[s] < 0 || ny[s] >= G || nx[s] < 0 || nx[s] >= G;
    const bool collided = off || (target[s] == SKYSCRAPER && !off) || hit_drone[s];

    // --- battery -----------------------------------------------------------
    charging[s] = target[s] == STATION && !collided;
    const bool discharging = !charging[s] && !collided;
    float ch = d[s].charge + (float)(charging[s] ? CHARGE_UP : 0);
    ch = fminf(fmaxf(ch, 0.0f), 100.0f);
    ch = ch - (float)(discharging ? DISCHARGE : 0);
    ch = fminf(fmaxf(ch, 0.0f), 100.0f);
    done[s] = collided || ch == 0.0f;
    d[s].charge = done[s] ? 100.0f : ch;

    // --- pickup and delivery -----------------------------------------------
    picked[s] = target[s] == PACKET && !done[s] && !carry0[s];
    carrying[s] = (carry0[s] && !done[s]) || picked[s];
    delivered[s] = target[s] == DROPZONE && !done[s] && carry0[s];
    carrying[s] = carrying[s] && !delivered[s];
  }

  // zeros.at[new_y, new_x].set(flags): -1 wraps, off-board writers drop,
  // the last writer to a cell wins.
  int wcell[DPL];
  bool last[DPL];
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    const int wr = ny[s] < 0 ? ny[s] + G : ny[s];
    const int wc = nx[s] < 0 ? nx[s] + G : nx[s];
    wcell[s] = (wr >= 0 && wr < G && wc >= 0 && wc < G) ? wr * G + wc : -1;
    last[s] = wcell[s] >= 0;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int wj = of_drone(wcell, j);
#pragma unroll
    for (int s = 0; s < DPL; ++s) {
      if (wj == wcell[s] && j > lane + 32 * s) last[s] = false;
    }
  }
  bool lift[DPL], consume[DPL];
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    lift[s] = last[s] && picked[s] && lane + 32 * s < N;
    consume[s] = last[s] && delivered[s] && lane + 32 * s < N;
  }
  erase_where(g, wcell, lift);

  // --- packet and dropzone respawns: one field for both --------------------
  int fill[DPL];
#pragma unroll
  for (int s = 0; s < DPL; ++s) fill[s] = (delivered[s] || (done[s] && carry0[s])) ? PACKET : EMPTY;
  ground_spawn<N, NPACK>(g, u, [&](int i) { return of_drone(fill, i); }, live_rounds(fill));
  erase_where(g, wcell, consume);
#pragma unroll
  for (int s = 0; s < DPL; ++s) fill[s] = delivered[s] ? DROPZONE : EMPTY;
  ground_spawn<N, NPACK>(g, u, [&](int i) { return of_drone(fill, i); }, live_rounds(fill));

  // --- rewards, then dead drones respawn in the air -------------------------
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    reward[s] = rw.crash * (done[s] ? 1.0f : 0.0f) + rw.pickup * (picked[s] ? 1.0f : 0.0f) +
                rw.delivery * (delivered[s] ? 1.0f : 0.0f) +
                rw.charge * (charging[s] ? 1.0f : 0.0f);
    if (done[s]) nx[s] = ny[s] = -1;
  }
  if constexpr (KC > 8) lane_field(air_key, air);
  air_spawn(air, is_sky, nx, ny);

  // Respawned drones pick up a packet under them, indexed transposed [x, y].
  int under[DPL];
  bool up[DPL];
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    under[s] = wrap_clamp(nx[s]) * G + wrap_clamp(ny[s]);
    up[s] = false;
  }
  if constexpr (!WIDE) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool hit = cell_is(g, from(under[0], i), PACKET);
      if (lane == i) up[0] = done[0] && hit;
    }
  } else {
#pragma unroll
    for (int s = 0; s < DPL; ++s) {
#pragma unroll 1
      for (uint32_t m = __ballot_sync(FULL, done[s] && lane + 32 * s < N); m != 0u;
           m &= m - 1u) {
        const int i = __ffs(m) - 1;
        const bool hit = cell_is(g, from(under[s], i), PACKET);
        if (lane == i) up[s] = hit;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < DPL; ++s) d[s].carrying = carrying[s] || up[s];
  erase_where(g, under, up);
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    d[s].x = nx[s];
    d[s].y = ny[s];
  }
}

// core.reset of one env from its five placement keys.
__device__ __forceinline__ void reset_env(const Key* placement, int* g, Drone* d, uint32_t* u) {
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
  int ax[DPL], ay[DPL];
#pragma unroll
  for (int s = 0; s < DPL; ++s) ax[s] = ay[s] = -1;
  lane_field(placement[4], u);
  air_spawn(u, [&](int k) { return g[k] == SKYSCRAPER; }, ax, ay);
  // Auto-pickup without reward, indexed [y, x] (not transposed at reset).
  int under[DPL];
  bool up[DPL];
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    d[s].x = ax[s];
    d[s].y = ay[s];
    under[s] = ay[s] * G + ax[s];
    up[s] = false;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool hit = cell_is(g, of_drone(under, i), PACKET);
#pragma unroll
    for (int s = 0; s < DPL; ++s) {
      if (lane_id() + 32 * s == i) up[s] = hit;
    }
  }
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    d[s].carrying = up[s];
    d[s].charge = 100.0f;
  }
  erase_where(g, under, up);
}

// Where entry k (a cell or a drone) of env el lies in a block tile of EBT
// envs of a K-entry field: feature-major (K, EBT), as B1, B3 and B4 stage
// their envs, or env-major (EBT, K), as B5 stages its row-major spans.
template <int EBT, bool kEnvMajor>
__device__ __forceinline__ int tile_at(int k, int el, int K) {
  return kEnvMajor ? el * K + k : k * EBT + el;
}

// The observation passes below take (item, env) pairs of a block tile and
// write feature f of env el at obs + f * ld + el (feature-major: `ld` is the
// feature stride, neighbouring threads take neighbouring envs, the stores
// coalesce across envs) or, with kEnvMajor, at obs + el * ld + f (`ld` is
// the env stride, the features of an env contiguous: neighbouring threads
// take neighbouring items of one env, and only the tile's first `ne` envs
// are visited).
template <int EBT, bool kEnvMajor, int P>
__device__ __forceinline__ int item_limit(int ne) {
  return kEnvMajor ? P * ne : P * EBT;
}

// core.observe's window of drone `drone` of every env of a block tile,
// flattened (position, channel), into `obs` (see item_limit): with
// feature-major tiles thread t of THREADS takes the (position p, env el)
// items p * EBT + el = t, t + THREADS, ..., so neighbouring threads touch
// neighbouring envs; with kEnvMajor the items el * W * W + p. The board is
// the C-entry tile, the drones the N-entry tiles (tile_at); envs from
// `ne` on are not written.
template <int EBT, int THREADS, bool kEnvMajor = false, typename T, typename Ld>
__device__ __forceinline__ void observe_window_tile(int drone, T* obs, Ld ld,
                                                    const int8_t* board, const int* xs,
                                                    const int* ys, const int8_t* carry,
                                                    const float* charge, int ne) {
  constexpr int P = W * W;
#pragma unroll 2
  for (int it = threadIdx.x; it < item_limit<EBT, kEnvMajor, P>(ne); it += THREADS) {
    const int p = kEnvMajor ? it % P : it / EBT, el = kEnvMajor ? it / P : it % EBT;
    if (!kEnvMajor && el >= ne) continue;
    const int wy = ys[tile_at<EBT, kEnvMajor>(drone, el, N)] + p / W - R;
    const int wx = xs[tile_at<EBT, kEnvMajor>(drone, el, N)] + p % W - R;
    const bool inside = wy >= 0 && wy < G && wx >= 0 && wx < G;
    int code = SKYSCRAPER;
    float chg = 0.0f;  // charge + 1 where a drone is, else 0
    if (inside) {
      code = board[tile_at<EBT, kEnvMajor>(wy * G + wx, el, C)];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int j = tile_at<EBT, kEnvMajor>(i, el, N);
        if (ys[j] == wy && xs[j] == wx) chg = charge[j] + 1.0f;
      }
    }
    bool is_packet = code == PACKET;
    if (p == (W * W) / 2) {
      is_packet = is_packet || carry[tile_at<EBT, kEnvMajor>(drone, el, N)] != 0;
    }
    T* out = kEnvMajor ? obs + el * ld + p * NUM_CH : obs + p * NUM_CH * ld + el;
    const Ld fs = kEnvMajor ? Ld(1) : ld;  // the feature stride
    obs_store(out + 0 * fs, chg > 0.0f ? 1.0f : 0.0f);
    obs_store(out + 1 * fs, is_packet ? 1.0f : 0.0f);
    obs_store(out + 2 * fs, code == DROPZONE ? 1.0f : 0.0f);
    obs_store(out + 3 * fs, code == STATION ? 1.0f : 0.0f);
    obs_store(out + 4 * fs, fminf(fmaxf(chg - 1.0f, 0.0f), 100.0f) / 100.0f);
    obs_store(out + 5 * fs, code == SKYSCRAPER ? 1.0f : 0.0f);
  }
}

// core._observe_global of every env of a block tile: the whole board,
// flattened (cell y G + x, channel), into `obs` (see item_limit), the same
// for every drone; thread t takes the (cell c, env el) items c * EBT + el
// = t, t + THREADS, ... (with kEnvMajor el * C + c). The drones are
// written in index order, as jnp's scatters write them: the drone channel
// set, the carried packet added to the packet channel (clamped to 1), the
// charge channel set to charge / 100, the last drone on a cell winning.
template <int EBT, int THREADS, bool kEnvMajor = false, typename T, typename Ld>
__device__ __forceinline__ void observe_global_tile(T* obs, Ld ld, const int8_t* board,
                                                    const int* xs, const int* ys,
                                                    const int8_t* carry, const float* charge,
                                                    int ne) {
#pragma unroll 2
  for (int it = threadIdx.x; it < item_limit<EBT, kEnvMajor, C>(ne); it += THREADS) {
    const int c = kEnvMajor ? it % C : it / EBT, el = kEnvMajor ? it / C : it % EBT;
    if (!kEnvMajor && el >= ne) continue;
    const int y = c / G, x = c % G;
    const int code = board[tile_at<EBT, kEnvMajor>(c, el, C)];
    bool drone = false, carried = false;
    float chg = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = tile_at<EBT, kEnvMajor>(i, el, N);
      if (ys[j] == y && xs[j] == x) {
        drone = true;
        carried = carried || carry[j] != 0;
        chg = charge[j] / 100.0f;
      }
    }
    T* out = kEnvMajor ? obs + el * ld + c * NUM_CH : obs + c * NUM_CH * ld + el;
    const Ld fs = kEnvMajor ? Ld(1) : ld;  // the feature stride
    obs_store(out + 0 * fs, drone ? 1.0f : 0.0f);
    obs_store(out + 1 * fs, code == PACKET || carried ? 1.0f : 0.0f);
    obs_store(out + 2 * fs, code == DROPZONE ? 1.0f : 0.0f);
    obs_store(out + 3 * fs, code == STATION ? 1.0f : 0.0f);
    obs_store(out + 4 * fs, chg);
    obs_store(out + 5 * fs, code == SKYSCRAPER ? 1.0f : 0.0f);
  }
}

// Drone `drone`'s observation of every env of a block tile (env_step.cuh's
// OBS features): its window, or with DR_GLOBAL the whole board, which
// every drone sees alike. Feature-major tiles and output by default (B1,
// B3, B4: `ld` the feature stride); with kEnvMajor env-major tiles and
// output (B5: `ld` the env stride).
template <int EBT, int THREADS, bool kEnvMajor = false, typename T, typename Ld>
__device__ __forceinline__ void observe_tile(int drone, T* obs, Ld ld, const int8_t* board,
                                             const int* xs, const int* ys, const int8_t* carry,
                                             const float* charge, int ne = EBT) {
  if constexpr (GLOBAL) {
    observe_global_tile<EBT, THREADS, kEnvMajor>(obs, ld, board, xs, ys, carry, charge, ne);
  } else {
    observe_window_tile<EBT, THREADS, kEnvMajor>(drone, obs, ld, board, xs, ys, carry, charge,
                                                 ne);
  }
}

}  // namespace warp
}  // namespace dronerl
