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
//   is read from obs_t (COLLECT OBS, E) f32 and the next one written into a
//   new array of the same shape, or over obs_t itself. Given a StreamReplay's
//   storage (push_obs), the launch also pushes the tick's transitions into
//   it: each block stores its envs' input columns, drone d's row group at
//   the replay's columns start + d E + e (drone-major), with drone d's
//   action, reward and done, before the next observation goes over obs_t.
//   That replaces the push a separate index_copy_ made of obs_t after the
//   launch, and the copy of a new obs_t' into the carry's.
//
// With DR_COLLECT = k (collect_drones) a column holds the first k drones'
// observations as row groups of OBS rows, drone-major; the actor reads
// rows [0, OBS), drone 0's. With DR_RNG_ROUNDS / DR_ACTOR_ROUNDS (the
// fast-RNG mode) the env side's hashes / the actor's uniform field run
// that many threefry rounds (threefry.cuh), where the TPU kernel's
// rng_rounds / actor_rng_rounds take them.
//
// Both run one kernel: per-env threefry keys, the epsilon-greedy actor on
// obs_in's column, move / crash / battery / pickup / delivery, packet,
// dropzone and drone respawns, the optional full reset, and the
// observation (the window, or with DR_GLOBAL the whole board: see
// env_warp.cuh's observe_tile) stored into obs_out's column. The actor is
// a chain of dense layers: a dense net's, or a conv net's im2col lowering
// (ops/conv2mat.py, as the TPU kernel's _flatten_net_params lowers it),
// which the kernel runs as any other chain.
//
// What bounds it on the H100. At the bench shapes (65,536 envs, grid 9,
// 4 drones) the bytes are one read and one write of a 294-row observation
// per env (bf16 on the ring, f32 for B3) and the env state: 0.029 ms (B1)
// and 0.052 ms (B3) at 3.35 TB/s. The operations are about 170 threefry
// hashes per env (two fields of C uniforms, the keys and the actor's
// draws) and, for the (128,64) net, a 92k-FLOP Q forward per env. The
// one-thread-per-env kernel this replaces reached neither: its per-thread
// board and uniforms lived in local memory, every spawn pick rescanned all
// C cells serially (44% of its time at (16,16), by ablation), 168-255
// registers allowed 8-12 warps an SM, and the Q forward ran as
// warp-broadcast weight loads and f32 FMAs (70% of its time at (128,64)).
//
// The design:
//
// * A block owns EB = 64 consecutive envs (one mma M extent of 4 tiles of
//   16) and stages their input observation tile (294 x 64), board (C x
//   64) and drone state through shared memory with cp.async
//   (env_tile.cuh), 16 bytes a thread, whole rows of 64 contiguous envs;
//   the next observation tile, board and state go back the same way with
//   16-byte stores. Every global access coalesces without one thread per
//   env. A block reads all of its envs' input columns before it writes
//   any output column, so the ring's in-place launch (read and write
//   columns disjoint or equal) and B3's over obs_t are safe.
// * The keys and the actor's uniforms are hashed one thread per (env,
//   role) while the copies are in flight.
// * The dense layers but the last run on the tensor cores (mma.sync
//   m16n8k16, bf16 in, f32 accumulate), f32-accurate: each W is split
//   while it is staged into shared memory, in K-chunks, into three bf16
//   pieces (hi + mid + lo, 24 significant bits) laid out in fragment order.
//   A layer's output n-tiles of 8 units run in passes of at most 16 (4 a
//   warp, 16 accumulator registers), so a wide layer (a conv's im2col
//   matrix: 392 units for 8 channels on the 7 x 7 window) takes no more
//   registers or fragment bytes than a narrow one; the source is read
//   again each pass.
//   The bf16 ring's observations are exact in bf16 (fragments by
//   ldmatrix.trans), so B1's first layer takes 3 products a term; B3's
//   f32 observations (charge / 100) and the hidden activations are split
//   the same way, keeping the 6 products of order <= 2^-16 (the 3xTF32
//   scheme of CUTLASS's OpMultiplyAddFastF32, in bf16). The output layer
//   (5 actions) is f32 FMAs on the CUDA cores, eight threads an env. A
//   block where no env is greedy skips the actor and the observation
//   read.
// * The step and the reset run one warp per env on env_warp.cuh: lanes
//   own cells, each spawn pick is one warp reduction, no arrays in local
//   memory; the window observation is one block-wide pass over (position,
//   env) items.
//
// Blocks of 512 threads, two per SM (__launch_bounds__; one for the
// variant that reads the observation from device memory, below): 32 warps
// an SM, which caps a thread at 64 registers; ptxas keeps it within them with no
// spill and no stack (a pass's 16 accumulators a thread are the tightest;
// the output layer's pointers and the block's env count are read back
// from shared memory rather than held across the tensor-core layers).
// Shared memory is 83 KB a block with bf16 observations at (16,16), 90 KB
// at (128,64), 110 KB with f32: the f32 tile is what makes two blocks an
// SM the most. A wider chain's hidden activations take more (the window
// conv's 392 units: 101 KB of them, one block an SM); where they do not
// fit the block's 227 KB beside the observation tile (a conv on the
// global 9 x 9 board), they live in a device-memory scratch of the
// block's own, which the launch allocates (Layout::ACT_GLOBAL). Where the
// observation tile alone does not fit (the global view above 14 x 14
// cells in bf16, 11 x 11 in f32), the first layer reads its fragments
// from device memory and the next observation is stored there straight
// from the observation pass (Layout::OBS_GLOBAL; the activations then in
// the scratch too). The variant is chosen at compile time from the env
// and the widths; ops/fused_tick.py tick_layout mirrors it.
//
// The env and the net widths are compile-time constants (-D, see
// ops/_build.py).

#include <type_traits>

#include "env_tile.cuh"
#include "env_warp.cuh"

#if !defined(DR_NLAYERS)
#error "build through dronerl_tpu_torch/ops/_build.py (it passes the net -D set)"
#endif

namespace dronerl {

constexpr int MAX_LAYERS = 8;
// Layer widths: obs_dim, hidden..., num_actions (unused entries are 0):
// a dense net's, or a conv net's im2col chain.
constexpr int DIMS[MAX_LAYERS + 1] = {DR_DIM0, DR_DIM1, DR_DIM2, DR_DIM3, DR_DIM4,
                                      DR_DIM5, DR_DIM6, DR_DIM7, DR_DIM8};
constexpr int NL = DR_NLAYERS;

static_assert(C <= 256 && N <= 32, "the kernel takes <= 256 cells, <= 32 drones");
static_assert(NL >= 1 && NL <= MAX_LAYERS, "1..8 dense layers");
static_assert(DIMS[0] == OBS, "the first width is the observation");
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
  const uint32_t* key;  // the step key's two words, in device memory
  int8_t* ground_out;
  int32_t* ax_out;
  int32_t* ay_out;
  int8_t* carry_out;
  float* charge_out;
  float* rewards;
  int8_t* dones;
  int32_t* actions;
  float* scratch;  // Layout::SCRATCH bytes a block, where ACT_GLOBAL
  // B3's StreamReplay push: its storage (obs (OBS, push_ld), actions,
  // rewards, dones (push_ld,)) and the push's start slot in device memory;
  // push_obs null: no push (B1 always).
  float* push_obs;
  int32_t* push_actions;
  float* push_rewards;
  int8_t* push_dones;
  const int32_t* push_start;
  const float* w[MAX_LAYERS];
  const float* b[MAX_LAYERS];
  long long in_ld;
  long long read_col;
  long long out_ld;
  long long write_col;
  long long push_ld;  // the replay's capacity
  int num_envs;
  int obs_bf16;
  int do_reset;
  float pickup_reward;
  float delivery_reward;
  float crash_reward;
  float charge_reward;
};

// ---------------------------------------------------------------------------
// Block geometry and the shared-memory layout

constexpr int EB = 64;                  // envs a block
constexpr int WARPS = 16;
constexpr int BLOCK = 32 * WARPS;
constexpr int TPE = BLOCK / EB;         // threads an env in the output layer
constexpr int MT = EB / 16;             // mma m-tiles of 16 envs
constexpr int NGROUPS = WARPS / MT;     // warps sharing an m-tile
constexpr int PIECES = 3;               // bf16 pieces of a weight
constexpr int FRAG_WORDS = 64;          // one B fragment: a uint2 a lane
constexpr int FRAG_BYTES = PIECES * FRAG_WORDS * 4;  // its pieces
constexpr int KEY_WORDS = 4 + 10;       // ground and air keys, 5 placement keys
constexpr int PASS_NTW = 4;             // n-tiles a warp takes in one pass
constexpr int SMEM_LIMIT = 232448;      // shared memory a block can have
static_assert(TPE == 8, "the output layer's reductions run over 8 lanes");
static_assert(BLOCK / EB > 3, "key roles: env keys, gate, reset keys, random actions");
using Tile = BlockTile<EB, BLOCK>;

__host__ __device__ constexpr int cmaxi(int x, int y) { return x > y ? x : y; }
__host__ __device__ constexpr int cmini(int x, int y) { return x < y ? x : y; }

// Dense layer L (DIMS[L] -> DIMS[L + 1]) on the tensor cores: K and N
// zero-padded to 16, n-tiles of 8 spread over the NGROUPS warps of an
// m-tile, NTP of them a pass. Every layer but the last runs there (the
// last, with NUM_ACTIONS outputs, on the CUDA cores), except a net of one
// layer.
template <int L>
struct Mma {
  static constexpr int IN = DIMS[L], OUT = DIMS[L + 1];
  static constexpr int KSTEPS = up16(IN) / 16;
  static constexpr int NT = up16(OUT) / 8;
  static constexpr int NTP = cmini(NT, NGROUPS * PASS_NTW);
  static constexpr int NPASS = (NT + NTP - 1) / NTP;
  static constexpr int NTW = (NTP + NGROUPS - 1) / NGROUPS;
  // k-steps of W staged at once within `budget` bytes of fragments.
  __host__ __device__ static constexpr int chunk(int budget) {
    return cmini(KSTEPS, cmaxi(1, budget / (NTP * FRAG_BYTES)));
  }
};
constexpr int MMA_LAYERS = NL == 1 ? 1 : NL - 1;

// Row stride (floats) of layer L's output activations, (env, unit).
__host__ __device__ constexpr int act_stride(int l) { return DIMS[l + 1] + 4; }

// Bytes of the activation buffer of the layers whose output goes to
// buffer `parity` (0: layers 0, 2, ...; 1: layers 1, 3, ...).
constexpr int act_bytes(int parity) {
  int bytes = 0;
  for (int l = parity; l < MMA_LAYERS; l += 2) bytes = cmaxi(bytes, up16(EB * act_stride(l) * 4));
  return bytes;
}

// The fragment bytes of layer L's chunk within `budget`, the most over
// the tensor-core layers.
template <int L = 0>
constexpr int w_bytes(int budget) {
  if constexpr (L >= MMA_LAYERS) {
    return 0;
  } else {
    return cmaxi(Mma<L>::chunk(budget) * Mma<L>::NTP * FRAG_BYTES, w_bytes<L + 1>(budget));
  }
}

// The block's shared memory with the hidden activations in it
// (kActGlobal false) or in the block's device-memory scratch, and with
// the observation tile in it (kObsGlobal false) or not.
template <typename T, bool kActGlobal, bool kObsGlobal>
struct LayoutOf {
  // Row stride of the observation tile in elements: 16-byte rows whose
  // stride is 4 banks mod 32, so the fragment loads are conflict-free.
  static constexpr int S = sizeof(T) == 2 ? 72 : 68;
  static constexpr int OBS_BYTES = kObsGlobal ? 0 : up16(OBS) * S * (int)sizeof(T);
  static constexpr int W_BUDGET = sizeof(T) == 2 ? 24576 : 12288;
  static constexpr int W_BYTES = w_bytes(W_BUDGET);
  static constexpr int HA = act_bytes(0);
  static constexpr int HB = act_bytes(1);
  static constexpr bool ACT_GLOBAL = kActGlobal;
  static constexpr bool OBS_GLOBAL = kObsGlobal;
  // Resident blocks an SM that __launch_bounds__ asks for: one where the
  // observation is read from device memory, whose fragment loads hold its
  // address and row stride (up to 128 registers a thread, no spill).
  static constexpr int MIN_BLOCKS = kObsGlobal ? 1 : 2;
  static constexpr int SCRATCH = kActGlobal ? HA + HB : 0;
  // The activations replace the observation tile once the first layer
  // has read it, where that layer runs in one pass; else they follow it.
  static constexpr bool OVERLAY = Mma<0>::NPASS == 1;
  static constexpr int R_OBS =
      kActGlobal ? OBS_BYTES : (OVERLAY ? cmaxi(OBS_BYTES, HA + HB) : OBS_BYTES + HA + HB);
  static constexpr int OFF_HA = OVERLAY ? 0 : OBS_BYTES;
  static constexpr int OFF_HB = OFF_HA + HA;
  static constexpr int OFF_W = R_OBS;
  static constexpr int OFF_BOARD = OFF_W + W_BYTES;
  static constexpr int OFF_X = OFF_BOARD + up16(C * EB);
  static constexpr int OFF_Y = OFF_X + N * EB * 4;
  static constexpr int OFF_CHARGE = OFF_Y + N * EB * 4;
  static constexpr int OFF_REWARD = OFF_CHARGE + N * EB * 4;
  static constexpr int OFF_ACTION = OFF_REWARD + N * EB * 4;
  static constexpr int OFF_KEYS = OFF_ACTION + N * EB * 4;
  static constexpr int OFF_CARRY = OFF_KEYS + KEY_WORDS * EB * 4;
  static constexpr int OFF_DONE = OFF_CARRY + up16(N * EB);
  static constexpr int OFF_GREEDY = OFF_DONE + up16(N * EB);
  // The block's env count, B3's push start (-1: no push), and the output
  // layer's weight and bias pointers.
  static constexpr int OFF_META = OFF_GREEDY + up16(EB);
  static constexpr int TOTAL = OFF_META + 32;
};

// The first of: everything in shared memory; the activations in the
// scratch; the observation tile out of shared memory too.
template <typename T>
struct Variant {
  static constexpr bool ACT = LayoutOf<T, false, false>::TOTAL > SMEM_LIMIT;
  static constexpr bool OBS = ACT && LayoutOf<T, true, false>::TOTAL > SMEM_LIMIT;
};
template <typename T>
using Layout = LayoutOf<T, Variant<T>::ACT, Variant<T>::OBS>;

// ---------------------------------------------------------------------------
// The dense layers on the tensor cores

// x = p1 + p2 + p3 to 24 significant bits, each piece a bf16 (returned as
// the float it is); the differences are exact in f32.
__device__ __forceinline__ void split3(float x, float& p1, float& p2, float& p3) {
  p1 = __bfloat162float(__float2bfloat16_rn(x));
  const float r = x - p1;
  p2 = __bfloat162float(__float2bfloat16_rn(r));
  p3 = __bfloat162float(__float2bfloat16_rn(r - p2));
}

// Two bf16 values in one register, `lo` (the lower K index) in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A lane's (b0, b1) of one B fragment piece. Volatile, so that the loads
// of a later n-tile are not hoisted above this one's products (their
// registers would spill at 64 a thread).
__device__ __forceinline__ uint2 load_frag(const uint32_t* p) {
  uint2 v;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v2.u32 {%0,%1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage k-steps [s0, s0 + steps) of layer L's weights (IN x OUT f32,
// row-major) for the pass's NTP n-tiles from unit n_base, split into
// PIECES bf16 pieces, into B-fragment order:
// fragment (step, n-tile, piece) is 32 lanes' (b0, b1) pairs, lane =
// 4 (n % 8) + (k % 8) / 2, b0 rows k % 16 < 8, b1 the rest; zero outside
// IN x OUT. Item i is one word of a fragment: n % 8 = i % 8 fastest (the
// loads coalesce by rows of 8 units, a warp's stores fall on distinct
// banks two to one), then (k % 8) / 2, then b0 / b1. A thread's loads
// are all issued before the first is used (one L2 latency a chunk),
// through L2 only: the weights stream once a block.
template <int L, int CHUNK>
__device__ __forceinline__ void stage_w(uint32_t* frag, const float* __restrict__ w, int s0,
                                        int steps, int n_base) {
  using M = Mma<L>;
  constexpr int ITEMS = (CHUNK * M::NTP * FRAG_WORDS + BLOCK - 1) / BLOCK;
  float lo[ITEMS], hi[ITEMS];
  // Unsigned: signed index arithmetic adds sign fix-ups that stay live
  // across the chunk loop.
  const unsigned items = steps * M::NTP * FRAG_WORDS;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const unsigned i = threadIdx.x + it * BLOCK;
    const unsigned g = i & 7u, t = (i >> 3) & 3u, reg = (i >> 5) & 1u, f = i >> 6;
    const unsigned n = n_base + (f % M::NTP) * 8u + g;
    const unsigned k = (s0 + f / M::NTP) * 16u + reg * 8u + 2u * t;
    const bool live = i < items && n < M::OUT;
    lo[it] = live && k < M::IN ? __ldcg(w + k * M::OUT + n) : 0.0f;
    hi[it] = live && k + 1 < M::IN ? __ldcg(w + (k + 1) * M::OUT + n) : 0.0f;
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const unsigned i = threadIdx.x + it * BLOCK;
    if (i < items) {
      const unsigned g = i & 7u, t = (i >> 3) & 3u, reg = (i >> 5) & 1u, f = i >> 6;
      float l1, l2, l3, h1, h2, h3;
      split3(lo[it], l1, l2, l3);
      split3(hi[it], h1, h2, h3);
      uint32_t* out = frag + f * PIECES * FRAG_WORDS + (g * 4 + t) * 2 + reg;
      out[0] = pack_bf16(l1, h1);
      out[FRAG_WORDS] = pack_bf16(l2, h2);
      out[2 * FRAG_WORDS] = pack_bf16(l3, h3);
    }
  }
}

// A-fragment sources: the observation tile (rows = K, columns = envs) and
// an activation buffer (rows = envs, columns = K). load() fills the
// fragments of one k-step for the m-tile at env m0: a[0..3], and for an
// f32 source the three pieces' fragments a[0..3], a[4..7], a[8..11].
template <typename T>
struct ObsSource;

template <>
struct ObsSource<__nv_bfloat16> {
  static constexpr int PIECES_A = 1;  // the ring's bf16 values are exact
  const __nv_bfloat16* tile;
  // One ldmatrix.x4.trans: lane 8 q + r gives row r of 8x8 matrix q, the
  // 8 envs [m0 + 8 (q & 1), +8) of K row 16 step + 8 (q >> 1) + r; the
  // transpose hands each lane its (env, k) pairs of a[q].
  __device__ __forceinline__ void load(int step, int m0, uint32_t* a) const {
    constexpr int S = Layout<__nv_bfloat16>::S;
    const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
    const __nv_bfloat16* row = tile + (step * 16 + (q >> 1) * 8 + r) * S + m0 + (q & 1) * 8;
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(addr)
                 : "memory");
  }
};

template <>
struct ObsSource<float> {
  static constexpr int PIECES_A = 3;
  const float* tile;
  __device__ __forceinline__ void load(int step, int m0, uint32_t* a) const {
    constexpr int S = Layout<float>::S;
    const int lane = threadIdx.x & 31;
    const int k0 = step * 16 + 2 * (lane & 3);
    const int e = m0 + (lane >> 2);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + (r >> 1) * 8;
      const int col = e + (r & 1) * 8;
      float l1, l2, l3, h1, h2, h3;
      split3(tile[k * S + col], l1, l2, l3);
      split3(tile[(k + 1) * S + col], h1, h2, h3);
      a[r] = pack_bf16(l1, h1);
      a[4 + r] = pack_bf16(l2, h2);
      a[8 + r] = pack_bf16(l3, h3);
    }
  }
};

// The observation read from device memory (Layout::OBS_GLOBAL): rows = K
// (row stride ld), columns = the block's envs; rows past OBS and envs past
// ne read as 0. Fragments as ObsSource<float>'s, one piece where the
// values are bf16.
template <typename T>
struct GmemObsSource {
  static constexpr int PIECES_A = sizeof(T) == 2 ? 1 : 3;
  const T* obs;
  long long ld;
  int ne;
  __device__ __forceinline__ float at(int k, int e) const {
    return k < OBS && e < ne ? obs_load(obs + k * ld + e) : 0.0f;
  }
  __device__ __forceinline__ void load(int step, int m0, uint32_t* a) const {
    const int lane = threadIdx.x & 31;
    const int k0 = step * 16 + 2 * (lane & 3);
    const int e = m0 + (lane >> 2);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + (r >> 1) * 8;
      const int col = e + (r & 1) * 8;
      if constexpr (PIECES_A == 1) {
        a[r] = pack_bf16(at(k, col), at(k + 1, col));
      } else {
        float l1, l2, l3, h1, h2, h3;
        split3(at(k, col), l1, l2, l3);
        split3(at(k + 1, col), h1, h2, h3);
        a[r] = pack_bf16(l1, h1);
        a[4 + r] = pack_bf16(l2, h2);
        a[8 + r] = pack_bf16(l3, h3);
      }
    }
  }
};

template <int IN, int STRIDE>
struct ActSource {
  static constexpr int PIECES_A = 3;
  const float* x;
  __device__ __forceinline__ void load(int step, int m0, uint32_t* a) const {
    const int lane = threadIdx.x & 31;
    const int k0 = step * 16 + 2 * (lane & 3);
    const int e = m0 + (lane >> 2);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + (r >> 1) * 8;
      const float* row = x + (e + (r & 1) * 8) * STRIDE;
      float l1, l2, l3, h1, h2, h3;
      split3(k < IN ? row[k] : 0.0f, l1, l2, l3);
      split3(k + 1 < IN ? row[k + 1] : 0.0f, h1, h2, h3);
      a[r] = pack_bf16(l1, h1);
      a[4 + r] = pack_bf16(l2, h2);
      a[8 + r] = pack_bf16(l3, h3);
    }
  }
};

// Layer L's pre-activations of the block's envs in pass p on the tensor
// cores: warp w takes m-tile w % MT and the pass's n-tiles [w / MT * NTW,
// +NTW); acc[j] is the mma C fragment of its n-tile j. An exact source
// takes W's three pieces (3 products), an f32 one the 6 products of order
// <= 2^-16, smallest first; f32 accumulation throughout.
template <int L, int BUDGET, typename Src>
__device__ __forceinline__ void mma_layer(const Src& src, uint32_t* frag, const float* w,
                                          float (*acc)[4], int p) {
  using M = Mma<L>;
  constexpr int CHUNK = M::chunk(BUDGET);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp % MT) * 16;
  const int n0 = (warp / MT) * M::NTW;
  const int live = cmini(M::NTP, M::NT - p * M::NTP);  // the pass's n-tiles
#pragma unroll
  for (int j = 0; j < M::NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll 1
  for (int s0 = 0; s0 < M::KSTEPS; s0 += CHUNK) {
    const int steps = cmini(CHUNK, M::KSTEPS - s0);
    __syncthreads();  // the previous chunk's fragments are read
    stage_w<L, CHUNK>(frag, w, s0, steps, p * M::NTP * 8);
    __syncthreads();
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      uint32_t a[4 * Src::PIECES_A];
      src.load(s0 + s, m0, a);
#pragma unroll
      for (int j = 0; j < M::NTW; ++j) {
        if ((M::NPASS > 1 || M::NTP % NGROUPS != 0) && n0 + j >= live) break;
        const uint32_t* f = frag + (s * M::NTP + n0 + j) * PIECES * FRAG_WORDS + 2 * lane;
        const uint2 w1 = load_frag(f), w2 = load_frag(f + FRAG_WORDS),
                    w3 = load_frag(f + 2 * FRAG_WORDS);
        if constexpr (Src::PIECES_A == 1) {
          mma_bf16(acc[j], a, w3.x, w3.y);
          mma_bf16(acc[j], a, w2.x, w2.y);
          mma_bf16(acc[j], a, w1.x, w1.y);
        } else {
          mma_bf16(acc[j], a + 8, w1.x, w1.y);
          mma_bf16(acc[j], a + 4, w2.x, w2.y);
          mma_bf16(acc[j], a, w3.x, w3.y);
          mma_bf16(acc[j], a + 4, w1.x, w1.y);
          mma_bf16(acc[j], a, w2.x, w2.y);
          mma_bf16(acc[j], a, w1.x, w1.y);
        }
      }
    }
  }
}

// Layer L on the tensor cores, pass by pass, then bias (and ReLU below
// the last layer) into y, (env, unit) with row stride act_stride(L); y
// lies in shared memory or in the block's device-memory scratch.
template <int L, int BUDGET, typename Src>
__device__ __forceinline__ void run_mma_layer(const Src& src, uint32_t* frag, const TickArgs& a,
                                              float* y) {
  using M = Mma<L>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = (warp % MT) * 16 + (lane >> 2);
  constexpr int SY = act_stride(L);
#pragma unroll 1
  for (int p = 0; p < M::NPASS; ++p) {
    float acc[M::NTW][4];
    mma_layer<L, BUDGET>(src, frag, a.w[L], acc, p);
    __syncthreads();  // every warp is done with the source and the fragments
#pragma unroll
    for (int j = 0; j < M::NTW; ++j) {
      const int local = (warp / MT) * M::NTW + j;
      const int tile = p * M::NTP + local;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = tile * 8 + 2 * (lane & 3) + h;
        if (local < M::NTP && tile < M::NT && n < M::OUT) {
          const float bias = __ldg(a.b[L] + n);
          float v0 = acc[j][h] + bias, v1 = acc[j][2 + h] + bias;
          if (L < NL - 1) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          y[e * SY + n] = v0;
          y[(e + 8) * SY + n] = v1;
        }
      }
    }
  }
  __syncthreads();
}

// The last layer (NUM_ACTIONS outputs) of env el from its activations x
// on the CUDA cores: each of its TPE threads sums a TPE-th of the inputs,
// the env's lanes add up; returns the lowest-index argmax of the Q-values.
//
// Its weight and bias pointers are read from the block's shared `meta`
// words: loaded from the parameters at the start, they would be held in
// registers across the tensor-core layers, which need all 64 a thread.
template <int L>
__device__ __forceinline__ int output_layer(const float* x, const void* meta, int el, int sub) {
  constexpr int IN = DIMS[L], OUT = DIMS[L + 1];
  constexpr int IPT = (IN + TPE - 1) / TPE;
  const float* const* ptrs = reinterpret_cast<const float* const*>(meta);
  const float* __restrict__ w = ptrs[1];
  const float* __restrict__ bias = ptrs[2];
  const float* xr = x + el * act_stride(L - 1);
  float q[OUT];
#pragma unroll
  for (int o = 0; o < OUT; ++o) q[o] = 0.0f;
#pragma unroll 8
  for (int ii = 0; ii < IPT; ++ii) {
    const int i = sub * IPT + ii;
    if (i < IN) {
      const float xv = xr[i];
#pragma unroll
      for (int o = 0; o < OUT; ++o) q[o] = fmaf(__ldg(w + i * OUT + o), xv, q[o]);
    }
  }
  int best = 0;
  float top = 0.0f;
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    q[o] += __shfl_xor_sync(warp::FULL, q[o], 1);
    q[o] += __shfl_xor_sync(warp::FULL, q[o], 2);
    q[o] += __shfl_xor_sync(warp::FULL, q[o], 4);
    q[o] += __ldg(bias + o);
    if (o == 0 || q[o] > top) {
      top = q[o];
      best = o;
    }
  }
  return best;
}

// Hidden layers L.. on the tensor cores from x into y, then the output
// layer on the CUDA cores; returns thread (el, sub)'s env's greedy action.
template <int L, int BUDGET>
__device__ __forceinline__ int layers_from(float* x, float* y, uint32_t* frag, const TickArgs& a,
                                           const void* meta, int el, int sub) {
  if constexpr (L == NL - 1) {
    return output_layer<L>(x, meta, el, sub);
  } else {
    run_mma_layer<L, BUDGET>(ActSource<DIMS[L], act_stride(L - 1)>{x}, frag, a, y);
    return layers_from<(L + 1 < NL ? L + 1 : L), BUDGET>(y, x, frag, a, meta, el, sub);
  }
}

// The greedy action of every env of the block, into the action tile's
// drone-0 row where the env is greedy.
template <typename T>
__device__ __forceinline__ void actor(const TickArgs& a, T* tile, unsigned char* smem,
                                      int32_t* s_act, const int8_t* s_greedy, int ne) {
  using Lay = Layout<T>;
  uint32_t* frag = reinterpret_cast<uint32_t*>(smem + Lay::OFF_W);
  float* ha;
  if constexpr (Lay::ACT_GLOBAL) {
    ha = a.scratch + (size_t)blockIdx.x * (Lay::SCRATCH / 4);
  } else {
    ha = reinterpret_cast<float*>(smem + Lay::OFF_HA);
  }
  float* hb = ha + Lay::HA / 4;
  const void* meta = smem + Lay::OFF_META;
  if constexpr (Lay::OBS_GLOBAL) {
    const T* obs = static_cast<const T*>(a.obs_in) + a.read_col + blockIdx.x * EB;
    run_mma_layer<0, Lay::W_BUDGET>(GmemObsSource<T>{obs, a.in_ld, ne}, frag, a, ha);
  } else {
    run_mma_layer<0, Lay::W_BUDGET>(ObsSource<T>{tile}, frag, a, ha);
  }
  const int el = threadIdx.x / TPE, sub = threadIdx.x % TPE;
  int best = 0;
  if constexpr (NL == 1) {
    float top = 0.0f;
#pragma unroll
    for (int o = 0; o < NUM_ACTIONS; ++o) {
      const float q = ha[el * act_stride(0) + o];
      if (o == 0 || q > top) {
        top = q;
        best = o;
      }
    }
  } else {
    best = layers_from<1, Lay::W_BUDGET>(ha, hb, frag, a, meta, el, sub);
  }
  if (sub == 0 && el < ne && s_greedy[el]) s_act[el] = best;
}

// ---------------------------------------------------------------------------
// B3's StreamReplay push
//
// The block's input columns are read from obs_in after the actor, not
// stored from the staged tile before it: the actor's activations overwrite
// the tile, and a push from it, like scalar stores made drone by drone,
// took registers that the widest nets' actor needs (ptxas spilled at
// (128, 64)). Nothing writes obs_in's columns before the observation
// pass, which follows the step's barrier.

// Row r of drone d's row group of the block's input columns to row r of
// the replay at column start + d E + e0 (16-byte chunks where aligned).
__device__ __forceinline__ void push_observations(const TickArgs& a, int start, int e0, int ne) {
  const float* in = static_cast<const float*>(a.obs_in) + a.read_col + e0;
  float* out = a.push_obs + start + e0;
  constexpr int N4 = EB / 4;
  const bool vec = ne == EB && ((start | a.num_envs | (int)a.in_ld | (int)a.read_col) & 3) == 0 &&
                   (a.push_ld & 3) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < COLLECT * OBS * N4; i += BLOCK) {
      const int c = (i % N4) * 4, dr = i / N4;
      const int d = dr / OBS, r = dr - d * OBS;
      *reinterpret_cast<float4*>(out + r * a.push_ld + (long long)d * a.num_envs + c) =
          __ldcs(reinterpret_cast<const float4*>(in + dr * a.in_ld + c));
    }
  } else {
    for (int i = threadIdx.x; i < COLLECT * OBS * ne; i += BLOCK) {
      const int c = i % ne, dr = i / ne;
      const int d = dr / OBS, r = dr - d * OBS;
      out[r * a.push_ld + (long long)d * a.num_envs + c] = in[dr * a.in_ld + c];
    }
  }
}

// Drone d's action, reward and done of the block's env e into the replay's
// scalar leaves at column start + d E + e0 + e.
__device__ __forceinline__ void push_scalars(const TickArgs& a, const int32_t* s_act,
                                             const float* s_reward, const int8_t* s_done,
                                             int start, int e0, int ne) {
  for (int i = threadIdx.x; i < COLLECT * ne; i += BLOCK) {
    const int d = i / ne, e = i - d * ne;
    const long long col = (long long)start + (long long)d * a.num_envs + e0 + e;
    a.push_actions[col] = s_act[d * EB + e];
    a.push_rewards[col] = s_reward[d * EB + e];
    a.push_dones[col] = s_done[d * EB + e];
  }
}

// ---------------------------------------------------------------------------
// The tick

template <typename T>
__global__ void __launch_bounds__(BLOCK, Layout<T>::MIN_BLOCKS)
    full_tick_kernel(const TickArgs a) {
  using Lay = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  int8_t* s_board = reinterpret_cast<int8_t*>(smem + Lay::OFF_BOARD);
  int32_t* s_x = reinterpret_cast<int32_t*>(smem + Lay::OFF_X);
  int32_t* s_y = reinterpret_cast<int32_t*>(smem + Lay::OFF_Y);
  float* s_charge = reinterpret_cast<float*>(smem + Lay::OFF_CHARGE);
  float* s_reward = reinterpret_cast<float*>(smem + Lay::OFF_REWARD);
  int32_t* s_act = reinterpret_cast<int32_t*>(smem + Lay::OFF_ACTION);
  uint32_t* s_keys = reinterpret_cast<uint32_t*>(smem + Lay::OFF_KEYS);
  int8_t* s_carry = reinterpret_cast<int8_t*>(smem + Lay::OFF_CARRY);
  int8_t* s_done = reinterpret_cast<int8_t*>(smem + Lay::OFF_DONE);
  int8_t* s_greedy = reinterpret_cast<int8_t*>(smem + Lay::OFF_GREEDY);
  int* s_meta = reinterpret_cast<int*>(smem + Lay::OFF_META);
  const float** s_last = reinterpret_cast<const float**>(smem + Lay::OFF_META);

  const int E = a.num_envs;
  const int e0 = blockIdx.x * EB;
  const int ne = cmini(EB, E - e0);
  const Key step_key{__ldg(a.key), __ldg(a.key + 1)};

  // --- stage the env state (in flight while the keys are hashed) ----------
  Tile::template stage_rows<int8_t, EB>(s_board, a.ground_in, E, e0, C, ne);
  Tile::template stage_rows<int32_t, EB>(s_x, a.ax_in, E, e0, N, ne);
  Tile::template stage_rows<int32_t, EB>(s_y, a.ay_in, E, e0, N, ne);
  Tile::template stage_rows<int8_t, EB>(s_carry, a.carry_in, E, e0, N, ne);
  Tile::template stage_rows<float, EB>(s_charge, a.charge_in, E, e0, N, ne);

  // --- keys: rows of split(step_key, E + 2), one thread an (env, role) ----
  bool greedy = false;
  {
    const int el = threadIdx.x % EB, role = threadIdx.x / EB;
    const int e = e0 + el;
    if (el < ne && role == 0) {
      const Key env_key = split_row(step_key, (uint32_t)e);
      const Key nk = split_row(env_key, 0u);
      const Key ground_key = split_row(env_key, 1u);
      const Key air_key = split_row(nk, 1u);
      s_keys[0 * EB + el] = ground_key.k0;
      s_keys[1 * EB + el] = ground_key.k1;
      s_keys[2 * EB + el] = air_key.k0;
      s_keys[3 * EB + el] = air_key.k1;
    } else if (el < ne && role == 1) {
      // Row 0 of the epsilon-greedy actor's (N + 1, E) uniform field.
      const Key actor_key = split_row(step_key, (uint32_t)E);
      const float u0 = bits_to_unit_float(uniform_bits<ACTOR_ROUNDS>(actor_key, (uint32_t)e));
      greedy = !(u0 < __ldg(a.eps));
      s_greedy[el] = greedy ? 1 : 0;
    } else if (el < ne && role >= 3) {
      // Rows 1..N: the drones' random actions, spread over the other roles.
      const Key actor_key = split_row(step_key, (uint32_t)E);
#pragma unroll 1
      for (int i = role - 3; i < N; i += BLOCK / EB - 3) {
        const float u =
            bits_to_unit_float(uniform_bits<ACTOR_ROUNDS>(actor_key, (uint32_t)((i + 1) * E + e)));
        const int v = (int)floorf(u * (float)NUM_ACTIONS);
        s_act[i * EB + el] = v < 0 ? 0 : (v > NUM_ACTIONS - 1 ? NUM_ACTIONS - 1 : v);
      }
    } else if (el < ne && role == 2 && a.do_reset) {
      // core.reset with row e of split(S[E + 1], E): five placement keys.
      Key k = split_row(split_row(step_key, (uint32_t)(E + 1)), (uint32_t)e);
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const Key p = split_row(k, 1u);
        k = split_row(k, 0u);
        s_keys[(4 + 2 * s) * EB + el] = p.k0;
        s_keys[(5 + 2 * s) * EB + el] = p.k1;
      }
    }
  }
  if (threadIdx.x == 0) {
    s_meta[0] = ne;
    // The push's start slot, -1 without a push: read back from shared
    // memory where it is used, as ne, not held in registers across the
    // actor.
    if constexpr (sizeof(T) == 4) s_meta[1] = a.push_obs != nullptr ? __ldg(a.push_start) : -1;
    s_last[1] = a.w[NL - 1];
    s_last[2] = a.b[NL - 1];
  }
  const bool any_greedy = __syncthreads_or(greedy);

  // --- the actor ----------------------------------------------------------
  if (any_greedy) {
    if constexpr (!Lay::OBS_GLOBAL) {
      using Raw = typename std::conditional<sizeof(T) == 2, uint16_t, float>::type;
      Raw* raw = reinterpret_cast<Raw*>(tile);
      Tile::template stage_rows<Raw, Lay::S>(raw, static_cast<const Raw*>(a.obs_in), a.in_ld,
                                             a.read_col + e0, OBS, ne);
      for (int i = threadIdx.x; i < (up16(OBS) - OBS) * Lay::S; i += BLOCK) {
        raw[OBS * Lay::S + i] = Raw(0);
      }
      cp_async_wait_all();
      __syncthreads();
    }
    actor<T>(a, tile, smem, s_act, s_greedy, ne);
  }
  cp_async_wait_all();
  __syncthreads();
  // Read back rather than kept in registers across the actor, which needs
  // all 64 a thread at the widest nets.
  const int ne_b = s_meta[0];

  // --- B3's push of the input observations (B1 never pushes) ----------------
  if constexpr (sizeof(T) == 4) {
    const int start = s_meta[1];
    if (start >= 0) push_observations(a, start, blockIdx.x * EB, ne_b);
  }

  // --- step and reset: one warp an env --------------------------------------
  const int warp_id = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Rewards rw{a.pickup_reward, a.delivery_reward, a.crash_reward, a.charge_reward};
#pragma unroll 1
  for (int el = warp_id; el < ne_b; el += WARPS) {
    int g0[warp::KC], g[warp::KC];
#pragma unroll
    for (int k = 0; k < warp::KC; ++k) {
      const int c = warp::cell_of(k);
      g0[k] = g[k] = c < C ? s_board[c * EB + el] : EMPTY;
    }
    // One drone slot a lane (N <= 32).
    warp::Drone d[1] = {{0, 0, false, 100.0f}};
    int act[1] = {STAY};
    if (lane < N) {
      d[0] = warp::Drone{s_x[lane * EB + el], s_y[lane * EB + el], s_carry[lane * EB + el] != 0,
                         s_charge[lane * EB + el]};
      act[0] = s_act[lane * EB + el];
    }
    const Key ground_key{s_keys[0 * EB + el], s_keys[1 * EB + el]};
    const Key air_key{s_keys[2 * EB + el], s_keys[3 * EB + el]};
    uint32_t u[warp::KC], ua[warp::KC];
    float reward[1];
    bool done[1];
    warp::step_env(
        ground_key, air_key, act, s_board + el, EB, [&](int k) { return g0[k] == SKYSCRAPER; },
        g, d, reward, done, rw, u, ua);
    if (lane < N) {
      s_reward[lane * EB + el] = reward[0];
      s_done[lane * EB + el] = done[0] ? 1 : 0;
    }
    if (a.do_reset) {
      Key placement[5];
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        placement[s] = Key{s_keys[(4 + 2 * s) * EB + el], s_keys[(5 + 2 * s) * EB + el]};
      }
      warp::reset_env(placement, g, d, u);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < warp::KC; ++k) {
      const int c = warp::cell_of(k);
      if (c < C) s_board[c * EB + el] = (int8_t)g[k];
    }
    if (lane < N) {
      s_x[lane * EB + el] = d[0].x;
      s_y[lane * EB + el] = d[0].y;
      s_carry[lane * EB + el] = d[0].carrying ? 1 : 0;
      s_charge[lane * EB + el] = d[0].charge;
    }
  }
  __syncthreads();

  // --- the next observation: a (position, env) item a thread ---------------
  // Drone i's observation goes to rows [i OBS, (i + 1) OBS) of the output
  // column. Drone 0's, and the global view (the same for every drone), is
  // made once in the one-observation tile and stored with coalesced 16-byte
  // stores, COLLECT times for the global view; the windows of drones 1 ..
  // COLLECT - 1 go from the observation pass straight to obs_out, which
  // measured 1-3.5% faster than a pass through the tile each
  // (scripts/torch_tick_compare.py). The actor has read every input column
  // of the block (the barrier above), and no other block's column is
  // written, so every row group may go out at once.
  const int col0 = blockIdx.x * EB;
  using Raw = typename std::conditional<sizeof(T) == 2, uint16_t, float>::type;
#pragma unroll 1
  for (int i = 0; i < COLLECT; ++i) {
    const long long rows = (long long)i * OBS * a.out_ld;  // drone i's row group
    if (Lay::OBS_GLOBAL || (!GLOBAL && i > 0)) {
      // Straight to obs_out.
      warp::observe_tile<EB, BLOCK>(i, static_cast<T*>(a.obs_out) + rows + a.write_col + col0,
                                    a.out_ld, s_board, s_x, s_y, s_carry, s_charge, ne_b);
    } else {
      if (i == 0) {
        warp::observe_tile<EB, BLOCK>(i, tile, Lay::S, s_board, s_x, s_y, s_carry, s_charge);
        __syncthreads();
      }
      Tile::template store_rows<Raw, Lay::S>(static_cast<Raw*>(a.obs_out) + rows,
                                             reinterpret_cast<const Raw*>(tile), a.out_ld,
                                             a.write_col + col0, OBS, ne_b);
    }
  }

  // --- store the state and the outputs --------------------------------------
  Tile::template store_rows<int8_t, EB>(a.ground_out, s_board, a.num_envs, col0, C, ne_b);
  Tile::template store_rows<int32_t, EB>(a.ax_out, s_x, a.num_envs, col0, N, ne_b);
  Tile::template store_rows<int32_t, EB>(a.ay_out, s_y, a.num_envs, col0, N, ne_b);
  Tile::template store_rows<int8_t, EB>(a.carry_out, s_carry, a.num_envs, col0, N, ne_b);
  Tile::template store_rows<float, EB>(a.charge_out, s_charge, a.num_envs, col0, N, ne_b);
  Tile::template store_rows<float, EB>(a.rewards, s_reward, a.num_envs, col0, N, ne_b);
  Tile::template store_rows<int8_t, EB>(a.dones, s_done, a.num_envs, col0, N, ne_b);
  Tile::template store_rows<int32_t, EB>(a.actions, s_act, a.num_envs, col0, N, ne_b);
  if constexpr (sizeof(T) == 4) {
    const int start_b = s_meta[1];
    if (start_b >= 0) push_scalars(a, s_act, s_reward, s_done, start_b, col0, ne_b);
  }
}

// Internal linkage: a static local of a template with external linkage is
// one process-wide (GNU unique) object, shared by every library built from
// this source, so a second net's library would never set its limit.
namespace {

template <typename T>
cudaError_t configure() {
  static const cudaError_t err = cudaFuncSetAttribute(
      full_tick_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<T>::TOTAL);
  return err;
}

}  // namespace

template <typename T>
int launch_t(const TickArgs* args, cudaStream_t s) {
  if (Layout<T>::ACT_GLOBAL && args->scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = configure<T>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((args->num_envs + EB - 1) / EB);
  full_tick_kernel<T><<<grid, BLOCK, Layout<T>::TOTAL, s>>>(*args);
  return (int)cudaGetLastError();
}

int launch(const TickArgs* args, void* stream) {
  if (args->num_envs <= 0 || args->key == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return args->obs_bf16 ? launch_t<__nv_bfloat16>(args, s) : launch_t<float>(args, s);
}

template <typename T>
int blocks_per_sm() {
  int n = 0;
  if (configure<T>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, full_tick_kernel<T>, BLOCK,
                                                    Layout<T>::TOTAL) != cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace dronerl

// B1: the replay ring is both obs_in and obs_out; no push.
extern "C" int full_tick_ring_launch(const dronerl::TickArgs* args, void* stream) {
  if (args->push_obs != nullptr) return (int)cudaErrorInvalidValue;
  return dronerl::launch(args, stream);
}

// B3: obs_t in (f32), obs_t' out into a new array or over obs_t; with
// push_obs, the push into the StreamReplay.
extern "C" int full_tick_launch(const dronerl::TickArgs* args, void* stream) {
  if (args->obs_bf16) return (int)cudaErrorInvalidValue;
  if (args->push_obs != nullptr &&
      (args->push_actions == nullptr || args->push_rewards == nullptr ||
       args->push_dones == nullptr || args->push_start == nullptr || args->push_ld <= 0)) {
    return (int)cudaErrorInvalidValue;
  }
  return dronerl::launch(args, stream);
}

extern "C" const char* full_tick_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch's dynamic shared memory in bytes, for bf16 or f32 observations.
extern "C" int full_tick_smem_bytes(int bf16) {
  return bf16 ? dronerl::Layout<__nv_bfloat16>::TOTAL : dronerl::Layout<float>::TOTAL;
}

// The device-memory scratch a block needs for its activations in bytes (0:
// they are in shared memory), for bf16 or f32 observations.
extern "C" int full_tick_scratch_bytes(int bf16) {
  return bf16 ? dronerl::Layout<__nv_bfloat16>::SCRATCH : dronerl::Layout<float>::SCRATCH;
}

// Resident blocks an SM (the occupancy query), for bf16 or f32 observations.
extern "C" int full_tick_blocks_per_sm(int bf16) {
  return bf16 ? dronerl::blocks_per_sm<__nv_bfloat16>() : dronerl::blocks_per_sm<float>();
}
