// The training tick's jax.random draws, and the ring engine's replay
// sample, as one launch each.
//
// This source replaces no Pallas kernel. In the JAX package these draws are
// jax.random calls outside the kernels (split, random bits, uniform,
// randint), each a threefry2x32 hash that jax._src.prng lowers to
// elementwise uint32 arithmetic and that XLA fuses, under jit, into one
// kernel with what surrounds it. Its counterpart in the port was rng.py's
// plain versions: the same words as int64 tensor ops, about 7 launches a
// round, ~150 a hash and ~377 a randint. Each draw of a CUDA key is now
// one launch of draw_launch:
//
// * K keys (int64 words in [0, 2^32), row stride key_stride elements,
//   read by pointer) x n counters, in jax's partitionable layout:
//   counter i is hashed as the word pair (0, i).
// * split writes (K, n, 2) int64 words, bits (K, n) int64 b1 ^ b2,
//   uniform (K, n) f32 bitcast((bits >> 9) | 0x3f800000) - 1, randint
//   (K, n) int32 by jax's _randint: the key's two split children hashed in
//   the thread, (hi % span) * mult + lo % span in wrapping uint32,
//   mult = (2^16 % span)^2 % span. The bound is a host int (span given)
//   or a 0-d int32/int64 device word read by pointer, so that a CUDA graph
//   picks up each tick's bound.
// * The round count (4, 8, 12, 16, 20: threefry.cuh's template) is chosen
//   at run time, so one library serves every engine and --fast_rng mode.
//
// ring_sample_launch does what ops/fused_tick.py's ring_gather_batch_plain
// does, the ring engine's replay sample: draws the B offsets from the
// sample key with the randint arithmetic above (or reads the offsets the
// host drew, an eager tick's), forms phys = (base_slot + raw) % capacity
// and the next observation's column (phys + num_envs) % capacity, gathers
// the ring's obs_dim rows at both columns into one f32 (obs_dim, 2B) array
// (obs, then next_obs) and the scalar rings (int8 dones as f32). With
// collect = k, column c belongs to drone c / (B / k): its rows are that
// drone's row group and its scalars that drone's ring. Two more modes of
// the same launch serve the replay engines' buffers (ops/draws.py):
//
// * the StreamReplay's sample (replay.py): the ring is the f32 (obs_dim,
//   capacity) store, num_envs its stride, and the draw's bound and the
//   base slot may be device words read by pointer (a chunk's row), the
//   span then max(bound, 1) as jax's randint makes it;
// * the row-major ReplayBuffer's (replay.sample): whole transitions, obs
//   and next_obs (capacity, obs_dim) f32 (rows_in), the next observation
//   at the same slot of next_rows; the batch written feature-major
//   (obs_dim, 2B) for the learner kernel, or row-major (rows_out: obs then
//   next_obs, (2B, obs_dim)).
//
// What bounds them on the H100: a hash of R rounds is 3R + 3R/4 + 4
// integer operations, a split or uniform output one hash, a randint
// output two plus two a key (its split children, which the key's outputs
// share); the bytes are the outputs written (8 to 16 a split output).
// At the main path's sizes, 8 to 327,680 outputs, both bounds are below
// a microsecond and the launch itself is the cost. Design: one thread an
// output, every word in registers, nothing staged; a randint thread
// recomputes its key's two split children (two hashes) rather than
// reading them from a first launch. The ring sample is one block: threads
// draw a column each into shared memory, then the block gathers the
// columns' rows (294 x 16 values at the bench's shape). All arithmetic is
// uint32, built without --use_fast_math.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace dronerl {

enum Mode : int32_t { SPLIT = 0, BITS = 1, UNIFORM = 2, RANDINT = 3 };

// Mirror of ops/draws.py's _DrawArgs (field order matters).
struct DrawArgs {
  const int64_t* key;  // (num_keys, 2) words, rows key_stride elements apart
  const void* bound;   // randint's 0-d upper bound on the device, or null
  void* out;
  int64_t num_keys;
  int64_t count;       // counters a key
  int64_t key_stride;
  int32_t mode;
  int32_t rounds;
  int32_t bound_i64;   // the bound is int64 (else int32)
  int32_t minval;
  uint32_t span;       // randint's span where bound is null
};

// Mirror of ops/draws.py's _RingSampleArgs (field order matters).
struct RingSampleArgs {
  const void* ring;      // (collect * obs_dim, ring_ld) bf16 or f32
  const int32_t* a_ring; // (capacity,), or (collect, scalar_ld)
  const float* r_ring;
  const int8_t* d_ring;
  const int64_t* key;    // the sample key's two words, or null
  const int32_t* offsets;  // (B,) offsets drawn on the host, or null
  float* both;           // (obs_dim, 2B): obs, then next_obs
  int32_t* actions;      // (B,)
  float* rewards;        // (B,)
  float* dones;          // (B,)
  int64_t ring_ld;
  int64_t scalar_ld;
  int64_t capacity;
  int64_t base_slot;
  int64_t num_envs;
  int32_t obs_dim;
  int32_t batch;
  int32_t collect;
  uint32_t span;
  int32_t ring_bf16;
  const int32_t* bound;    // the draw's upper bound as a device word, or null (span)
  const int32_t* base;     // the first slot as a device word, or null (base_slot)
  const float* next_rows;  // rows_in: next_obs (capacity, obs_dim), row stride ring_ld
  int32_t rows_in;         // the ring is (capacity, obs_dim) rows, not columns
  int32_t rows_out;        // write (2B, obs_dim) rows, not (obs_dim, 2B)
};

constexpr int DRAW_THREADS = 256;
constexpr int64_t DRAW_MAX_BLOCKS = 132 * 64;
constexpr int SAMPLE_THREADS = 512;
constexpr int SAMPLE_COLS = 256;  // columns a pass of the ring sample

__device__ __forceinline__ Key load_key(const int64_t* words) {
  return Key{static_cast<uint32_t>(words[0]), static_cast<uint32_t>(words[1])};
}

// jax's _randint multiplier 2^32 % span, as (2^16 % span)^2 % span.
__device__ __forceinline__ uint32_t randint_multiplier(uint32_t span) {
  const uint32_t m = (1u << 16) % span;
  return (m * m) % span;
}

// The offset in [0, span) of counter i of jax.random.randint(key, ...):
// the high and low words from the key's split children 0 and 1.
template <int R>
__device__ __forceinline__ uint32_t randint_offset(Key key, uint32_t i, uint32_t span,
                                                   uint32_t mult) {
  const Key w_hi = threefry2x32<R>(threefry2x32<R>(key, 0u, 0u), 0u, i);
  const Key w_lo = threefry2x32<R>(threefry2x32<R>(key, 0u, 1u), 0u, i);
  const uint32_t hi = w_hi.k0 ^ w_hi.k1;
  const uint32_t lo = w_lo.k0 ^ w_lo.k1;
  return ((hi % span) * mult + lo % span) % span;
}

__device__ __forceinline__ uint32_t draw_span(const DrawArgs& a) {
  if (a.bound == nullptr) return a.span;
  const int64_t b = a.bound_i64 ? *static_cast<const int64_t*>(a.bound)
                                : static_cast<int64_t>(*static_cast<const int32_t*>(a.bound));
  return b > a.minval ? static_cast<uint32_t>(b - a.minval) : 1u;
}

template <int R>
__global__ void __launch_bounds__(DRAW_THREADS) draw_kernel(const DrawArgs a) {
  const int64_t total = a.num_keys * a.count;
  const uint32_t span = a.mode == RANDINT ? draw_span(a) : 1u;
  const uint32_t mult = randint_multiplier(span);
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t k = t / a.count;
    const uint32_t i = static_cast<uint32_t>(t - k * a.count);
    const Key key = load_key(a.key + k * a.key_stride);
    if (a.mode == RANDINT) {
      const uint32_t v = static_cast<uint32_t>(a.minval) + randint_offset<R>(key, i, span, mult);
      static_cast<int32_t*>(a.out)[t] = static_cast<int32_t>(v);
      continue;
    }
    const Key w = threefry2x32<R>(key, 0u, i);
    if (a.mode == SPLIT) {
      longlong2 pair;
      pair.x = static_cast<long long>(w.k0);
      pair.y = static_cast<long long>(w.k1);
      static_cast<longlong2*>(a.out)[t] = pair;
    } else if (a.mode == BITS) {
      static_cast<int64_t*>(a.out)[t] = static_cast<int64_t>(w.k0 ^ w.k1);
    } else {
      static_cast<float*>(a.out)[t] = bits_to_unit_float((w.k0 ^ w.k1) >> 9);
    }
  }
}

template <int R>
int launch_draw(const DrawArgs* a, cudaStream_t stream) {
  const int64_t total = a->num_keys * a->count;
  int64_t blocks = (total + DRAW_THREADS - 1) / DRAW_THREADS;
  if (blocks > DRAW_MAX_BLOCKS) blocks = DRAW_MAX_BLOCKS;
  draw_kernel<R><<<static_cast<unsigned>(blocks), DRAW_THREADS, 0, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// kRows: the row-major ReplayBuffer's mode (RingSampleArgs::rows_in).
template <bool kRows>
__global__ void __launch_bounds__(SAMPLE_THREADS) ring_sample_kernel(const RingSampleArgs a) {
  __shared__ int64_t s_phys[SAMPLE_COLS];
  __shared__ int64_t s_next[SAMPLE_COLS];
  __shared__ int32_t s_row0[SAMPLE_COLS];
  const int per_drone = a.batch / a.collect;
  uint32_t span = a.span;
  if (a.bound != nullptr) span = *a.bound > 0 ? static_cast<uint32_t>(*a.bound) : 1u;
  const int64_t base_slot = a.base != nullptr ? static_cast<int64_t>(*a.base) : a.base_slot;
  const uint32_t mult = randint_multiplier(span);
  Key key{0u, 0u};
  if (a.offsets == nullptr) key = load_key(a.key);
  for (int c0 = 0; c0 < a.batch; c0 += SAMPLE_COLS) {
    const int cols = min(SAMPLE_COLS, a.batch - c0);
    for (int j = threadIdx.x; j < cols; j += blockDim.x) {
      const int c = c0 + j;
      const int64_t raw = a.offsets != nullptr
                              ? static_cast<int64_t>(a.offsets[c])
                              : static_cast<int64_t>(static_cast<int32_t>(
                                    randint_offset<20>(key, static_cast<uint32_t>(c), span,
                                                       mult)));
      const int64_t phys = (base_slot + raw) % a.capacity;
      const int drone = c / per_drone;
      s_phys[j] = phys;
      s_next[j] = kRows ? phys : (phys + a.num_envs) % a.capacity;
      s_row0[j] = drone * a.obs_dim;
      const int64_t at = drone * a.scalar_ld + phys;
      a.actions[c] = a.a_ring[at];
      a.rewards[c] = a.r_ring[at];
      a.dones[c] = static_cast<float>(a.d_ring[at]);
    }
    __syncthreads();
    // Value (row r, column j) of the 2 cols gathered: obs at j < cols,
    // next_obs beyond. From a ring of columns the loads and stores of
    // neighbouring threads land on neighbouring columns (r outer); from
    // rows on neighbouring features of a slot (j outer).
    const int64_t values = static_cast<int64_t>(a.obs_dim) * 2 * cols;
    for (int64_t e = threadIdx.x; e < values; e += blockDim.x) {
      const int r = static_cast<int>(kRows ? e % a.obs_dim : e / (2 * cols));
      const int j = static_cast<int>(kRows ? e / a.obs_dim
                                           : e - static_cast<int64_t>(r) * 2 * cols);
      const bool next = j >= cols;
      const int jc = next ? j - cols : j;
      const int64_t col = (next ? a.batch : 0) + c0 + jc;
      if constexpr (kRows) {
        const float* rows = next ? a.next_rows : static_cast<const float*>(a.ring);
        const float v = rows[(next ? s_next[jc] : s_phys[jc]) * a.ring_ld + r];
        a.both[a.rows_out ? col * a.obs_dim + r : static_cast<int64_t>(r) * 2 * a.batch + col] = v;
      } else {
        const int64_t src = static_cast<int64_t>(s_row0[jc] + r) * a.ring_ld +
                            (next ? s_next[jc] : s_phys[jc]);
        const float v = a.ring_bf16
                            ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.ring)[src])
                            : static_cast<const float*>(a.ring)[src];
        a.both[static_cast<int64_t>(r) * 2 * a.batch + col] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace dronerl

extern "C" int draw_launch(const dronerl::DrawArgs* args, void* stream) {
  using namespace dronerl;
  if (args->num_keys <= 0 || args->count <= 0 || args->count > (int64_t{1} << 32) ||
      args->mode < SPLIT || args->mode > RANDINT || args->span == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (args->rounds) {
    case 4: return launch_draw<4>(args, s);
    case 8: return launch_draw<8>(args, s);
    case 12: return launch_draw<12>(args, s);
    case 16: return launch_draw<16>(args, s);
    case 20: return launch_draw<20>(args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int ring_sample_launch(const dronerl::RingSampleArgs* args, void* stream) {
  using namespace dronerl;
  if (args->batch <= 0 || args->collect <= 0 || args->batch % args->collect != 0 ||
      args->capacity <= 0 || args->span == 0 || args->obs_dim <= 0 ||
      (args->key == nullptr && args->offsets == nullptr) ||
      (args->rows_in && (args->next_rows == nullptr || args->collect != 1 || args->ring_bf16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->rows_in) {
    ring_sample_kernel<true><<<1, SAMPLE_THREADS, 0, s>>>(*args);
  } else {
    ring_sample_kernel<false><<<1, SAMPLE_THREADS, 0, s>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty launch of the draw kernel's block shape: the floor a launch
// costs, which a timing sets beside the draws' times.
__global__ void draws_empty_kernel() {}

extern "C" int draws_empty_launch(void* stream) {
  draws_empty_kernel<<<1, dronerl::DRAW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* draws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
