// The DQN learner's TD(0) + Adam step for a dense Q-net, in one launch of
// one thread-block cluster.
//
// Replaces two TPU kernels that compute the same update:
//  * the TD branch of dronerl_tpu/ops/fused_tick.py::_full_kernel (the
//    td_hparams launch, :893-989), which rides grid step 0 of the ring tick
//    and is gated by can_train;
//  * dronerl_tpu/ops/learner_kernel.py::_learner_kernel (:44-150), which
//    adds a hard or EMA target sync and the epsilon decay, each under a flag.
// One kernel with three flags (learn, sync, decay) serves both. On the
// trainers' default path (learn alone, on the batch gathered in the same
// tick) it also stands for the learner that XLA fuses outside the Pallas
// kernels (dronerl_tpu/train.py:533-541, agents/dqn.py:295 train_step_t).
//
// What it computes, on a feature-major batch (x, xn: (D, B)):
//   the online forward with every activation kept, the target forward on xn,
//   taken = q[a_b, b], tgt = r + gamma * max_j q'[j, b] * (1 - d),
//   delta = taken - tgt, loss = sum_b delta^2 * (1/B),
//   gout = onehot(a) * (delta * (2/B)), dW = a_prev gout^T, db = sum_b gout,
//   gin = (W gout) * (a_prev > 0), then Adam with cf = count + 1 and
//   bc = 1 - exp(cf * log(beta)):
//     m = b1 m + (1-b1) g;  v = b2 v + ((1-b2) g) g;
//     p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps)),
//   the target sync t = tau * p_eff + (1 - tau) * t with p_eff the updated
//   params when learning and the input params otherwise, and
//   eps = max(eps * decay, end). A flag that is off writes nothing; with
//   learn off the loss is -1 (the no-train sentinel).
//
// What bounds it on the H100: not the card's rates. A step moves about seven
// floats per parameter (P = 5,077 for the (16,16) net, 46,341 for (128,64):
// 0.16-1.3 MB, 0.05-0.4 us at 3.35 TB/s) and does about 3 MFLOP (0.05 us).
// What it costs is a launch plus the serial depth of the passes: the two
// forwards, the backward and the update, each a chain of dependent steps.
//
// Design: one cluster of CLUSTER CTAs (16, with the non-portable opt-in;
// 8 is the portable size and measured slower) on as many SMs, launched
// with cudaLaunchKernelEx and a cluster attribute.
//  * Ownership. CTA r owns a slice of every layer's output units: those
//    columns of W and b and the same slices of the target, mu and nu
//    (own_lo; widths that 4*CLUSTER divides are cut in equal
//    16-byte aligned slices, others unevenly, one unit apart, so that the 5
//    actions go to ranks 0-4). A CTA reads only its own columns, in the
//    forwards and in its share of the backward, and then writes only those
//    columns: the in-place update needs no grid-wide barrier.
//  * Staging. At the start each CTA copies its slices of W, b, target, mu
//    and nu, and the batch (x and xn), into shared memory with cp.async
//    (16-byte chunks where the slice allows, else 4-byte); mu and nu are a
//    second group, waited for only before the update pass. The forwards,
//    the backward and the update then read shared memory; the update pass
//    only stores to device memory. A batch too large to stage beside the
//    rest (the per-CTA arithmetic of layout()) is read from device memory,
//    and so are the params of a net too wide to stage (PS).
//  * Batch tiles. The activation, gradient and exchange rows hold one tile
//    of batch columns. When the whole batch does not fit, the passes run
//    tile after tile (the widest even split that fits, plan()), and each
//    owned element's gradient is carried from tile to tile in an
//    accumulator in shared memory; one cluster barrier between tiles.
//  * The two forwards run together, layer by layer: each CTA computes its
//    output units of the online and the target net, the first layer split
//    along its input (split-K, segments of at most MAX_CHAIN inputs, summed
//    in order in shared memory), and stores them into every CTA's
//    activation rows through distributed shared memory; one cluster
//    barrier a layer.
//  * The TD error, its gradient at q and the loss are computed on every CTA
//    from the full q and q' (the loss on rank 0), with the __fmul_rn /
//    __fadd_rn formulas of the one-block kernel.
//  * Backward: CTA r's partial input gradient W_L[:, own] g_out[own] goes,
//    row by row, into the receive buffer of the CTA that owns that row of
//    layer L-1 (distributed shared memory, one slot per sender, two buffers
//    by layer parity); after a cluster barrier the owner sums the slots in
//    rank order and masks by the ReLU. One cluster barrier a hidden layer.
//  * Update: each owned element's gradient is recomputed from the saved
//    activations (B multiply-adds, in batch order), then Adam and the sync
//    as in the one-block kernel, read from shared memory, stored to device
//    memory coalesced along the owned columns.
// The last cluster barrier comes before any CTA stops touching another's
// shared memory, so a CTA may exit as soon as its update is done.
//
// Numerics: build without --use_fast_math (IEEE divides and roots, expf
// and logf). The TD target, the loss and the whole elementwise pass use
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, so that nvcc does not
// contract a*b+c into one FMA: the plain PyTorch version rounds every
// product and sum on its own, and from the same gradient the kernel then
// writes the same bits. The dot products (forwards, backward, gradients)
// sum in another order than cuBLAS in any case. Unlike the TPU kernels,
// which sum them in f32, they accumulate in double precision (dot_t:
// split-K partials, receive slots and gradient accumulators included) and
// round once to f32, so that each is its exact sum rounded and the
// kernel's distance to the plain version is the plain version's own
// rounding. Adam's early steps turn a small gradient's relative error into
// an error of order lr: summed in f32 in the split-K order, one weight of
// 46,341 at one tick of the (128,64) check landed beyond the learner
// tolerance. The cost of the doubles is measured against an f32 build by
// scripts/torch_learner_compare.py.
//
// The net widths are compile-time constants (-D, see ops/_build.py); the
// batch size, the hyperparameters and the flags are launch arguments from
// the host, as the TPU kernels take them by scalar prefetch; the Adam count
// is read from device memory (a CUDA graph's replays of one launch take
// each tick's count from a buffer the host fills before the chunk).

#include <cooperative_groups.h>

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

#if !defined(DR_NLAYERS) || !defined(DR_DIM0)
#error "build through dronerl_tpu_torch/ops/_build.py (it passes the -D set)"
#endif

namespace cg = cooperative_groups;

namespace dronerl_td {

constexpr int MAX_LAYERS = 8;
constexpr int DIMS[MAX_LAYERS + 1] = {DR_DIM0, DR_DIM1, DR_DIM2, DR_DIM3, DR_DIM4,
                                      DR_DIM5, DR_DIM6, DR_DIM7, DR_DIM8};
constexpr int NL = DR_NLAYERS;
constexpr int D = DIMS[0];
constexpr int NUM_ACTIONS = 5;
constexpr int CLUSTER = 16;  // CTAs of the cluster
constexpr int THREADS = 512;
constexpr int MAX_BATCH = 256;
constexpr int MAX_CHAIN = 40;  // the longest dependent FMA chain of a forward
constexpr long long SMEM_OPTIN = 232448;  // what one CTA may opt in to on sm_90

static_assert(NL >= 1 && NL <= MAX_LAYERS, "1..8 dense layers");
static_assert(DIMS[NL] == NUM_ACTIONS, "the last width is the action count");
static_assert(CLUSTER >= 1 && CLUSTER <= 16, "a cluster holds at most 16 CTAs");

using dot_t = double;  // the dot products' accumulator (see Numerics)
constexpr int DOT_FLOATS = sizeof(dot_t) / 4;

__device__ __forceinline__ double dot_fma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float dot_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ float to_f32(double v) { return __double2float_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// The split of a layer's `w` output units over the cluster: rank r owns
// [own_lo(w, r), own_lo(w, r + 1)). Widths that 4 * CLUSTER divides go in
// equal slices of whole 16-byte chunks; others unit by unit, the first
// w % CLUSTER ranks one unit more (mirrored by learner_kernel.cluster_split).
__host__ __device__ constexpr int own_unit(int w) { return w % (4 * CLUSTER) == 0 ? 4 : 1; }
__host__ __device__ constexpr int own_lo(int w, int r) {
  const int u = own_unit(w), per = w / u / CLUSTER, extra = w / u % CLUSTER;
  return u * (r * per + (r < extra ? r : extra));
}
__host__ __device__ constexpr int own_n(int w, int r) { return own_lo(w, r + 1) - own_lo(w, r); }
__host__ __device__ constexpr int own_max(int w) { return own_n(w, 0); }
// The rank that owns unit i of a layer of w units.
__host__ __device__ constexpr int owner_of(int w, int i) {
  const int u = own_unit(w), per = w / u / CLUSTER, extra = w / u % CLUSTER;
  const int g = i / u, wide = extra * (per + 1);  // units of the ranks with one more
  return g < wide ? g / (per + 1) : extra + (g - wide) / per;
}

// Layer L's compile-time geometry: widths, the largest owned slice, the
// split-K segments of its forward, and its staged block in shared memory
// (kernel slices of W, target, mu, nu, row stride NMAX, then their bias
// slices, each array rounded up to whole 16-byte chunks).
template <int L>
struct Geo {
  static constexpr int IN = DIMS[L], OUT = DIMS[L + 1];
  static constexpr int NMAX = own_max(OUT);
  static constexpr bool VEC = own_unit(OUT) == 4;
  static constexpr int SEGS = (IN + MAX_CHAIN - 1) / MAX_CHAIN;
  static constexpr int SEG = (IN + SEGS - 1) / SEGS;
  static constexpr int WSLICE = round4(IN * NMAX);
  static constexpr int BSLICE = round4(NMAX);
  static constexpr int BLOCK = 4 * (WSLICE + BSLICE);
};

// Running sums and maxima over layers [0, L), as template constants so that
// device code reads DIMS only at compile time.
template <int L>
struct Acc {
  using Prev = Acc<L - 1>;
  using G = Geo<L - 1>;
  static constexpr int out_row = Prev::out_row + G::OUT;   // activation rows
  static constexpr int g_row = Prev::g_row + G::NMAX;      // own gradient rows
  static constexpr int w_off = Prev::w_off + G::BLOCK;     // staged floats
  static constexpr int p_rows = cmax(Prev::p_rows, G::SEGS * 2 * G::NMAX);
  static constexpr int r_rows = cmax(Prev::r_rows, G::NMAX);
  // gradient accumulators (dot_t): the kernel slice, row stride NMAX, then the bias slice
  static constexpr int acc_off = Prev::acc_off + (G::IN + 1) * G::NMAX;
};
template <>
struct Acc<0> {
  static constexpr int out_row = 0, g_row = 0, w_off = 0, p_rows = 0, r_rows = 0, acc_off = 0;
};
constexpr int OUT_ROWS = Acc<NL>::out_row;
constexpr int Q_ROW = Acc<NL - 1>::out_row;
constexpr int G_ROWS = Acc<NL>::g_row;
constexpr int W_TOTAL = Acc<NL>::w_off;
constexpr int P_ROWS = Acc<NL>::p_rows;
constexpr int R_ROWS = Acc<NL - 1>::r_rows;  // rows a rank receives: layers 0..NL-2
constexpr int ACC_FLOATS = round4(DOT_FLOATS * Acc<NL>::acc_off);

// Mirrors _LearnArgs in ops/learner_kernel.py field by field.
struct LearnArgs {
  const float* x;
  const float* xn;
  long long x_ld;
  long long xn_ld;
  const int32_t* actions;
  const float* rewards;
  const float* dones;
  float* w[MAX_LAYERS];
  float* b[MAX_LAYERS];
  float* tw[MAX_LAYERS];
  float* tb[MAX_LAYERS];
  float* mw[MAX_LAYERS];
  float* mb[MAX_LAYERS];
  float* vw[MAX_LAYERS];
  float* vb[MAX_LAYERS];
  float* loss;
  float* eps;
  const int32_t* count;  // the Adam count before the step, in device memory
  int batch;
  int learn;
  int sync;
  int decay;
  float gamma;
  float lr;
  float b1;
  float b2;
  float one_minus_b1;
  float one_minus_b2;
  float adam_eps;
  float tau;
  float one_minus_tau;
  float eps_decay;
  float eps_end;
  float inv_batch;
  float two_over_batch;
};

// A CTA's shared memory, in floats: the staged slices (W_TOTAL), with
// batch tiles the gradient accumulators (ACC_FLOATS), delta (MAX_BATCH),
// then blocks of rows with the odd row stride ldb = tile | 1 (so that
// column reads at one batch index hit distinct banks):
//   P     (PR_ROWS rows of dot_t, 16-byte aligned): the forward's
//         split-K partial sums (P_ROWS), and in the same rows (2 x CLUSTER
//         x R_ROWS) the backward's receive slots: other CTAs store there
//         only after the last forward's cluster barrier;
//   A, T  (OUT_ROWS each): every layer's online and target output;
//   G     (G_ROWS): the output gradient of the CTA's own units;
//   X, XN (D each, when the batch is staged): x and xn.
constexpr int PR_ROWS = cmax(P_ROWS, 2 * CLUSTER * R_ROWS);

struct Layout {
  long long acc, delta, p, a, t, g, x, xn, total;
};

__host__ __device__ constexpr Layout layout(int tile, bool staged, bool tiled, bool ps) {
  const long long ldb = tile | 1;
  Layout l{};
  l.acc = ps ? W_TOTAL : 0;
  l.delta = l.acc + (tiled ? ACC_FLOATS : 0);
  l.p = l.delta + MAX_BATCH;
  l.a = l.p + (long long)DOT_FLOATS * PR_ROWS * ldb;
  l.t = l.a + OUT_ROWS * ldb;
  l.g = l.t + OUT_ROWS * ldb;
  l.x = l.g + G_ROWS * ldb;
  l.xn = l.x + (staged ? D * ldb : 0);
  l.total = l.xn + (staged ? D * ldb : 0);
  return l;
}

__host__ __device__ constexpr long long smem_bytes(int tile, bool staged, bool tiled, bool ps) {
  return 4 * layout(tile, staged, tiled, ps).total;
}

// Whether the params are staged (mirrored by learner_kernel.params_staged):
// when they fit beside the rows of a one-column tile with the gradient
// accumulators, so that every batch runs with them staged; else every
// launch reads them from device memory. A compile-time choice, so that
// the passes carry no run-time branch on it.
constexpr bool PS = smem_bytes(1, false, true, true) <= SMEM_OPTIN;

// A launch's batch tile and shared memory (mirrored by
// learner_kernel.batch_plan), the first that fits `optin` bytes: the whole
// batch staged, the whole batch read from device memory, or the widest
// even split of the batch with the gradient accumulators. A tile of 0 when
// nothing fits.
struct Plan {
  int tile, staged;
  long long bytes;
};

inline Plan plan(int batch, long long optin) {
  for (const bool staged : {true, false}) {
    const long long bytes = smem_bytes(batch, staged, false, PS);
    if (bytes <= optin) return {batch, staged, bytes};
  }
  for (int n = 2; n <= batch; ++n) {
    const int tile = (batch + n - 1) / n;
    const long long bytes = smem_bytes(tile, false, true, PS);
    if (bytes <= optin) return {tile, 0, bytes};
  }
  return {0, 0, 0};
}

// What every pass reads beside the arguments: the rank, the current tile
// (B columns) and the shared-memory blocks (R, the receive slots, aliases
// P).
struct Ctx {
  int rank, B, ldb;
  float* smem;
  float *A, *T, *G;
  dot_t *P, *R, *acc;
  float* delta;
  const float* x;  // the staged X or the tile's columns of the caller's x
  const float* xn;
  long long x_ld, xn_ld;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cluster barrier, split in its two halves: every thread of every CTA
// arrives (release: its shared-memory stores, local or remote, become
// visible) and waits (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Store v at the same shared-memory offset as `local` in every CTA of the
// cluster (this one included).
__device__ __forceinline__ void store_all(float* local, float v) {
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q) *cluster.map_shared_rank(local, q) = v;
}

// Start copying rank r's slice of one (IN, OUT) kernel array into dst (row
// stride NMAX), and of its (OUT,) bias into bdst.
template <int L>
__device__ __forceinline__ void stage_slice(float* dst, float* bdst, const float* w,
                                            const float* b, int lo, int n, bool vec) {
  using G = Geo<L>;
  if (G::VEC && vec) {
    constexpr int CPR = G::NMAX / 4;  // 16-byte chunks a row (every rank owns NMAX)
    for (int k = threadIdx.x; k < G::IN * CPR; k += THREADS) {
      const int i = k / CPR, c = (k - i * CPR) * 4;
      cp_async16(dst + i * G::NMAX + c, w + i * G::OUT + lo + c);
    }
    for (int k = threadIdx.x; k < CPR; k += THREADS) cp_async16(bdst + 4 * k, b + lo + 4 * k);
  } else {
    for (int k = threadIdx.x; k < G::IN * n; k += THREADS) {
      const int i = k / n, o = k - i * n;
      cp_async4(dst + i * G::NMAX + o, w + i * G::OUT + lo + o);
    }
    for (int k = threadIdx.x; k < n; k += THREADS) cp_async4(bdst + k, b + lo + k);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Stage layer L's slices and the layers after it: W, b and the target in
// the first group, mu and nu in the second (`moments`).
template <int L>
__device__ void stage_params(const LearnArgs& a, const Ctx& c, bool moments) {
  using G = Geo<L>;
  const int lo = own_lo(G::OUT, c.rank), n = own_n(G::OUT, c.rank);
  float* base = c.smem + Acc<L>::w_off;
  float* bias = base + 4 * G::WSLICE;
  if (n > 0) {
    if (!moments) {
      const bool vec =
          aligned16(a.w[L]) && aligned16(a.b[L]) && aligned16(a.tw[L]) && aligned16(a.tb[L]);
      stage_slice<L>(base, bias, a.w[L], a.b[L], lo, n, vec);
      stage_slice<L>(base + G::WSLICE, bias + G::BSLICE, a.tw[L], a.tb[L], lo, n, vec);
    } else {
      const bool vec =
          aligned16(a.mw[L]) && aligned16(a.mb[L]) && aligned16(a.vw[L]) && aligned16(a.vb[L]);
      stage_slice<L>(base + 2 * G::WSLICE, bias + 2 * G::BSLICE, a.mw[L], a.mb[L], lo, n, vec);
      stage_slice<L>(base + 3 * G::WSLICE, bias + 3 * G::BSLICE, a.vw[L], a.vb[L], lo, n, vec);
    }
  }
  if constexpr (L + 1 < NL) stage_params<L + 1>(a, c, moments);
}

// Layer L's output units of this rank, for the online and the target net at
// once, stored into every CTA's A and T rows; then the layers after it.
template <int L>
__device__ void forward(const LearnArgs& a, const Ctx& c) {
  using G = Geo<L>;
  const int B = c.B, ldb = c.ldb;
  const int lo = own_lo(G::OUT, c.rank), n = own_n(G::OUT, c.rank);
  // The layer's inputs, online and target (selected, not indexed: an
  // array indexed at run time would live in local memory).
  const float* in0 = L == 0 ? c.x : c.A + Acc<L == 0 ? 0 : L - 1>::out_row * ldb;
  const float* in1 = L == 0 ? c.xn : c.T + Acc<L == 0 ? 0 : L - 1>::out_row * ldb;
  const long long ld0 = L == 0 ? c.x_ld : ldb, ld1 = L == 0 ? c.xn_ld : ldb;
  // The own columns of W and b, online and target: the staged slices (row
  // stride NMAX) or the caller's arrays (row stride OUT).
  const float* base = c.smem + Acc<L>::w_off;
  const float* w0 = PS ? base : a.w[L] + lo;
  const float* w1 = PS ? base + G::WSLICE : a.tw[L] + lo;
  const float* b0 = PS ? base + 4 * G::WSLICE : a.b[L] + lo;
  const float* b1 = PS ? base + 4 * G::WSLICE + G::BSLICE : a.tb[L] + lo;
  constexpr int wld = PS ? G::NMAX : G::OUT;

  // Split-K partial sums: item (segment, net, unit, column).
  const int items = G::SEGS * 2 * n * B;
  for (int k = threadIdx.x; k < items; k += THREADS) {
    const int col = k % B, rest = k / B;
    const int o = rest % n, sn = rest / n;
    const int net = sn & 1, s = sn >> 1;
    const float* w = (net ? w1 : w0) + o;
    const float* x = (net ? in1 : in0) + col;
    const long long xld = net ? ld1 : ld0;
    const int i1 = min((s + 1) * G::SEG, G::IN);
    dot_t acc = 0;
#pragma unroll 8
    for (int i = s * G::SEG; i < i1; ++i) {
      acc = dot_fma(static_cast<dot_t>(w[i * wld]), static_cast<dot_t>(x[i * xld]), acc);
    }
    c.P[(sn * G::NMAX + o) * ldb + col] = acc;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * n * B; k += THREADS) {
    const int col = k % B, rest = k / B;
    const int o = rest % n, net = rest / n;
    dot_t sum = c.P[(net * G::NMAX + o) * ldb + col];
#pragma unroll
    for (int s = 1; s < G::SEGS; ++s) sum += c.P[((2 * s + net) * G::NMAX + o) * ldb + col];
    float h = __fadd_rn(to_f32(sum), (net ? b1 : b0)[o]);
    if (L < NL - 1) h = fmaxf(h, 0.0f);
    store_all((net ? c.T : c.A) + (Acc<L>::out_row + lo + o) * ldb + col, h);
  }
  cluster_sync();
  if constexpr (L + 1 < NL) forward<L + 1>(a, c);
}

// The output gradient of layer L-1's own units from every rank's partial
// W_L[:, own] g_out_L[own], then the layers below.
template <int L>
__device__ void backward(const LearnArgs& a, const Ctx& c) {
  if constexpr (L >= 1) {
    using G = Geo<L>;
    using Gp = Geo<L - 1>;
    const int B = c.B, ldb = c.ldb;
    const int n = own_n(G::OUT, c.rank);
    const float* w = PS ? c.smem + Acc<L>::w_off : a.w[L] + own_lo(G::OUT, c.rank);
    constexpr int wld = PS ? G::NMAX : G::OUT;
    const float* g_out = c.G + Acc<L>::g_row * ldb;
    dot_t* recv = c.R + (L & 1) * (CLUSTER * R_ROWS) * ldb;
    cg::cluster_group cluster = cg::this_cluster();
    if (n > 0) {
      for (int k = threadIdx.x; k < G::IN * B; k += THREADS) {
        const int i = k / B, col = k - i * B;
        dot_t s = 0;
        for (int o = 0; o < n; ++o) {
          s = dot_fma(static_cast<dot_t>(w[i * wld + o]),
                      static_cast<dot_t>(g_out[o * ldb + col]), s);
        }
        const int owner = owner_of(G::IN, i);
        dot_t* slot = recv + (c.rank * R_ROWS + i - own_lo(G::IN, owner)) * ldb + col;
        *cluster.map_shared_rank(slot, owner) = s;
      }
    }
    cluster_sync();
    const int lo_p = own_lo(Gp::OUT, c.rank), n_p = own_n(Gp::OUT, c.rank);
    const float* a_prev = c.A + Acc<L - 1>::out_row * ldb;
    float* g_in = c.G + Acc<L - 1>::g_row * ldb;
    for (int k = threadIdx.x; k < n_p * B; k += THREADS) {
      const int il = k / B, col = k - il * B;
      dot_t s = 0;
      for (int q = 0; q < CLUSTER; ++q) {
        if (own_n(G::OUT, q) > 0) s += recv[(q * R_ROWS + il) * ldb + col];
      }
      g_in[il * ldb + col] = __fmul_rn(to_f32(s),
                                       a_prev[(lo_p + il) * ldb + col] > 0.0f ? 1.0f : 0.0f);
    }
    __syncthreads();
    backward<L - 1>(a, c);
  }
}

// Adam on one element (when learning) and the target sync (when syncing):
// the old values as staged (or read), the new ones stored to device memory.
__device__ __forceinline__ void update_element(float p_in, float m_in, float v_in, float t_in,
                                               float g, const LearnArgs& a, float bc1, float bc2,
                                               float* p, float* m, float* v, float* t) {
  float eff = p_in;
  if (a.learn) {
    const float m_new = __fadd_rn(__fmul_rn(a.b1, m_in), __fmul_rn(a.one_minus_b1, g));
    const float v_new =
        __fadd_rn(__fmul_rn(a.b2, v_in), __fmul_rn(__fmul_rn(a.one_minus_b2, g), g));
    const float upd = __fdiv_rn(__fdiv_rn(m_new, bc1),
                                __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, bc2)), a.adam_eps));
    eff = __fsub_rn(p_in, __fmul_rn(a.lr, upd));
    *p = eff;
    *m = m_new;
    *v = v_new;
  }
  if (a.sync) *t = __fadd_rn(__fmul_rn(a.tau, eff), __fmul_rn(a.one_minus_tau, t_in));
}

// Layer L's gradient at the own kernel element (i, o), and at the own
// bias unit o, over the tile's columns, summed onto g in batch order.
template <int L>
__device__ __forceinline__ dot_t grad_w(const Ctx& c, int i, int o, dot_t g) {
  const float* a_prev = L == 0 ? c.x : c.A + Acc<L == 0 ? 0 : L - 1>::out_row * c.ldb;
  const long long lda = L == 0 ? c.x_ld : c.ldb;
  const float* g_out = c.G + Acc<L>::g_row * c.ldb;
  for (int col = 0; col < c.B; ++col) {
    g = dot_fma(static_cast<dot_t>(a_prev[i * lda + col]),
                static_cast<dot_t>(g_out[o * c.ldb + col]), g);
  }
  return g;
}
template <int L>
__device__ __forceinline__ dot_t grad_b(const Ctx& c, int o, dot_t g) {
  const float* g_out = c.G + Acc<L>::g_row * c.ldb;
  for (int col = 0; col < c.B; ++col) g += g_out[o * c.ldb + col];
  return g;
}

// Carry the tile's gradients of layer L's own elements, and of the layers
// after it, into the accumulators (`first`: start them at 0).
template <int L>
__device__ void accumulate(const Ctx& c, bool first) {
  using G = Geo<L>;
  const int n = own_n(G::OUT, c.rank);
  dot_t* acc = c.acc + Acc<L>::acc_off;
  for (int k = threadIdx.x; k < G::IN * n; k += THREADS) {
    const int i = k / n, o = k - i * n, e = i * G::NMAX + o;
    acc[e] = grad_w<L>(c, i, o, first ? dot_t(0) : acc[e]);
  }
  dot_t* acc_b = acc + G::IN * G::NMAX;
  for (int o = threadIdx.x; o < n; o += THREADS) {
    acc_b[o] = grad_b<L>(c, o, first ? dot_t(0) : acc_b[o]);
  }
  if constexpr (L + 1 < NL) accumulate<L + 1>(c, first);
}

// The elementwise pass over this rank's columns of layer L's kernel and
// bias, then the layers after it. Each gradient is recomputed from the
// saved activations and the own output gradients of the last tile, onto
// the accumulated earlier tiles (`tiled`).
template <int L>
__device__ void update(const LearnArgs& a, const Ctx& c, bool tiled, float bc1, float bc2) {
  using G = Geo<L>;
  const int lo = own_lo(G::OUT, c.rank), n = own_n(G::OUT, c.rank);
  const float* s = c.smem + Acc<L>::w_off;  // W, T, M, V slices, then biases
  const float* sb = s + 4 * G::WSLICE;
  const dot_t* acc = c.acc + Acc<L>::acc_off;
  for (int k = threadIdx.x; k < G::IN * n; k += THREADS) {
    const int i = k / n, o = k - i * n;
    const int e = i * G::NMAX + o;
    dot_t g = 0;
    if (a.learn) g = grad_w<L>(c, i, o, tiled ? acc[e] : dot_t(0));
    const long long gi = (long long)i * G::OUT + lo + o;
    float* p = a.w[L] + gi;
    float* m = a.mw[L] + gi;
    float* v = a.vw[L] + gi;
    float* t = a.tw[L] + gi;
    if constexpr (PS) {
      update_element(s[e], s[2 * G::WSLICE + e], s[3 * G::WSLICE + e], s[G::WSLICE + e],
                     to_f32(g), a, bc1, bc2, p, m, v, t);
    } else {
      update_element(*p, *m, *v, *t, to_f32(g), a, bc1, bc2, p, m, v, t);
    }
  }
  for (int o = threadIdx.x; o < n; o += THREADS) {
    dot_t g = 0;
    if (a.learn) g = grad_b<L>(c, o, tiled ? acc[G::IN * G::NMAX + o] : dot_t(0));
    float* p = a.b[L] + lo + o;
    float* m = a.mb[L] + lo + o;
    float* v = a.vb[L] + lo + o;
    float* t = a.tb[L] + lo + o;
    if constexpr (PS) {
      update_element(sb[o], sb[2 * G::BSLICE + o], sb[3 * G::BSLICE + o], sb[G::BSLICE + o],
                     to_f32(g), a, bc1, bc2, p, m, v, t);
    } else {
      update_element(*p, *m, *v, *t, to_f32(g), a, bc1, bc2, p, m, v, t);
    }
  }
  if constexpr (L + 1 < NL) update<L + 1>(a, c, tiled, bc1, bc2);
}

__global__ void __launch_bounds__(THREADS, 1) td_adam_kernel(const LearnArgs a, int tile, int staged) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.batch;
  const bool tiled = tile < B;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const Layout l = layout(tile, staged != 0, tiled, PS);
  const int ldb = tile | 1;
  dot_t* P = reinterpret_cast<dot_t*>(smem + l.p);
  Ctx c{rank, B, ldb, smem,
        smem + l.a, smem + l.t, smem + l.g, P, P, reinterpret_cast<dot_t*>(smem + l.acc),
        smem + l.delta, staged ? smem + l.x : a.x, staged ? smem + l.xn : a.xn,
        staged ? ldb : a.x_ld, staged ? ldb : a.xn_ld};
  const int tid = threadIdx.x;

  // Every CTA of the cluster has started before any stores into another's
  // shared memory: arrive now, wait before the first remote store.
  cluster_arrive_relaxed();

  // Stage: the batch, W, b and the target (group 0); mu and nu (group 1).
  if (a.learn && staged) {
    float* X = smem + l.x;
    float* XN = smem + l.xn;
    for (int k = tid; k < D * B; k += THREADS) {
      const int i = k / B, col = k - i * B;
      cp_async4(X + i * ldb + col, a.x + i * a.x_ld + col);
      cp_async4(XN + i * ldb + col, a.xn + i * a.xn_ld + col);
    }
  }
  if (PS && (a.learn || a.sync)) stage_params<0>(a, c, false);
  cp_async_commit();
  if (PS && a.learn) stage_params<0>(a, c, true);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  cluster_wait();

  float loss = -1.0f;
  if (a.learn) {
    float sq_sum = 0.0f;  // rank 0, thread 0: sum_b delta^2 in batch order
    for (int c0 = 0; c0 < B; c0 += tile) {
      c.B = min(tile, B - c0);
      if (!staged) {
        c.x = a.x + c0;
        c.xn = a.xn + c0;
      }
      // Every CTA is done with the tile before's rows (its own and the
      // ones it stores into) before the next tile's first remote store.
      if (c0 > 0) cluster_sync();

      // 1. Both forwards, layer by layer across the cluster.
      forward<0>(a, c);

      // 2. TD error and the gradient of the MSE at this rank's q units.
      const float* q = c.A + Q_ROW * ldb;
      const float* qn = c.T + Q_ROW * ldb;
      constexpr int LAST = NL - 1;
      const int lo_q = own_lo(NUM_ACTIONS, rank), n_q = own_n(NUM_ACTIONS, rank);
      if (tid < c.B) {
        const int b = c0 + tid;
        float boot = qn[tid];
#pragma unroll
        for (int j = 1; j < NUM_ACTIONS; ++j) boot = fmaxf(boot, qn[j * ldb + tid]);
        const int act = a.actions[b];
        const bool valid = act >= 0 && act < NUM_ACTIONS;
        const float taken = valid ? q[act * ldb + tid] : 0.0f;
        const float tgt = __fadd_rn(
            a.rewards[b], __fmul_rn(__fmul_rn(a.gamma, boot), __fsub_rn(1.0f, a.dones[b])));
        const float d = __fsub_rn(taken, tgt);
        c.delta[tid] = d;
        const float gd = __fmul_rn(d, a.two_over_batch);
        float* g_q = c.G + Acc<LAST>::g_row * ldb;
        for (int j = 0; j < n_q; ++j) g_q[j * ldb + tid] = lo_q + j == act ? gd : 0.0f;
      }
      __syncthreads();
      if (rank == 0 && tid == 0) {
        for (int col = 0; col < c.B; ++col) {
          sq_sum = __fadd_rn(sq_sum, __fmul_rn(c.delta[col], c.delta[col]));
        }
      }

      // 3. Backward through the hidden layers.
      backward<NL - 1>(a, c);

      // Every tile but the last: carry its gradients.
      if (c0 + tile < B) accumulate<0>(c, c0 == 0);
    }
    loss = __fmul_rn(sq_sum, a.inv_batch);
  }

  // 4. The elementwise pass over the own columns: gradient, Adam, sync.
  cp_async_wait<0>();
  __syncthreads();
  if (a.learn || a.sync) {
    const float cf = (float)(__ldg(a.count) + 1);
    const float bc1 = 1.0f - expf(cf * logf(a.b1));
    const float bc2 = 1.0f - expf(cf * logf(a.b2));
    update<0>(a, c, a.learn && tiled, bc1, bc2);
  }

  // 5. Scalars.
  if (rank == 0 && tid == 0) {
    *a.loss = loss;
    if (a.decay) *a.eps = fmaxf(__fmul_rn(*a.eps, a.eps_decay), a.eps_end);
  }
}

// An empty kernel with the learner's launch shape: the floor a launch of a
// CLUSTER-CTA cluster costs.
__global__ void __launch_bounds__(THREADS) empty_cluster_kernel(int) {}

namespace {

long long opted_in = 48 * 1024;  // the default limit of dynamic shared memory
bool cluster_opted_in = false;

// The launch plan at `batch` on the current device, with the kernels
// opted in to its shared memory and (beyond 8 CTAs) cluster size.
cudaError_t prepare(int batch, Plan* p) {
  const void* kernels[] = {(const void*)td_adam_kernel, (const void*)empty_cluster_kernel};
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  *p = plan(batch, optin);
  if (p->tile < 1) return cudaErrorInvalidValue;
  if (p->bytes > opted_in) {
    for (const void* fn : kernels) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->bytes);
      if (err != cudaSuccess) return err;
    }
    opted_in = p->bytes;
  }
  if (CLUSTER > 8 && !cluster_opted_in) {
    for (const void* fn : kernels) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    cluster_opted_in = true;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t launch_config(long long bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

}  // namespace dronerl_td

extern "C" int td_adam_launch(const dronerl_td::LearnArgs* args, void* stream) {
  using namespace dronerl_td;
  if (args->batch < 1 || args->batch > MAX_BATCH || args->count == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (args->decay && args->eps == nullptr) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = prepare(args->batch, &p);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(p.bytes, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, td_adam_kernel, *args, p.tile, p.staged);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// An empty launch of the same cluster, threads and shared memory as a
// learner launch at `batch` (the floor a learner launch is compared with).
extern "C" int td_adam_empty_launch(int batch, void* stream) {
  using namespace dronerl_td;
  Plan p;
  cudaError_t err = prepare(batch, &p);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(p.bytes, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, empty_cluster_kernel, batch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch shape at `batch`: out = {cluster CTAs, threads a CTA, dynamic
// shared memory bytes a CTA, batch staged (0/1), clusters that fit the card
// at once (cudaOccupancyMaxActiveClusters), batch columns a tile, params
// staged (0/1)}. Returns a CUDA error code.
extern "C" int td_adam_info(int batch, long long* out) {
  using namespace dronerl_td;
  Plan p;
  cudaError_t err = prepare(batch, &p);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(p.bytes, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (void*)td_adam_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = CLUSTER;
  out[1] = THREADS;
  out[2] = p.bytes;
  out[3] = p.staged;
  out[4] = clusters;
  out[5] = p.tile;
  out[6] = PS;
  return 0;
}

extern "C" const char* td_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
