// The DQN learner's TD(0) + Adam step for a dense Q-net, in one launch of
// one thread block.
//
// Replaces two TPU kernels that compute the same update:
//  * the TD branch of dronerl_tpu/ops/fused_tick.py::_full_kernel (the
//    td_hparams launch, :893-989), which rides grid step 0 of the ring tick
//    and is gated by can_train;
//  * dronerl_tpu/ops/learner_kernel.py::_learner_kernel (:44-150), which
//    adds a hard or EMA target sync and the epsilon decay, each under a flag.
// One kernel with three flags (learn, sync, decay) serves both.
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
// In practice it costs a launch's latency plus one block's serial depth:
// the target forward, the online forward, the backward and the update pass
// run one after another, each a chain of dependent multiply-adds as long as
// the layer's input width (294 in the first layer).
//
// Design: one block of THREADS threads, one launch per learner tick.
// Params, target, mu and nu are updated in place, and the forwards read the
// OLD params and target. One block that finishes every read before a
// __syncthreads() and only then writes is right by construction, where the
// blocks of a grid run in no order and one could overwrite a weight that
// another still reads. What the passes share (the batch, every layer's
// activation and output gradient) lives in shared memory, rows padded to an
// odd stride so that the update pass's column reads hit distinct banks; no
// gradient goes to device memory: the update pass recomputes each
// element's gradient from the saved activations (B multiply-adds) and
// updates p, m, v (and t) in the same thread, with coalesced loads and
// stores. The serial depth is the price of one block; several blocks with
// separate outputs, or fusing this launch into the tick kernel's, are the
// next steps.
//
// Weights are read with plain loads, not through the read-only cache:
// ld.global.nc requires data that the kernel does not write, and this
// kernel writes the same arrays (plain loads are cached in L1 on sm_90).
//
// Numerics: build without --use_fast_math (IEEE divides and roots, expf
// and logf). The TD target, the loss and the whole elementwise pass use
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, so that nvcc does not
// contract a*b+c into one FMA: the plain PyTorch version rounds every
// product and sum on its own, and from the same gradient the kernel then
// writes the same bits. The dot products (forwards, backward, gradients)
// use FMAs: they sum in another order than cuBLAS in any case.
//
// The net widths are compile-time constants (-D, see ops/_build.py); the
// batch size, the hyperparameters, the Adam count and the flags are launch
// arguments from the host, as the TPU kernels take them by scalar prefetch.

#include <cstdint>

#include <cuda_runtime.h>

#if !defined(DR_NLAYERS) || !defined(DR_DIM0)
#error "build through dronerl_tpu_torch/ops/_build.py (it passes the -D set)"
#endif

namespace dronerl_td {

constexpr int MAX_LAYERS = 8;
constexpr int DIMS[MAX_LAYERS + 1] = {DR_DIM0, DR_DIM1, DR_DIM2, DR_DIM3, DR_DIM4,
                                      DR_DIM5, DR_DIM6, DR_DIM7, DR_DIM8};
constexpr int NL = DR_NLAYERS;
constexpr int D = DIMS[0];
constexpr int NUM_ACTIONS = 5;
constexpr int THREADS = 1024;
constexpr int MAX_BATCH = 256;

static_assert(NL >= 1 && NL <= MAX_LAYERS, "1..8 dense layers");
static_assert(DIMS[NL] == NUM_ACTIONS, "the last width is the action count");

// The first row of layer L's output (and of its gradient) in the shared
// activation (and gradient) block: the rows of the outputs of layers
// [0, L). A template constant, so that device code reads DIMS only at
// compile time.
template <int L>
struct OutRow {
  static constexpr int value = OutRow<L - 1>::value + DIMS[L];
};
template <>
struct OutRow<0> {
  static constexpr int value = 0;
};
constexpr int OUT_ROWS = OutRow<NL>::value;
constexpr int Q_ROW = OutRow<NL - 1>::value;

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
  int batch;
  int count;
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

// Shared memory, in floats, each block row-major with row stride ldb:
//   X  (DIMS[0] rows): the next obs during the target forward, then the obs;
//   A  (OUT_ROWS rows): every layer's output (the last one is q);
//   G  (OUT_ROWS rows): every layer's output gradient;
//   boot, delta (B each).
__host__ __device__ constexpr int row_stride(int batch) { return batch | 1; }

constexpr long long smem_bytes(int batch) {
  return 4LL * ((long long)(D + 2 * OUT_ROWS) * row_stride(batch) + 2LL * batch);
}

__device__ __forceinline__ void load_batch(float* X, const float* __restrict__ src, long long ld,
                                           int B, int ldb) {
  for (int k = threadIdx.x; k < D * B; k += blockDim.x) {
    const int i = k / B, col = k - i * B;
    X[i * ldb + col] = __ldg(src + i * ld + col);
  }
}

// Layer L's output, and the layers after it, of the online (TARGET false) or
// the target net; input rows at `in`, outputs into A.
template <int L, bool TARGET>
__device__ void forward(const float* in, float* A, const LearnArgs& a, int B, int ldb) {
  constexpr int IN = DIMS[L], OUT = DIMS[L + 1], ROW = OutRow<L>::value;
  const float* W = TARGET ? a.tw[L] : a.w[L];
  const float* bias = TARGET ? a.tb[L] : a.b[L];
  float* out = A + ROW * ldb;
  for (int k = threadIdx.x; k < OUT * B; k += blockDim.x) {
    const int o = k / B, col = k - o * B;
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < IN; ++i) acc = fmaf(W[i * OUT + o], in[i * ldb + col], acc);
    acc = __fadd_rn(acc, bias[o]);
    out[o * ldb + col] = L < NL - 1 ? fmaxf(acc, 0.0f) : acc;
  }
  __syncthreads();
  if constexpr (L + 1 < NL) forward<L + 1, TARGET>(out, A, a, B, ldb);
}

// gin = (W_L gout_L) * (a_{L-1} > 0) into G's rows of layer L-1, down to 1.
template <int L>
__device__ void backward(const float* A, float* G, const LearnArgs& a, int B, int ldb) {
  if constexpr (L >= 1) {
    constexpr int IN = DIMS[L], OUT = DIMS[L + 1];
    constexpr int ROW = OutRow<L>::value, PREV = OutRow<L - 1>::value;
    const float* W = a.w[L];
    const float* g_out = G + ROW * ldb;
    const float* a_prev = A + PREV * ldb;
    float* g_in = G + PREV * ldb;
    for (int k = threadIdx.x; k < IN * B; k += blockDim.x) {
      const int i = k / B, col = k - i * B;
      float s = 0.0f;
#pragma unroll 8
      for (int o = 0; o < OUT; ++o) s = fmaf(W[i * OUT + o], g_out[o * ldb + col], s);
      g_in[i * ldb + col] = __fmul_rn(s, a_prev[i * ldb + col] > 0.0f ? 1.0f : 0.0f);
    }
    __syncthreads();
    backward<L - 1>(A, G, a, B, ldb);
  }
}

// Adam on one element (when learning) and the target sync (when syncing).
__device__ __forceinline__ void update_element(float* p, float* m, float* v, float* t, float g,
                                               const LearnArgs& a, float bc1, float bc2) {
  const float p_in = *p;
  float eff = p_in;
  if (a.learn) {
    const float m_new = __fadd_rn(__fmul_rn(a.b1, *m), __fmul_rn(a.one_minus_b1, g));
    const float v_new =
        __fadd_rn(__fmul_rn(a.b2, *v), __fmul_rn(__fmul_rn(a.one_minus_b2, g), g));
    const float upd = __fdiv_rn(__fdiv_rn(m_new, bc1),
                                __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, bc2)), a.adam_eps));
    eff = __fsub_rn(p_in, __fmul_rn(a.lr, upd));
    *p = eff;
    *m = m_new;
    *v = v_new;
  }
  if (a.sync) *t = __fadd_rn(__fmul_rn(a.tau, eff), __fmul_rn(a.one_minus_tau, *t));
}

// The elementwise pass over layer L's kernel (IN x OUT) and bias (OUT),
// then the layers after it. Each gradient is recomputed from the saved
// activations and output gradients.
template <int L>
__device__ void update(const float* X, const float* A, const float* G, const LearnArgs& a, int B,
                       int ldb, float bc1, float bc2) {
  constexpr int IN = DIMS[L], OUT = DIMS[L + 1];
  constexpr int ROW = OutRow<L>::value, PREV = OutRow<L == 0 ? 0 : L - 1>::value;
  const float* a_prev = L == 0 ? X : A + PREV * ldb;
  const float* g_out = G + ROW * ldb;
  for (int k = threadIdx.x; k < IN * OUT; k += blockDim.x) {
    const int i = k / OUT, o = k - i * OUT;
    float g = 0.0f;
    if (a.learn) {
      for (int col = 0; col < B; ++col)
        g = fmaf(a_prev[i * ldb + col], g_out[o * ldb + col], g);
    }
    update_element(a.w[L] + k, a.mw[L] + k, a.vw[L] + k, a.tw[L] + k, g, a, bc1, bc2);
  }
  for (int o = threadIdx.x; o < OUT; o += blockDim.x) {
    float g = 0.0f;
    if (a.learn) {
      for (int col = 0; col < B; ++col) g = __fadd_rn(g, g_out[o * ldb + col]);
    }
    update_element(a.b[L] + o, a.mb[L] + o, a.vb[L] + o, a.tb[L] + o, g, a, bc1, bc2);
  }
  if constexpr (L + 1 < NL) update<L + 1>(X, A, G, a, B, ldb, bc1, bc2);
}

__global__ void __launch_bounds__(THREADS) td_adam_kernel(const LearnArgs a) {
  extern __shared__ float smem[];
  const int B = a.batch;
  const int ldb = row_stride(B);
  float* X = smem;
  float* A = X + D * ldb;
  float* G = A + OUT_ROWS * ldb;
  float* boot = G + OUT_ROWS * ldb;
  float* delta = boot + B;
  const int tid = threadIdx.x;

  float loss = -1.0f;
  if (a.learn) {
    // 1. Target forward on the next obs (reads the OLD target), keeping the
    //    bootstrap max; then the online forward on the obs (the OLD params).
    load_batch(X, a.xn, a.xn_ld, B, ldb);
    __syncthreads();
    forward<0, true>(X, A, a, B, ldb);
    const float* q = A + Q_ROW * ldb;
    if (tid < B) {
      float best = q[tid];
#pragma unroll
      for (int j = 1; j < NUM_ACTIONS; ++j) best = fmaxf(best, q[j * ldb + tid]);
      boot[tid] = best;
    }
    __syncthreads();
    load_batch(X, a.x, a.x_ld, B, ldb);
    __syncthreads();
    forward<0, false>(X, A, a, B, ldb);

    // 2. TD error and the gradient of the MSE at q.
    float* g_q = G + Q_ROW * ldb;
    if (tid < B) {
      const int act = a.actions[tid];
      const bool valid = act >= 0 && act < NUM_ACTIONS;
      const float taken = valid ? q[act * ldb + tid] : 0.0f;
      const float tgt = __fadd_rn(
          a.rewards[tid],
          __fmul_rn(__fmul_rn(a.gamma, boot[tid]), __fsub_rn(1.0f, a.dones[tid])));
      const float d = __fsub_rn(taken, tgt);
      delta[tid] = d;
      const float gd = __fmul_rn(d, a.two_over_batch);
#pragma unroll
      for (int j = 0; j < NUM_ACTIONS; ++j) g_q[j * ldb + tid] = j == act ? gd : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      for (int col = 0; col < B; ++col) s = __fadd_rn(s, __fmul_rn(delta[col], delta[col]));
      loss = __fmul_rn(s, a.inv_batch);
    }

    // 3. Backward through the hidden layers, every read of the OLD params.
    backward<NL - 1>(A, G, a, B, ldb);
  }

  // 4. The elementwise pass: gradient, Adam, target sync; every read of a
  //    weight by the forwards and the backward is behind a __syncthreads().
  if (a.learn || a.sync) {
    const float cf = (float)(a.count + 1);
    const float bc1 = 1.0f - expf(cf * logf(a.b1));
    const float bc2 = 1.0f - expf(cf * logf(a.b2));
    update<0>(X, A, G, a, B, ldb, bc1, bc2);
  }

  // 5. Scalars.
  if (tid == 0) {
    *a.loss = loss;
    if (a.decay) *a.eps = fmaxf(__fmul_rn(*a.eps, a.eps_decay), a.eps_end);
  }
}

}  // namespace dronerl_td

extern "C" int td_adam_launch(const dronerl_td::LearnArgs* args, void* stream) {
  using namespace dronerl_td;
  if (args->batch < 1 || args->batch > MAX_BATCH || args->count < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (args->decay && args->eps == nullptr) return (int)cudaErrorInvalidValue;
  const long long bytes = smem_bytes(args->batch);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  static long long opted_in = 48 * 1024;  // the default limit of dynamic shared memory
  if (bytes > opted_in) {
    err = cudaFuncSetAttribute(td_adam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  td_adam_kernel<<<1, THREADS, (size_t)bytes, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" const char* td_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
