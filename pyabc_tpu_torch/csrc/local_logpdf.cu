// K14 local_logpdf: log-density of B query thetas under LocalTransition's
// mixture, one Gaussian per component with its own precision.
//
// Replaces: pyabc_tpu/transition/local_transition.py::device_logpdf
// (vmapped over a round's lanes; the plain twin is kernels/local_logpdf.py),
// and its K > 1 use through inference/util.py::_switch_propose_sim (:415).
//
// Math, in the DIFF form the JAX code keeps on purpose (expanding the
// quadratic around a shared centre, as K3 does, cancels catastrophically
// in f32 with local precisions: ~5e6 nats at modes +-500 with bandwidth
// 0.05):
//   diff_j = q - theta_j,  maha_j = diff_j' P_j diff_j,
//   lc_j = lconst_j - 0.5 maha_j, with K13's per-component constant
//   lconst_j = log w_j - 0.5 (dim log 2 pi + logdet_j),
//   out = log sum_{j: w_j > 0} exp(lc_j)   (-inf when no weight is > 0).
//
// Bound on an H100: operations. B n (d + d^2 + d multiply-adds and one
// exp): at the scale lane (B 65536, n 16384, d 4) some 5e10 flops and 1e9
// exponentials against (B d + n (d^2 + d + 2)) * 4 bytes of input.
//
// Design (as K3): one thread per query lane keeps q in registers; the
// block stages tiles of components (theta, P, lconst, w) in shared memory
// and every thread runs an online max/sum logsumexp over all n
// (local_mix.cuh, shared with K16's local density). The precision tile is
// d^2 floats a component, so the dim buckets stop at D = 16 and the tile
// shrinks as D grows (512 / D components).
//
// K > 1 mode (a run over several models, each with its own LocalTransition
// fit; the plain twin is kernels/local_logpdf.py::local_logpdf_models_plain):
// params stacked (K, n, ...), each lane scored under its own model m_b's
// mixture. The block walks the models its lanes hold (a block-wide vote
// skips the others) and stages each one's tiles; a lane computes only
// under its own model, so a block spends K tile passes where one model
// would spend one (a simple kernel: sorting lanes by model would remove
// the idle share).
#include "common.cuh"
#include "local_mix.cuh"

namespace {

constexpr int kThreads = 128;

template <int D>
__global__ void __launch_bounds__(kThreads)
local_logpdf_kernel(const float* __restrict__ q, int B, int d,
                    const float* __restrict__ thetas,
                    const float* __restrict__ precs,
                    const float* __restrict__ lconst,
                    const float* __restrict__ weights, int n,
                    float* __restrict__ out) {
  __shared__ pyabc::MixTile<D> sh;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  float qv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) qv[k] = (live && k < d) ? q[(size_t)b * d + k] : 0.f;
  const float v = pyabc::local_mix_logpdf<D>(qv, live, thetas, precs, lconst,
                                             weights, n, d, sh);
  if (live) out[b] = v;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
local_logpdf_models_kernel(const float* __restrict__ q,
                           const int* __restrict__ m, int B, int d, int K,
                           const float* __restrict__ thetas,
                           const float* __restrict__ precs,
                           const float* __restrict__ lconst,
                           const float* __restrict__ weights, int n,
                           float* __restrict__ out) {
  __shared__ pyabc::MixTile<D> sh;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  const int mb = live ? m[b] : -1;
  float qv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) qv[k] = (live && k < d) ? q[(size_t)b * d + k] : 0.f;
  float v = -INFINITY;
  for (int k = 0; k < K; ++k) {
    const bool mine = mb == k;
    if (!__syncthreads_or(mine)) continue;
    const size_t c0 = (size_t)k * n;
    const float r = pyabc::local_mix_logpdf<D>(
        qv, mine, thetas + c0 * d, precs + c0 * d * d, lconst + c0,
        weights + c0, n, d, sh);
    if (mine) v = r;
  }
  if (live) out[b] = v;
}

template <int D>
void launch(const float* q, const int* m, int B, int d, int K,
            const float* thetas, const float* precs, const float* lconst,
            const float* weights, int n, float* out, cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  if (m == nullptr)
    local_logpdf_kernel<D><<<grid, kThreads, 0, stream>>>(
        q, B, d, thetas, precs, lconst, weights, n, out);
  else
    local_logpdf_models_kernel<D><<<grid, kThreads, 0, stream>>>(
        q, m, B, d, K, thetas, precs, lconst, weights, n, out);
}

int dispatch(const float* q, const int* m, int B, int d, int K,
             const float* thetas, const float* precs, const float* lconst,
             const float* weights, int n, float* out, void* stream_ptr) {
  if (B <= 0) return 0;
  if (n <= 0 || d <= 0 || d > 16 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define PYABC_LOCAL_LOGPDF(DB) \
  launch<DB>(q, m, B, d, K, thetas, precs, lconst, weights, n, out, stream)
  if (d <= 1)
    PYABC_LOCAL_LOGPDF(1);
  else if (d <= 2)
    PYABC_LOCAL_LOGPDF(2);
  else if (d <= 4)
    PYABC_LOCAL_LOGPDF(4);
  else if (d <= 8)
    PYABC_LOCAL_LOGPDF(8);
  else
    PYABC_LOCAL_LOGPDF(16);
#undef PYABC_LOCAL_LOGPDF
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pyabc_local_logpdf(const float* q, int B, int d,
                                  const float* thetas, const float* precs,
                                  const float* lconst, const float* weights,
                                  int n, float* out, void* stream_ptr) {
  return dispatch(q, nullptr, B, d, 1, thetas, precs, lconst, weights, n,
                  out, stream_ptr);
}

// K > 1: q (B, d) and m (B,) int32; thetas (K, n, d), precs (K, n, d, d),
// lconst and weights (K, n).
extern "C" int pyabc_local_logpdf_models(
    const float* q, const int* m, int B, int d, int K, const float* thetas,
    const float* precs, const float* lconst, const float* weights, int n,
    float* out, void* stream_ptr) {
  if (m == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, m, B, d, K, thetas, precs, lconst, weights, n, out,
                  stream_ptr);
}
