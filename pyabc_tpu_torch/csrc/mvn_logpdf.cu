// K3 mvn_mixture_logpdf: log-density of B query thetas under the weighted
// n-component Gaussian mixture with one shared precision matrix.
//
// Replaces: pyabc_tpu/transition/multivariatenormal.py::device_logpdf
// (MultivariateNormalTransition, vmapped over the round's lanes).
//
// Math (the CENTRED expansion of the JAX code, kept on purpose: expanding
// around the origin cancels catastrophically in f32 when |mean| is large
// against the bandwidth):
//   u = q - center,  Pu = P u,
//   maha_j = u'Pu - 2 thetas_c[j]'Pu + quad[j],
//   lc_j = -0.5 * (dim * log(2 pi) + logdet + maha_j),
//   out = log sum_j w_j exp(lc_j)   (components with w_j == 0 contribute
//         nothing; all weights zero gives -inf, like logsumexp(b=0)).
//
// Bound on an H100: operations. The work is B*n*(2d+8) flops plus B*n
// exponentials against ~(B*d + n*(d+2)) * 4 bytes of input, so at the
// main-path shapes (B=4096, n=1024, d=4) it is far above the card's
// flop/byte balance. At those shapes the design below is latency bound
// instead: each thread walks all n components in sequence and B/64 blocks
// leave most SMs with one warp (chip_smoke.py reports its device time
// against the bound).
//
// Design: one thread per query lane keeps u and Pu in registers (the dim
// bucket D is a template parameter, so the d-loops unroll and nothing
// spills); the block stages tiles of thetas_c / quad / w in shared memory
// and every thread runs an online max/sum logsumexp over all n components.
// Splitting the components of a lane across threads is the next step.
#include "common.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kThreads = 64;

template <int D>
__global__ void __launch_bounds__(kThreads)
mvn_mixture_logpdf_kernel(const float* __restrict__ q, int B, int d,
                          const float* __restrict__ prec,
                          const float* __restrict__ center,
                          const float* __restrict__ thetas_c,
                          const float* __restrict__ quad,
                          const float* __restrict__ weights, int n,
                          const float* __restrict__ logdet, float dim,
                          float* __restrict__ out) {
  __shared__ float s_th[kTile * D];
  __shared__ float s_quad[kTile];
  __shared__ float s_w[kTile];

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  float u[D], pu[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    u[k] = (live && k < d) ? q[(size_t)b * d + k] - center[k] : 0.f;
  float upu = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k)
      if (i < d && k < d) acc += prec[i * d + k] * u[k];
    pu[i] = acc;
    upu += u[i] * acc;
  }
  const float c0 = dim * PYABC_LOG_2PI + logdet[0];

  float m = -INFINITY;  // running max of lc over nonzero-weight components
  float s = 0.f;        // running sum of w_j exp(lc_j - m)
  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();
    for (int idx = threadIdx.x; idx < cnt * D; idx += blockDim.x) {
      const int j = idx / D, k = idx - j * D;
      s_th[idx] = (k < d) ? thetas_c[(size_t)(base + j) * d + k] : 0.f;
    }
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      s_quad[j] = quad[base + j];
      s_w[j] = weights[base + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float wj = s_w[j];
      if (wj == 0.f) continue;
      float cross = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) cross += s_th[j * D + k] * pu[k];
      const float maha = upu - 2.f * cross + s_quad[j];
      const float lc = -0.5f * (c0 + maha);
      if (lc == -INFINITY) continue;
      if (lc > m) {
        s = s * expf(m - lc) + wj;
        m = lc;
      } else {
        s += wj * expf(lc - m);  // NaN lc propagates through s
      }
    }
  }
  if (live) out[b] = (s == 0.f) ? -INFINITY : m + logf(s);
}

template <int D>
void launch(const float* q, int B, int d, const float* prec,
            const float* center, const float* thetas_c, const float* quad,
            const float* weights, int n, const float* logdet, float dim,
            float* out, cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  mvn_mixture_logpdf_kernel<D><<<grid, kThreads, 0, stream>>>(
      q, B, d, prec, center, thetas_c, quad, weights, n, logdet, dim, out);
}

// K > 1 mode (a run over several models): lane b is scored under the
// mixture of its own model m[b] (multivariatenormal.py::device_logpdf on
// model m's d_max-padded params): prec (K, d, d) zero on the padded dims,
// center (K, d), thetas_c (K, n, d), quad / weights (K, n), logdet and the
// true dims (K,). Lanes of one warp may belong to different models, so
// each thread walks its model's n components straight from global memory
// (3 x 1024 x (d + 2) floats at config 5, held in L1/L2) instead of
// shared tiles; the arithmetic per component is the single-model one.
template <int D>
__global__ void __launch_bounds__(kThreads)
mvn_mixture_logpdf_models_kernel(
    const float* __restrict__ q, const int* __restrict__ m_lane, int B,
    int d, const float* __restrict__ prec, const float* __restrict__ center,
    const float* __restrict__ thetas_c, const float* __restrict__ quad,
    const float* __restrict__ weights, int n,
    const float* __restrict__ logdet, const float* __restrict__ dims,
    float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int m = m_lane[b];
  const float* P = prec + (size_t)m * d * d;
  const float* C = center + (size_t)m * d;
  const float* TH = thetas_c + (size_t)m * n * d;
  const float* QD = quad + (size_t)m * n;
  const float* W = weights + (size_t)m * n;
  float u[D], pu[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    u[k] = (k < d) ? q[(size_t)b * d + k] - C[k] : 0.f;
  float upu = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k)
      if (i < d && k < d) acc += P[i * d + k] * u[k];
    pu[i] = acc;
    upu += u[i] * acc;
  }
  const float c0 = dims[m] * PYABC_LOG_2PI + logdet[m];
  float mx = -INFINITY;
  float s = 0.f;
  for (int j = 0; j < n; ++j) {
    const float wj = __ldg(W + j);
    if (wj == 0.f) continue;
    float cross = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k)
      if (k < d) cross += __ldg(TH + (size_t)j * d + k) * pu[k];
    const float maha = upu - 2.f * cross + __ldg(QD + j);
    const float lc = -0.5f * (c0 + maha);
    if (lc == -INFINITY) continue;
    if (lc > mx) {
      s = s * expf(mx - lc) + wj;
      mx = lc;
    } else {
      s += wj * expf(lc - mx);
    }
  }
  out[b] = (s == 0.f) ? -INFINITY : mx + logf(s);
}

template <int D>
void launch_models(const float* q, const int* m, int B, int d,
                   const float* prec, const float* center,
                   const float* thetas_c, const float* quad,
                   const float* weights, int n, const float* logdet,
                   const float* dims, float* out, cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  mvn_mixture_logpdf_models_kernel<D><<<grid, kThreads, 0, stream>>>(
      q, m, B, d, prec, center, thetas_c, quad, weights, n, logdet, dims, out);
}

}  // namespace

extern "C" int pyabc_mvn_mixture_logpdf(
    const float* q, int B, int d, const float* prec, const float* center,
    const float* thetas_c, const float* quad, const float* weights, int n,
    const float* logdet, float dim, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0) return 0;
  if (d <= 1)
    launch<1>(q, B, d, prec, center, thetas_c, quad, weights, n, logdet, dim,
              out, stream);
  else if (d <= 2)
    launch<2>(q, B, d, prec, center, thetas_c, quad, weights, n, logdet, dim,
              out, stream);
  else if (d <= 4)
    launch<4>(q, B, d, prec, center, thetas_c, quad, weights, n, logdet, dim,
              out, stream);
  else if (d <= 8)
    launch<8>(q, B, d, prec, center, thetas_c, quad, weights, n, logdet, dim,
              out, stream);
  else if (d <= 16)
    launch<16>(q, B, d, prec, center, thetas_c, quad, weights, n, logdet,
               dim, out, stream);
  else if (d <= 32)
    launch<32>(q, B, d, prec, center, thetas_c, quad, weights, n, logdet,
               dim, out, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K > 1 mode: m (B,) int32 model of each lane, stacked params (see above).
extern "C" int pyabc_mvn_mixture_logpdf_models(
    const float* q, const int* m, int B, int d, const float* prec,
    const float* center, const float* thetas_c, const float* quad,
    const float* weights, int n, const float* logdet, const float* dims,
    float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0) return 0;
#define PYABC_LOGPDF_M(DB)                                                   \
  launch_models<DB>(q, m, B, d, prec, center, thetas_c, quad, weights, n,   \
                    logdet, dims, out, stream)
  if (d <= 1)
    PYABC_LOGPDF_M(1);
  else if (d <= 2)
    PYABC_LOGPDF_M(2);
  else if (d <= 4)
    PYABC_LOGPDF_M(4);
  else if (d <= 8)
    PYABC_LOGPDF_M(8);
  else if (d <= 16)
    PYABC_LOGPDF_M(16);
  else if (d <= 32)
    PYABC_LOGPDF_M(32);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef PYABC_LOGPDF_M
  return static_cast<int>(cudaGetLastError());
}
