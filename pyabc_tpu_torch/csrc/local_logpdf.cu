// K14 local_logpdf: log-density of B query thetas under LocalTransition's
// mixture, one Gaussian per component with its own precision.
//
// Replaces: pyabc_tpu/transition/local_transition.py::device_logpdf
// (vmapped over a round's lanes; the plain twin is kernels/local_logpdf.py).
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
// and every thread runs an online max/sum logsumexp over all n. The
// precision tile is d^2 floats a component, so the dim buckets stop at
// D = 16 and the tile shrinks as D grows (512 / D components).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <int D>
struct Tile {
  static constexpr int value = 512 / D;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
local_logpdf_kernel(const float* __restrict__ q, int B, int d,
                    const float* __restrict__ thetas,
                    const float* __restrict__ precs,
                    const float* __restrict__ lconst,
                    const float* __restrict__ weights, int n,
                    float* __restrict__ out) {
  constexpr int T = Tile<D>::value;
  __shared__ float s_th[T * D];
  __shared__ float s_p[T * D * D];
  __shared__ float s_c[T];
  __shared__ float s_w[T];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  float qv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) qv[k] = (live && k < d) ? q[(size_t)b * d + k] : 0.f;

  float m = -INFINITY;  // running max of lc over nonzero-weight components
  float s = 0.f;        // running sum of exp(lc_j - m)
  for (int base = 0; base < n; base += T) {
    const int cnt = min(T, n - base);
    __syncthreads();
    for (int idx = threadIdx.x; idx < cnt * D; idx += kThreads) {
      const int j = idx / D, k = idx - j * D;
      s_th[idx] = k < d ? thetas[(size_t)(base + j) * d + k] : 0.f;
    }
    for (int idx = threadIdx.x; idx < cnt * D * D; idx += kThreads) {
      const int j = idx / (D * D), e = idx - j * (D * D);
      const int k = e / D, l = e - k * D;
      s_p[idx] = (k < d && l < d)
                     ? precs[(size_t)(base + j) * d * d + k * d + l]
                     : 0.f;
    }
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      s_c[j] = lconst[base + j];
      s_w[j] = weights[base + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      if (!(s_w[j] > 0.f)) continue;
      float df[D];
#pragma unroll
      for (int k = 0; k < D; ++k) df[k] = qv[k] - s_th[j * D + k];
      const float* P = s_p + j * D * D;
      float maha = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float pk = 0.f;
#pragma unroll
        for (int l = 0; l < D; ++l) pk += P[k * D + l] * df[l];
        maha += df[k] * pk;
      }
      const float lc = s_c[j] - 0.5f * maha;
      if (lc == -INFINITY) continue;
      if (lc > m) {
        s = s * expf(m - lc) + 1.f;
        m = lc;
      } else {
        s += expf(lc - m);  // NaN lc propagates through s
      }
    }
  }
  if (live) out[b] = (s == 0.f) ? -INFINITY : m + logf(s);
}

template <int D>
void launch(const float* q, int B, int d, const float* thetas,
            const float* precs, const float* lconst, const float* weights,
            int n, float* out, cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  local_logpdf_kernel<D><<<grid, kThreads, 0, stream>>>(
      q, B, d, thetas, precs, lconst, weights, n, out);
}

}  // namespace

extern "C" int pyabc_local_logpdf(const float* q, int B, int d,
                                  const float* thetas, const float* precs,
                                  const float* lconst, const float* weights,
                                  int n, float* out, void* stream_ptr) {
  if (B <= 0) return 0;
  if (n <= 0 || d <= 0 || d > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define PYABC_LOCAL_LOGPDF(DB) \
  launch<DB>(q, B, d, thetas, precs, lconst, weights, n, out, stream)
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
