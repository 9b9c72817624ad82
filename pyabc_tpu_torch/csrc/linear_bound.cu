// K18 transformed mode, its per-generation operands: the coefficient rows
// and the null-space projectors of the transformed-space prefix bound.
//
// Replaces: pyabc_tpu/ops/fit.py::linear_bound_prepare (:186), reached
// from pyabc_tpu/distance/pnorm.py::_transformed_bound_fn (:279) and
// inference/util.py:888-893 once a generation.
//
// With a fitted linear transform the weighted transformed difference of a
// row is (x - x0)^T At, At[c, :] = (W[c, :] / sd[c]) * w (float32, in that
// order, as the JAX package forms it). A trajectory prefix fixes v, the
// sum over its columns; the rest lies in the span of the remaining
// segments' rows of At, so min ||v + r||^2 = v^T P_j v with P_j the
// projector onto the null space of the suffix Gram G_j = At[imap[j:]]^T
// At[imap[j:]] after j segments (G_{n_seg} = 0: P = I).
//
// One block a suffix j = 0..n_seg: a thread an entry of G_j (C' x C',
// C' <= 8), summed over the suffix's rows in emission order in float64;
// then one thread runs a cyclic Jacobi eigensolve of G_j in float64 (C' is
// a few: a warp would idle), counts as null each eigenvalue <= 1e-6
// max(lambda_max, 1e-30) (NULL_EIG_RTOL) and writes P_j = Q diag(null)
// Q^T in float32. Block 0 also writes At. Eigenvalues near the threshold
// may fall on the other side than in XLA's eigh: the bound stays sound
// either way (a reachable direction only shrinks it).
//
// Bound on an H100: launch latency; (n_seg + 1) C'^2 |suffix| float64
// multiply-adds and a few Jacobi sweeps of a C' x C' matrix.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kMaxC = 8;
constexpr double kNullRtol = 1e-6;

__device__ __forceinline__ float at_value(const float* W, const float* sd,
                                          const float* w, int r, int a,
                                          int C) {
  return __fmul_rn(__fdiv_rn(W[r * C + a], sd[r]), w[a]);
}

// cyclic Jacobi on the symmetric (C, C) G: G's diagonal ends as the
// eigenvalues, Q's columns as the eigenvectors
__device__ void jacobi(double (&G)[kMaxC][kMaxC], double (&Q)[kMaxC][kMaxC],
                       int C) {
  for (int i = 0; i < C; ++i)
    for (int j = 0; j < C; ++j) Q[i][j] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 64; ++sweep) {
    double off = 0.0, diag = 0.0;
    for (int i = 0; i < C; ++i) {
      diag += G[i][i] * G[i][i];
      for (int j = i + 1; j < C; ++j) off += G[i][j] * G[i][j];
    }
    if (off <= 1e-32 * diag || off == 0.0) break;
    for (int p = 0; p < C - 1; ++p) {
      for (int q = p + 1; q < C; ++q) {
        const double gpq = G[p][q];
        if (gpq == 0.0) continue;
        const double theta = (G[q][q] - G[p][p]) / (2.0 * gpq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                         (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < C; ++k) {  // G <- G R (columns p, q)
          const double gkp = G[k][p], gkq = G[k][q];
          G[k][p] = c * gkp - s * gkq;
          G[k][q] = s * gkp + c * gkq;
        }
        for (int k = 0; k < C; ++k) {  // G <- R^T G (rows p, q)
          const double gpk = G[p][k], gqk = G[q][k];
          G[p][k] = c * gpk - s * gqk;
          G[q][k] = s * gpk + c * gqk;
        }
        for (int k = 0; k < C; ++k) {  // Q <- Q R
          const double qkp = Q[k][p], qkq = Q[k][q];
          Q[k][p] = c * qkp - s * qkq;
          Q[k][q] = s * qkp + c * qkq;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
linear_bound_kernel(const float* __restrict__ W, const float* __restrict__ sd,
                    const float* __restrict__ w,
                    const int* __restrict__ imap, int S, int C, int n_seg,
                    int seg_size, float* __restrict__ At,
                    float* __restrict__ proj) {
  const int j = blockIdx.x;
  if (j == 0)
    for (int e = threadIdx.x; e < S * C; e += blockDim.x)
      At[e] = at_value(W, sd, w, e / C, e % C, C);
  __shared__ double G[kMaxC][kMaxC];
  for (int e = threadIdx.x; e < kMaxC * kMaxC; e += blockDim.x) {
    const int a = e / kMaxC, b = e % kMaxC;
    double s = 0.0;
    if (a < C && b < C)
      for (int k = j * seg_size; k < n_seg * seg_size; ++k) {
        const int r = imap[k];
        s += (double)at_value(W, sd, w, r, a, C) *
             (double)at_value(W, sd, w, r, b, C);
      }
    G[a][b] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  double g[kMaxC][kMaxC], Q[kMaxC][kMaxC];
  for (int a = 0; a < kMaxC; ++a)
    for (int b = 0; b < kMaxC; ++b) g[a][b] = G[a][b];
  jacobi(g, Q, C);
  double lam_max = 1e-30;
  for (int k = 0; k < C; ++k) lam_max = fmax(lam_max, g[k][k]);
  bool null[kMaxC];
  for (int k = 0; k < C; ++k) null[k] = g[k][k] <= kNullRtol * lam_max;
  float* P = proj + (size_t)j * C * C;
  for (int a = 0; a < C; ++a)
    for (int b = 0; b < C; ++b) {
      double s = 0.0;
      for (int k = 0; k < C; ++k)
        if (null[k]) s += Q[a][k] * Q[b][k];
      P[a * C + b] = (float)s;
    }
}

}  // namespace

// W (S, C), sd (S,), w (C,) -> At (S, C), proj (n_seg + 1, C, C); imap
// (n_seg, seg_size) int32 the emission map
extern "C" int pyabc_linear_bound(const float* W, const float* sd,
                                  const float* w, const int* imap, int S,
                                  int C, int n_seg, int seg_size, float* At,
                                  float* proj, void* stream_ptr) {
  if (C < 1 || C > kMaxC || n_seg < 1 || seg_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  linear_bound_kernel<<<n_seg + 1, kThreads, 0, stream>>>(
      W, sd, w, imap, S, C, n_seg, seg_size, At, proj);
  return static_cast<int>(cudaGetLastError());
}
