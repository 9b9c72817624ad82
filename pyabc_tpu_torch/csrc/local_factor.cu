// K13 local_factor: the changed-row factorization of LocalTransition's
// covariance field.
//
// Replaces: pyabc_tpu/transition/local_transition.py::_device_factorize
// and the changed-row path of device_fit_update, with
// transition/util.py::device_chol_guarded_batched and
// ops/select.py::apply_rowwise_blocked (the plain twin is
// kernels/local_factor.py).
//
// One thread per row i of the (n, d, d) field K12 wrote:
//   - refit flag 0 (K15's cadence decision, read from device memory): the
//     previous params are copied verbatim (thetas, weights, cdf, chols,
//     precs, logdets, lconst) and the row counts as unchanged;
//   - incremental: the row is changed when max |cov - Lp Lp^T| over the
//     real block exceeds REUSE_RTOL max(sum of the real diagonal / dim,
//     1e-30), Lp the previous factor (Lp Lp^T summed in index order with
//     the _rn intrinsics, as the plain version's loop, so both mark the same
//     rows); otherwise (the full refit) every row is changed;
//   - a changed row runs the jitter-ladder Cholesky of chol.cuh, the
//     precision L^-T L^-1 (the JAX package inverts cov_used by LU: equal
//     within the stated tolerance) and logdet = 2 sum_{k < dim}
//     log max(L_kk, 1e-38); chol and prec are masked to the real block. A
//     row that fails every rung keeps NaN factors, which the health word's
//     psd_fail bit reports;
//   - an unchanged row keeps the previous chol, prec and logdet;
//   - every row's lconst = log w - 0.5 (dim log 2 pi + logdet) for w > 0,
//     else 0 (finite, so the health word reads it; K14 skips w = 0);
//   - n_changed counts the changed rows (a warp-aggregated atomicAdd).
// A thread that finds its row unchanged returns without the factorization,
// so the JAX package's compaction and while_loop trip count (needed only
// because XLA computes both sides of a select) have no counterpart here.
//
// Bound on an H100: bytes (the field, the previous factors and the new
// ones: ~50 floats a row at d 4, 3.3 MB at n 16384). Each thread keeps its
// d x d matrices in local memory (cached in L1); one row's factorization
// is ~200 dependent flops at d 4.
#include "chol.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

struct Prev {
  const float* thetas;
  const float* weights;
  const float* cdf;
  const float* chols;
  const float* precs;
  const float* logdets;
  const float* lconst;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
local_factor_kernel(int n, int d, int dim, const float* __restrict__ covs,
                    Prev prev, int incremental, float reuse_rtol,
                    const int* __restrict__ flag, float* __restrict__ thetas,
                    float* __restrict__ weights, float* __restrict__ cdf,
                    float* __restrict__ chols, float* __restrict__ precs,
                    float* __restrict__ logdets, float* __restrict__ lconst,
                    int* __restrict__ n_changed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t dd = (size_t)d * d;
  if (flag != nullptr && flag[0] == 0) {
    for (int k = 0; k < d; ++k)
      thetas[(size_t)i * d + k] = prev.thetas[(size_t)i * d + k];
    weights[i] = prev.weights[i];
    cdf[i] = prev.cdf[i];
    for (size_t e = 0; e < dd; ++e) {
      chols[i * dd + e] = prev.chols[i * dd + e];
      precs[i * dd + e] = prev.precs[i * dd + e];
    }
    logdets[i] = prev.logdets[i];
    lconst[i] = prev.lconst[i];
    return;
  }
  float A[D * D];
  for (int a = 0; a < d; ++a)
    for (int b = 0; b < d; ++b) A[a * D + b] = covs[i * dd + a * d + b];
  bool changed = true;
  if (incremental) {
    const float* Lp = prev.chols + i * dd;
    float diff = 0.f;
    for (int a = 0; a < dim; ++a)
      for (int b = 0; b < dim; ++b) {
        float old = 0.f;
        for (int j = 0; j < d; ++j) {
          const float p = __fmul_rn(Lp[a * d + j], Lp[b * d + j]);
          old = j == 0 ? p : __fadd_rn(old, p);
        }
        diff = fmaxf(diff, fabsf(__fsub_rn(A[a * D + b], old)));
      }
    float s = 0.f;
    for (int k = 0; k < dim; ++k) s = k == 0 ? A[0] : __fadd_rn(s, A[k * D + k]);
    s = __fdiv_rn(s, (float)dim);
    const float scale = s < 1e-30f ? 1e-30f : s;
    changed = diff > __fmul_rn(reuse_rtol, scale);
  }
  float ld;
  if (changed) {
    float L[D * D], Li[D * D];
    pyabc::chol_guarded(A, L, d, D);
    pyabc::tri_inverse(L, Li, d, D);
    ld = 0.f;
    for (int k = 0; k < dim; ++k)
      ld += logf(pyabc::clamp_min_keep_nan(L[k * D + k], 1e-38f));
    ld *= 2.f;
    for (int a = 0; a < d; ++a)
      for (int b = 0; b < d; ++b) {
        const bool real = a < dim && b < dim;
        float p = 0.f;
        for (int k = (a > b ? a : b); k < d; ++k)
          p += Li[k * D + a] * Li[k * D + b];
        precs[i * dd + a * d + b] = real ? p : 0.f;
        chols[i * dd + a * d + b] = real ? L[a * D + b] : 0.f;
      }
    logdets[i] = ld;
  } else {
    for (size_t e = 0; e < dd; ++e) {
      chols[i * dd + e] = prev.chols[i * dd + e];
      precs[i * dd + e] = prev.precs[i * dd + e];
    }
    ld = prev.logdets[i];
    logdets[i] = ld;
  }
  const float w = weights[i];
  lconst[i] = w > 0.f ? logf(w) - 0.5f * ((float)dim * PYABC_LOG_2PI + ld)
                      : 0.f;
  const unsigned active = __activemask();
  const unsigned votes = __ballot_sync(active, changed);
  if ((threadIdx.x & 31) == __ffs(active) - 1 && votes != 0u)
    atomicAdd(n_changed, __popc(votes));
}

}  // namespace

// covs (n, d, d) from K12; thetas, weights and cdf are K12's outputs, read
// here for w and overwritten from prev when the flag is 0; prev_* the
// carried params (all may be null when flag is null and incremental 0);
// n_changed (1 int32) zeroed by the caller.
extern "C" int pyabc_local_factor(
    int n, int d, int dim, const float* covs, const float* prev_thetas,
    const float* prev_weights, const float* prev_cdf,
    const float* prev_chols, const float* prev_precs,
    const float* prev_logdets, const float* prev_lconst, int incremental,
    float reuse_rtol, const int* flag, float* thetas, float* weights,
    float* cdf, float* chols, float* precs, float* logdets, float* lconst,
    int* n_changed, void* stream_ptr) {
  if (n <= 0 || d <= 0 || d > 16 || dim <= 0 || dim > d ||
      ((incremental || flag != nullptr) && prev_chols == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Prev prev{prev_thetas, prev_weights, prev_cdf, prev_chols,
                  prev_precs, prev_logdets, prev_lconst};
  const int grid = (n + kThreads - 1) / kThreads;
#define PYABC_FACTOR(DB)                                                   \
  local_factor_kernel<DB><<<grid, kThreads, 0, stream>>>(                 \
      n, d, dim, covs, prev, incremental, reuse_rtol, flag, thetas,       \
      weights, cdf, chols, precs, logdets, lconst, n_changed)
  if (d <= 1)
    PYABC_FACTOR(1);
  else if (d <= 2)
    PYABC_FACTOR(2);
  else if (d <= 4)
    PYABC_FACTOR(4);
  else if (d <= 8)
    PYABC_FACTOR(8);
  else
    PYABC_FACTOR(16);
#undef PYABC_FACTOR
  return static_cast<int>(cudaGetLastError());
}
