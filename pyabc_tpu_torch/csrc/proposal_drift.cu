// K15 proposal_drift: the drift guard of LocalTransition's refit cadence,
// with the cadence decision folded into the same launch.
//
// Replaces: pyabc_tpu/transition/util.py::device_proposal_drift and the
// refit decision of pyabc_tpu/inference/util.py:1959-1997 (K = 1; the
// plain twin is kernels/proposal_drift.py).
//
// One block of 1024 threads. Weighted moments of the population the
// carried proposal was fitted on (fit_thetas, fit_w) and of the accepted
// one (new_thetas, new_w), per real dim k:
//   mu = sum w x / max(sum w, 1e-38), var = max(sum w x^2 / max(..) - mu^2, 0),
//   denom = var_f + 1e-12 + 1e-8 mu_f^2,
//   drift = max_k max(|mu_n - mu_f| / sqrt(denom), |var_n - var_f| / denom),
// 0 when either side has no mass, and 0 unless the carried proposal is
// fitted and the generation accepted rows (count = sum of k_mask). Then
// the cadence:
//   tick = gens_since + 1,
//   refit = tick >= every | drift > thr | !fitted,
//   flag = refit & count >= min_count (dim + 1: below it the old params
//     carry forward, util.py:1933-1947),
//   gens_since_next = refit ? 0 : tick,
//   fitted_next = flag | (fitted & count > 0).
// K12 and K13 read `flag` from device memory and return at once when it is
// 0: nothing reaches the host before the chunk's packed fetch. (The port's
// host loop stops before a stopped generation runs, so JAX's ~stopped mask
// has nothing to mask.)
//
// Bound on an H100: bytes, two populations of n (d + 1) floats read once
// (0.6 MB at n 16384, d 4); one block keeps the launch a few microseconds.
//
// K > 1 mode (util.py:1958-1987, a run over several models, each with a
// LocalTransition fit; the plain twin is kernels/proposal_drift.py::
// proposal_drift_models_plain). One block walks the models in order: model
// k's fitted side is its carried params (fit_thetas[k], fit_w[k]), its new
// side the accepted rows of model k (w = m == k & k_mask ? w_norm : 0), its
// count_k = #(k_mask & m == k), and
//   drift = max_k (fitted_k & count_k > 0 ? drift_k : 0),
//   refit = tick >= every | drift > thr | any(!fitted_k & count_k > 0)
//           | !any(fitted_k),
//   flag_k = refit & count_k >= min_count_k,
//   fitted_next_k = flag_k | (fitted_k & count_k > 0),
// and each model's refit weights w_models[k] = m == k ? w_norm : 0 (K12
// reads them; the model's K12 and K13 read flag_k).
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ float block_sum(float v, float* s_warp) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(s_warp[lane]);
    if (lane == 0) s_warp[0] = v;
  }
  __syncthreads();
  return s_warp[0];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
proposal_drift_kernel(const float* __restrict__ fth,
                      const float* __restrict__ fw, int nf,
                      const float* __restrict__ nth,
                      const float* __restrict__ nw,
                      const uint8_t* __restrict__ k_mask, int n, int d,
                      int dim, int min_count,
                      const uint8_t* __restrict__ fitted,
                      const int* __restrict__ gens_since, int every,
                      float thr, float* __restrict__ drift_out,
                      uint8_t* __restrict__ refit_out,
                      int* __restrict__ flag_out,
                      int* __restrict__ gens_next_out,
                      uint8_t* __restrict__ fitted_next_out) {
  __shared__ float s_warp[32];
  __shared__ float s_mom[2][2 * D + 1];
  const int tid = threadIdx.x;
  const float* th[2] = {fth, nth};
  const float* ws[2] = {fw, nw};
  const int rows[2] = {nf, n};
  for (int side = 0; side < 2; ++side) {
    float acc[2 * D + 1];
#pragma unroll
    for (int e = 0; e <= 2 * D; ++e) acc[e] = 0.f;
    for (int i = tid; i < rows[side]; i += kThreads) {
      const float w = ws[side][i];
      acc[2 * D] += w;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (k >= d) break;
        const float x = th[side][(size_t)i * d + k];
        acc[k] += w * x;
        acc[D + k] += w * (x * x);
      }
    }
#pragma unroll
    for (int e = 0; e <= 2 * D; ++e) {
      const float t = block_sum(acc[e], s_warp);
      if (tid == 0) s_mom[side][e] = t;
    }
  }
  float cnt = 0.f;
  for (int i = tid; i < n; i += kThreads) cnt += k_mask[i] ? 1.f : 0.f;
  const int count = (int)block_sum(cnt, s_warp);  // exact below 2^24 rows
  if (tid != 0) return;
  const float sf = s_mom[0][2 * D], sn = s_mom[1][2 * D];
  const float df = sf < 1e-38f ? 1e-38f : sf;
  const float dn = sn < 1e-38f ? 1e-38f : sn;
  float drift = 0.f;
  for (int k = 0; k < dim; ++k) {
    const float mu_f = s_mom[0][k] / df, mu_n = s_mom[1][k] / dn;
    const float var_f = fmaxf(s_mom[0][D + k] / df - mu_f * mu_f, 0.f);
    const float var_n = fmaxf(s_mom[1][D + k] / dn - mu_n * mu_n, 0.f);
    const float denom = var_f + 1e-12f + 1e-8f * (mu_f * mu_f);
    const float mean_shift = fabsf(mu_n - mu_f) / sqrtf(denom);
    const float var_shift = fabsf(var_n - var_f) / denom;
    drift = nan_max(drift, nan_max(mean_shift, var_shift));
  }
  const bool fit = fitted[0] != 0;
  if (!(sf > 0.f && sn > 0.f) || !(fit && count > 0)) drift = 0.f;
  const int tick = gens_since[0] + 1;
  const bool refit = tick >= every || drift > thr || !fit;
  const bool flag = refit && count >= min_count;
  drift_out[0] = drift;
  refit_out[0] = refit ? 1 : 0;
  flag_out[0] = flag ? 1 : 0;
  gens_next_out[0] = refit ? 0 : tick;
  fitted_next_out[0] = (flag || (fit && count > 0)) ? 1 : 0;
}

constexpr int kMaxModels = 8;

// per-model statics, passed by value
struct DriftModels {
  int dim[kMaxModels];
  int min_count[kMaxModels];
};

template <int D>
__global__ void __launch_bounds__(kThreads)
proposal_drift_models_kernel(
    const float* __restrict__ fth, const float* __restrict__ fw, int nf,
    const float* __restrict__ nth, const float* __restrict__ w_norm,
    const uint8_t* __restrict__ k_mask, const int* __restrict__ m, int n,
    int d, int K, DriftModels dm, const uint8_t* __restrict__ fitted,
    const int* __restrict__ gens_since, int every, float thr,
    float* __restrict__ drift_out, uint8_t* __restrict__ refit_out,
    int* __restrict__ flag_out, int* __restrict__ gens_next_out,
    uint8_t* __restrict__ fitted_next_out, float* __restrict__ w_models) {
  __shared__ float s_warp[32];
  __shared__ float s_mom[2][2 * D + 1];
  __shared__ int s_count[kMaxModels];
  const int tid = threadIdx.x;
  float drift = 0.f;
  for (int mk = 0; mk < K; ++mk) {
    for (int i = tid; i < n; i += kThreads)
      w_models[(size_t)mk * n + i] = m[i] == mk ? w_norm[i] : 0.f;
    for (int side = 0; side < 2; ++side) {
      const float* th = side == 0 ? fth + (size_t)mk * nf * d : nth;
      const int rows = side == 0 ? nf : n;
      float acc[2 * D + 1];
#pragma unroll
      for (int e = 0; e <= 2 * D; ++e) acc[e] = 0.f;
      for (int i = tid; i < rows; i += kThreads) {
        const float w =
            side == 0 ? fw[(size_t)mk * nf + i]
                      : ((m[i] == mk && k_mask[i]) ? w_norm[i] : 0.f);
        acc[2 * D] += w;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (k >= d) break;
          const float x = th[(size_t)i * d + k];
          acc[k] += w * x;
          acc[D + k] += w * (x * x);
        }
      }
#pragma unroll
      for (int e = 0; e <= 2 * D; ++e) {
        const float t = block_sum(acc[e], s_warp);
        if (tid == 0) s_mom[side][e] = t;
      }
    }
    float cnt = 0.f;
    for (int i = tid; i < n; i += kThreads)
      cnt += (k_mask[i] && m[i] == mk) ? 1.f : 0.f;
    const int count = (int)block_sum(cnt, s_warp);  // exact below 2^24 rows
    if (tid == 0) {
      s_count[mk] = count;
      const float sf = s_mom[0][2 * D], sn = s_mom[1][2 * D];
      const float df = sf < 1e-38f ? 1e-38f : sf;
      const float dn = sn < 1e-38f ? 1e-38f : sn;
      float dk = 0.f;
      for (int k = 0; k < dm.dim[mk]; ++k) {
        const float mu_f = s_mom[0][k] / df, mu_n = s_mom[1][k] / dn;
        const float var_f = fmaxf(s_mom[0][D + k] / df - mu_f * mu_f, 0.f);
        const float var_n = fmaxf(s_mom[1][D + k] / dn - mu_n * mu_n, 0.f);
        const float denom = var_f + 1e-12f + 1e-8f * (mu_f * mu_f);
        const float mean_shift = fabsf(mu_n - mu_f) / sqrtf(denom);
        const float var_shift = fabsf(var_n - var_f) / denom;
        dk = nan_max(dk, nan_max(mean_shift, var_shift));
      }
      if (!(sf > 0.f && sn > 0.f) || !(fitted[mk] != 0 && count > 0))
        dk = 0.f;
      drift = nan_max(drift, dk);
    }
  }
  if (tid != 0) return;
  bool forced = false, any_fitted = false;
  for (int mk = 0; mk < K; ++mk) {
    const bool fit = fitted[mk] != 0;
    forced = forced || (!fit && s_count[mk] > 0);
    any_fitted = any_fitted || fit;
  }
  const int tick = gens_since[0] + 1;
  const bool refit = tick >= every || drift > thr || forced || !any_fitted;
  for (int mk = 0; mk < K; ++mk) {
    const bool flag = refit && s_count[mk] >= dm.min_count[mk];
    flag_out[mk] = flag ? 1 : 0;
    fitted_next_out[mk] =
        (flag || (fitted[mk] != 0 && s_count[mk] > 0)) ? 1 : 0;
  }
  drift_out[0] = drift;
  refit_out[0] = refit ? 1 : 0;
  gens_next_out[0] = refit ? 0 : tick;
}

}  // namespace

extern "C" int pyabc_proposal_drift(
    const float* fth, const float* fw, int nf, const float* nth,
    const float* nw, const uint8_t* k_mask, int n, int d, int dim,
    int min_count, const uint8_t* fitted, const int* gens_since, int every,
    float thr, float* drift, uint8_t* refit, int* flag, int* gens_next,
    uint8_t* fitted_next, void* stream_ptr) {
  if (nf <= 0 || n <= 0 || d <= 0 || d > 16 || dim <= 0 || dim > d)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define PYABC_DRIFT(DB)                                                    \
  proposal_drift_kernel<DB><<<1, kThreads, 0, stream>>>(                  \
      fth, fw, nf, nth, nw, k_mask, n, d, dim, min_count, fitted,         \
      gens_since, every, thr, drift, refit, flag, gens_next, fitted_next)
  if (d <= 1)
    PYABC_DRIFT(1);
  else if (d <= 2)
    PYABC_DRIFT(2);
  else if (d <= 4)
    PYABC_DRIFT(4);
  else if (d <= 8)
    PYABC_DRIFT(8);
  else
    PYABC_DRIFT(16);
#undef PYABC_DRIFT
  return static_cast<int>(cudaGetLastError());
}

// K > 1: fit_thetas (K, nf, d), fit_w (K, nf), the reservoir's theta (n,
// d), w_norm, k_mask and m (n,); dims and min_counts host arrays of K;
// fitted (K,) -> drift, refit, gens_next (scalars), flag (K,) int32,
// fitted_next (K,) and w_models (K, n).
extern "C" int pyabc_proposal_drift_models(
    const float* fth, const float* fw, int nf, const float* nth,
    const float* w_norm, const uint8_t* k_mask, const int* m, int n, int d,
    int K, const int* dims, const int* min_counts, const uint8_t* fitted,
    const int* gens_since, int every, float thr, float* drift,
    uint8_t* refit, int* flag, int* gens_next, uint8_t* fitted_next,
    float* w_models, void* stream_ptr) {
  if (nf <= 0 || n <= 0 || d <= 0 || d > 16 || K < 1 || K > kMaxModels)
    return static_cast<int>(cudaErrorInvalidValue);
  DriftModels dm{};
  for (int k = 0; k < K; ++k) {
    if (dims[k] <= 0 || dims[k] > d)
      return static_cast<int>(cudaErrorInvalidValue);
    dm.dim[k] = dims[k];
    dm.min_count[k] = min_counts[k];
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define PYABC_DRIFT_M(DB)                                                  \
  proposal_drift_models_kernel<DB><<<1, kThreads, 0, stream>>>(           \
      fth, fw, nf, nth, w_norm, k_mask, m, n, d, K, dm, fitted,           \
      gens_since, every, thr, drift, refit, flag, gens_next, fitted_next, \
      w_models)
  if (d <= 1)
    PYABC_DRIFT_M(1);
  else if (d <= 2)
    PYABC_DRIFT_M(2);
  else if (d <= 4)
    PYABC_DRIFT_M(4);
  else if (d <= 8)
    PYABC_DRIFT_M(8);
  else
    PYABC_DRIFT_M(16);
#undef PYABC_DRIFT_M
  return static_cast<int>(cudaGetLastError());
}
