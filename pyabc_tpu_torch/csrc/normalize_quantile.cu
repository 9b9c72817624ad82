// K7 normalize_quantile: the importance-weight normalization and the
// weighted-quantile epsilon of a generation step.
//
// Replaces: pyabc_tpu/ops/stats.py::normalize_log_weights and
// weighted_quantile, as used at pyabc_tpu/inference/util.py:1774 and :1871
// (the multigen kernel's normalization, calibration and quantile epsilon).
//
// normalize: log_w masked to -inf where mask == 0, m = max (NaN
//   propagates), w = exp(log_w - m) (m = 0 where it is not finite),
//   w / sum(w) where the sum is positive, else all zeros (the all-masked
//   generation). One block of 1024 threads: three sweeps over n rows.
// quantile: the least v with float32(W(<= v) / W) >= alpha over all n
//   points, by weighted radix selection (select.cuh, weights summed in
//   double). That is the plain version's stable argsort + cumsum + left
//   search, exactly for counts and, for float weights, except where alpha
//   lies within float rounding of a step of the CDF. All-zero weights
//   give the largest point, as the plain search does.
//
// Bound on an H100: bytes, a few KB at the main-path size (n_cap = 1024),
// so both are latency bound: normalize by its three dependent block
// reductions, quantile by its eight dependent launches (four histogram
// passes, four one-column scans).
#include "common.cuh"
#include "select.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ float block_reduce(float v, bool is_max, float* s_warp) {
  v = is_max ? warp_nan_max(v) : warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // s_warp may still be read from an earlier reduction
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s_warp[lane] : (is_max ? -INFINITY : 0.f);
    v = is_max ? warp_nan_max(v) : warp_sum(v);
    if (lane == 0) s_warp[0] = v;
  }
  __syncthreads();
  return s_warp[0];
}

__global__ void __launch_bounds__(kThreads)
normalize_kernel(const float* __restrict__ log_w,
                 const uint8_t* __restrict__ mask, int n,
                 float* __restrict__ out) {
  __shared__ float s_warp[kWarps];
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = (mask != nullptr && !mask[i]) ? -INFINITY : log_w[i];
    m = nan_max(m, v);
  }
  m = block_reduce(m, true, s_warp);
  const float safe = isfinite(m) ? m : 0.f;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = (mask != nullptr && !mask[i]) ? -INFINITY : log_w[i];
    const float e = expf(v - safe);
    out[i] = e;
    s += e;
  }
  s = block_reduce(s, false, s_warp);
  for (int i = threadIdx.x; i < n; i += kThreads)
    out[i] = s > 0.f ? out[i] / s : 0.f;
}

}  // namespace

extern "C" int pyabc_normalize_log_weights(const float* log_w,
                                           const uint8_t* mask, int n,
                                           float* out, void* stream_ptr) {
  if (n <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  normalize_kernel<<<1, kThreads, 0, stream>>>(log_w, mask, n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pyabc_weighted_quantile(const float* points,
                                       const float* weights, int n,
                                       float alpha, void* workspace,
                                       float* out, void* stream_ptr) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const pyabc_select::Source src{points, 1, nullptr, weights, nullptr, 0};
  pyabc_select::select_run(src, n, 1, 1, pyabc_select::kQuantile, alpha, true,
                           workspace, out, stream);
  return static_cast<int>(cudaGetLastError());
}
