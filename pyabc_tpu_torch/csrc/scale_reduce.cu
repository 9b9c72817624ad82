// K9 scale_reduce: the adaptive distance refit of a generation step.
//
// Replaces: pyabc_tpu/distance/pnorm.py::AdaptivePNormDistance::
// device_record_reduce (the scale over the record ring) and
// device_weight_update, distance/scale.py::_device_scale_impls (all 13
// built-in scale functions) and the distance recompute under the new
// weights at pyabc_tpu/inference/util.py:1847.
//
// On samples (n, S) under valid (n,) against x0 (S,), per column c:
//   medians (median, MAD, combined MAD, MAD to the observation): invalid
//     rows and NaN values are left out, then jnp.nanquantile's linear
//     method at 0.5 (low (1 - hw) + high hw, q = 0.5 (count - 1) in
//     float32), by radix selection of the two order statistics
//     (select.cuh); MAD selects again over |x - median| (or |x - x0|);
//     an empty column gives NaN;
//   means (mean, std, mean / std deviation to the mean or to x0, bias,
//     rmsd, span): sums over the valid rows divided by max(count, 1); a NaN
//     in a valid row propagates, as the plain versions' masked sums do;
// then the weights w = 1 / scale where scale > 0 (else 0), clipped at
// max_weight_ratio times the least positive weight, normalized to mean 1;
// then the weighted p-norm distances of the rows (n_rows, S) under w.
//
// Bound on an H100: bytes. The ring (rec_cap x S floats, 1.3 MB at the
// main-path size) is read once per histogram pass (eight passes for MAD),
// the rows once. The design is simple and split in launches: each
// selection is 4 histogram passes (blocks of 2048 rows of one column,
// shared-memory bins, global atomics) and 4 one-block scans; the moments
// are one block per column; one block finishes the scales and weights;
// the distances take a warp per row.
#include "common.cuh"
#include "select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMoments = 6;  // mean, std, mean_ad, span, ad_obs, std_obs

// scale codes: the order of pyabc_tpu_torch/kernels/scale_reduce.py
enum ScaleCode {
  kMad = 0, kMeanAd, kStd, kSpan, kMean, kMedian, kBias, kRmsd, kMadObs,
  kMeanAdObs, kCombinedMad, kCombinedMeanAd, kStdObs
};

__device__ __forceinline__ float nan_min(float a, float b) {
  if (isnan(a) || isnan(b)) return a + b;
  return fminf(a, b);
}

__device__ float block_reduce(float v, int op, float* s_warp) {
  // op 0 sum, 1 max (NaN propagates), 2 min (NaN propagates)
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = op == 0 ? v + o : op == 1 ? nan_max(v, o) : nan_min(v, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float ident = op == 0 ? 0.f : op == 1 ? -INFINITY : INFINITY;
    v = lane < nw ? s_warp[lane] : ident;
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = op == 0 ? v + o : op == 1 ? nan_max(v, o) : nan_min(v, o);
    }
    if (lane == 0) s_warp[0] = v;
  }
  __syncthreads();
  return s_warp[0];
}

__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ samples, int n, int S,
               const uint8_t* __restrict__ valid,
               const float* __restrict__ x0, float* __restrict__ mom) {
  __shared__ float s_warp[32];
  const int c = blockIdx.x;
  float cnt = 0.f, s = 0.f, mx = -INFINITY, mn = INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!valid[i]) continue;
    const float x = samples[(size_t)i * S + c];
    cnt += 1.f;
    s += x;
    mx = nan_max(mx, x);
    mn = nan_min(mn, x);
  }
  cnt = block_reduce(cnt, 0, s_warp);
  s = block_reduce(s, 0, s_warp);
  mx = block_reduce(mx, 1, s_warp);
  mn = block_reduce(mn, 2, s_warp);
  const float nf = fmaxf(cnt, 1.f);
  const float mean = s / nf;
  const float xo = x0[c];
  float s2 = 0.f, sad = 0.f, sao = 0.f, so2 = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!valid[i]) continue;
    const float x = samples[(size_t)i * S + c];
    const float dv = x - mean, dv0 = x - xo;
    s2 += dv * dv;
    sad += fabsf(dv);
    sao += fabsf(dv0);
    so2 += dv0 * dv0;
  }
  s2 = block_reduce(s2, 0, s_warp);
  sad = block_reduce(sad, 0, s_warp);
  sao = block_reduce(sao, 0, s_warp);
  so2 = block_reduce(so2, 0, s_warp);
  if (threadIdx.x == 0) {
    float* m = mom + (size_t)c * kMoments;
    m[0] = mean;
    m[1] = sqrtf(s2 / nf);
    m[2] = sad / nf;
    m[3] = mx - mn;
    m[4] = sao / nf;
    m[5] = sqrtf(so2 / nf);
  }
}

__device__ float scale_of(int code, int c, const float* med, const float* sel2,
                          const float* mom, const float* x0) {
  const float* m = mom + (size_t)c * kMoments;
  switch (code) {
    case kMad:
    case kMadObs:
      return sel2[c];
    case kMeanAd:
      return m[2];
    case kStd:
      return m[1];
    case kSpan:
      return m[3];
    case kMean:
      return m[0];
    case kMedian:
      return med[c];
    case kBias:
      return fabsf(m[0] - x0[c]);
    case kRmsd: {
      const float b = fabsf(m[0] - x0[c]), sd = m[1];
      return sqrtf(b * b + sd * sd);
    }
    case kMeanAdObs:
      return m[4];
    case kCombinedMad:
      return sel2[c] + fabsf(med[c] - x0[c]);
    case kCombinedMeanAd:
      return m[2] + fabsf(m[0] - x0[c]);
    case kStdObs:
      return m[5];
  }
  return NAN;
}

// One block: scales, 1 / scale, the ratio clip, mean-1 normalization.
__global__ void __launch_bounds__(1024)
finish_kernel(int code, int S, const float* __restrict__ med,
              const float* __restrict__ sel2, const float* __restrict__ mom,
              const float* __restrict__ x0, float max_ratio, int normalize,
              float* __restrict__ scale_out, float* __restrict__ w_out) {
  __shared__ float s_warp[32];
  float wmin = INFINITY;
  for (int c = threadIdx.x; c < S; c += blockDim.x) {
    const float sc = scale_of(code, c, med, sel2, mom, x0);
    scale_out[c] = sc;
    const float w = sc > 0.f ? 1.f / sc : 0.f;
    w_out[c] = w;
    if (w > 0.f) wmin = fminf(wmin, w);
  }
  if (max_ratio > 0.f) {
    wmin = block_reduce(wmin, 2, s_warp);
    const float cap = wmin * max_ratio;
    for (int c = threadIdx.x; c < S; c += blockDim.x)
      w_out[c] = fminf(w_out[c], cap);
  }
  if (normalize) {
    float s = 0.f;
    for (int c = threadIdx.x; c < S; c += blockDim.x) s += w_out[c];
    s = block_reduce(s, 0, s_warp);
    if (s > 0.f) {
      const float f = (float)S / s;
      for (int c = threadIdx.x; c < S; c += blockDim.x)
        w_out[c] = w_out[c] * f;
    }
  }
}

// Weighted p-norm of each row against x0: one warp per row (as K5).
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ rows, int n_rows, int S,
            const float* __restrict__ x0, const float* __restrict__ w,
            float p, float* __restrict__ d_out) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;
  const float* row = rows + (size_t)r * S;
  const bool p_inf = isinf(p);
  float acc = 0.f;
  for (int k = lane; k < S; k += 32) {
    const float diff = w[k] * fabsf(row[k] - x0[k]);
    if (p_inf)
      acc = nan_max(acc, diff);
    else if (p == 1.f)
      acc += diff;
    else if (p == 2.f)
      acc += diff * diff;
    else
      acc += powf(diff, p);
  }
  acc = p_inf ? warp_nan_max(acc) : warp_sum(acc);
  if (lane != 0) return;
  if (p_inf || p == 1.f)
    d_out[r] = acc;
  else if (p == 2.f)
    d_out[r] = sqrtf(acc);
  else
    d_out[r] = powf(acc, 1.f / p);
}

}  // namespace

// stats: 8 S floats of scratch (medians, second selections, moments).
extern "C" int pyabc_scale_reduce(const float* samples, int n, int S,
                                  const uint8_t* valid, const float* x0,
                                  int code, float max_ratio, int normalize,
                                  const float* rows, int n_rows, float p,
                                  void* workspace, float* stats,
                                  float* scale_out, float* w_out, float* d_out,
                                  void* stream_ptr) {
  if (S <= 0 || code < 0 || code > kStdObs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* med = stats;
  float* sel2 = stats + S;
  float* mom = stats + 2 * S;
  const bool median_x = code == kMad || code == kMedian || code == kCombinedMad;
  const bool second = code == kMad || code == kCombinedMad || code == kMadObs;
  if (median_x) {
    const pyabc_select::Source src{samples, S, valid, nullptr, nullptr, 1};
    pyabc_select::select_run(src, n, S, 2, pyabc_select::kMedian, 0.5f, false,
                             workspace, med, stream);
  }
  if (second) {
    const pyabc_select::Source src{samples, S, valid, nullptr,
                                   code == kMadObs ? x0 : med, 1};
    pyabc_select::select_run(src, n, S, 2, pyabc_select::kMedian, 0.5f, false,
                             workspace, sel2, stream);
  }
  if (!median_x && !second)
    moments_kernel<<<S, kThreads, 0, stream>>>(samples, n, S, valid, x0, mom);
  finish_kernel<<<1, 1024, 0, stream>>>(code, S, med, sel2, mom, x0,
                                        max_ratio, normalize, scale_out,
                                        w_out);
  if (rows != nullptr && n_rows > 0) {
    const int per_block = kThreads / 32;
    rows_kernel<<<(n_rows + per_block - 1) / per_block, kThreads, 0,
                  stream>>>(rows, n_rows, S, x0, w_out, p, d_out);
  }
  return static_cast<int>(cudaGetLastError());
}
