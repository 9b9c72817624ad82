// K11 generation_health: the per-generation health word.
//
// Replaces: pyabc_tpu/ops/health.py::generation_health (with
// population_bits, params_unhealthy and eps_stall_update).
//
// Over the accepted rows (k_mask) of the reservoir and the two sets of
// transition parameters (the ones the generation sampled from and the
// refit), one int32 bitmask:
//   bit 0 nan_theta      a kept theta is not finite
//   bit 1 nan_weight     a kept normalized weight is not finite
//   bit 2 nan_distance   a kept distance is not finite
//   bit 3 weight_zero    n_acc > 0 and the kept weights sum to <= 0
//   bit 4 ess_floor      !(ess >= ess_floor * max(n_target, 1)), with
//                        ess = 1 / max(sum of kept w^2, 1e-38)
//   bit 5 acc_collapse   acc_floor > 0 and acc_rate < acc_floor
//   bit 6 eps_stall      the stall counter reaches the window
//   bit 7 psd_fail       a FITTED parameter set holds a non-finite value or
//                        weights summing to <= 0
//   bit 8 eps_nonfinite  eps_g or eps_next is not finite
// and the stall recursion: impr = (eps_prev - eps_g) / max(|eps_prev|,
// 1e-30) (1 when eps_prev is not finite), count = impr < rtol ? count + 1 :
// 0; window <= 0 turns it off (bit and count 0).
//
// K > 1 (n_models > 1, a run over several models, health.py:80-95; the
// kModels instantiation): every parameter tensor is stacked over the
// models, fitted / fitted_next hold n_models flags, and bit 7 is set when
// a FITTED model's slice of either set is bad. n_models = 1 launches the
// single-model instantiation, whose code is the single-model check alone.
//
// Outputs: word (int32), ess (float32), the new stall count (int32). Every
// input scalar (n_acc, acc_rate, fitted flags, epsilons, stall count) is
// read from device memory, so the host reads nothing.
//
// Bound on an H100: bytes (every input read once). One block walks all the
// inputs with a block-wide OR of the flags and a fixed-order sum of the
// weights, so the word and the ESS do not depend on scheduling.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTensors = 16;

struct ParamSet {
  const float* ptr[kMaxTensors];
  long long size[kMaxTensors];
  int count;
  int weights;  // index of the resampling weights in ptr
};

__device__ float block_sum(float v, float* s_warp) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // s_warp may still be read by an earlier call
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  float tot = 0.f;
  if (warp == 0) {
    tot = warp_sum(lane < kWarps ? s_warp[lane] : 0.f);
  }
  return tot;  // valid in thread 0
}

// true when a value of the set is not finite or its weights sum to <= 0;
// kModels: of model `model`'s slice only (each tensor cut into n_models
// equal slices)
template <bool kModels>
__device__ bool params_bad(const ParamSet& p, float* s_warp, int model,
                           int n_models) {
  int bad = 0;
  for (int t = 0; t < p.count; ++t) {
    const long long len = kModels ? p.size[t] / n_models : p.size[t];
    const float* x = kModels ? p.ptr[t] + model * len : p.ptr[t];
    for (long long i = threadIdx.x; i < len; i += kThreads)
      if (!isfinite(x[i])) bad = 1;
  }
  float ws = 0.f;
  const long long wlen =
      kModels ? p.size[p.weights] / n_models : p.size[p.weights];
  const float* w =
      kModels ? p.ptr[p.weights] + model * wlen : p.ptr[p.weights];
  for (long long i = threadIdx.x; i < wlen; i += kThreads)
    ws += w[i];
  bad = __syncthreads_or(bad);
  const float tot = block_sum(ws, s_warp);
  return bad || tot <= 0.f;  // valid in thread 0
}

template <bool kModels>
__global__ void __launch_bounds__(kThreads)
generation_health_kernel(const float* __restrict__ theta, int n_cap, int d,
                         const uint8_t* __restrict__ k_mask,
                         const float* __restrict__ w_norm,
                         const float* __restrict__ d_new,
                         const int* __restrict__ n_acc,
                         const float* __restrict__ acc_rate,
                         ParamSet params, ParamSet params_next,
                         int n_models,
                         const uint8_t* __restrict__ fitted,
                         const uint8_t* __restrict__ fitted_next,
                         const float* __restrict__ eps_g,
                         const float* __restrict__ eps_next,
                         const float* __restrict__ eps_prev,
                         const int* __restrict__ stall_count,
                         float ess_min, float acc_floor, int stall_window,
                         float stall_rtol, int* __restrict__ word_out,
                         float* __restrict__ ess_out,
                         int* __restrict__ stall_out) {
  __shared__ float s_warp[kWarps];
  int theta_bad = 0, w_bad = 0, d_bad = 0;
  for (int i = threadIdx.x; i < n_cap * d; i += kThreads)
    if (k_mask[i / d] && !isfinite(theta[i])) theta_bad = 1;
  float ws = 0.f, ws2 = 0.f;
  for (int i = threadIdx.x; i < n_cap; i += kThreads) {
    if (!k_mask[i]) continue;
    const float w = w_norm[i];
    if (!isfinite(w)) w_bad = 1;
    if (!isfinite(d_new[i])) d_bad = 1;
    ws += w;
    ws2 += w * w;
  }
  theta_bad = __syncthreads_or(theta_bad);
  w_bad = __syncthreads_or(w_bad);
  d_bad = __syncthreads_or(d_bad);
  const float w_sum = block_sum(ws, s_warp);
  const float w2_sum = block_sum(ws2, s_warp);
  // a never-fitted set is zeros by construction and is not checked (the
  // flags are the same for every thread, so the block stays together)
  bool bad = false;
  if (!kModels) {
    const bool fit0 = fitted[0] != 0, fit1 = fitted_next[0] != 0;
    const bool bad0 = fit0 ? params_bad<false>(params, s_warp, 0, 1) : false;
    const bool bad1 =
        fit1 ? params_bad<false>(params_next, s_warp, 0, 1) : false;
    bad = (fit0 && bad0) || (fit1 && bad1);
  } else {
    for (int k = 0; k < n_models; ++k) {
      if (fitted[k] != 0 && params_bad<true>(params, s_warp, k, n_models))
        bad = true;
      if (fitted_next[k] != 0 &&
          params_bad<true>(params_next, s_warp, k, n_models))
        bad = true;
    }
  }
  if (threadIdx.x != 0) return;

  const float ess = 1.f / nan_max(w2_sum, 1e-38f);  // a NaN weight stays
  int word = 0;
  if (theta_bad) word |= 1 << 0;
  if (w_bad) word |= 1 << 1;
  if (d_bad) word |= 1 << 2;
  if (n_acc[0] > 0 && w_sum <= 0.f) word |= 1 << 3;
  if (!(ess >= ess_min)) word |= 1 << 4;
  if (acc_floor > 0.f && acc_rate[0] < acc_floor) word |= 1 << 5;
  if (bad) word |= 1 << 7;
  if (!isfinite(eps_g[0]) || !isfinite(eps_next[0])) word |= 1 << 8;
  int count = 0;
  if (stall_window > 0) {
    const float prev = eps_prev[0];
    const float impr =
        isfinite(prev) ? (prev - eps_g[0]) / fmaxf(fabsf(prev), 1e-30f) : 1.f;
    count = impr < stall_rtol ? stall_count[0] + 1 : 0;
    if (count >= stall_window) word |= 1 << 6;
  }
  word_out[0] = word;
  ess_out[0] = ess;
  stall_out[0] = count;
}

bool fill(ParamSet* p, int count, const void* const* ptrs,
          const long long* sizes, int weights) {
  if (count <= 0 || count > kMaxTensors || weights < 0 || weights >= count)
    return false;
  for (int t = 0; t < count; ++t) {
    p->ptr[t] = static_cast<const float*>(ptrs[t]);
    p->size[t] = sizes[t];
  }
  p->count = count;
  p->weights = weights;
  return true;
}

}  // namespace

// params / params_next: host arrays of `count` device pointers to float32
// tensors and their element counts; `weights` indexes the resampling
// weights among them.
extern "C" int pyabc_generation_health(
    const float* theta, int n_cap, int d, const uint8_t* k_mask,
    const float* w_norm, const float* d_new, const int* n_acc,
    const float* acc_rate, int count0, const void* const* ptrs0,
    const long long* sizes0, int weights0, int count1,
    const void* const* ptrs1, const long long* sizes1, int weights1,
    int n_models, const uint8_t* fitted, const uint8_t* fitted_next,
    const float* eps_g, const float* eps_next, const float* eps_prev,
    const int* stall_count,
    float ess_min, float acc_floor, int stall_window, float stall_rtol,
    int* word_out, float* ess_out, int* stall_out, void* stream_ptr) {
  ParamSet p0, p1;
  if (!fill(&p0, count0, ptrs0, sizes0, weights0) ||
      !fill(&p1, count1, ptrs1, sizes1, weights1) || n_cap < 0 || d <= 0 ||
      n_models < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int t = 0; t < count0 + count1; ++t) {
    const long long size = t < count0 ? sizes0[t] : sizes1[t - count0];
    if (size % n_models != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto kernel = n_models > 1 ? generation_health_kernel<true>
                             : generation_health_kernel<false>;
  kernel<<<1, kThreads, 0, stream>>>(
      theta, n_cap, d, k_mask, w_norm, d_new, n_acc, acc_rate, p0, p1,
      n_models, fitted, fitted_next, eps_g, eps_next, eps_prev, stall_count,
      ess_min, acc_floor, stall_window, stall_rtol, word_out, ess_out,
      stall_out);
  return static_cast<int>(cudaGetLastError());
}
