// K5 pnorm_accept_weight: distance, accept test and importance log-weight
// of one proposal round.
//
// Replaces: pyabc_tpu/distance/pnorm.py::PNormDistance.device_fn composed
// with pyabc_tpu/acceptor/acceptor.py::UniformAcceptor.device_fn and the
// log-weight sum of pyabc_tpu/inference/util.py::_lane_transition.
//
// Per lane b with sum-stat row x (S,):
//   d = (sum_k (w_k |x_k - x0_k|)^p)^(1/p)   (p = inf: max_k, NaN kept)
// then the accept test and log weight of accept_epilogue.cuh (shared with
// K25): accept = valid & (d <= eps) [& (d <= hist_min)], the log weight of
// one model or, with m, model_logits and log_model_factor given (K > 1,
// util.py:399-406), of the lane's model; with null pointers the kernel
// does exactly the single-model work. eps and hist_min arrive as device
// scalars (pointers): the threshold is a device tensor carried from the
// previous generation, never a host float.
//
// Bound on an H100: bytes. One read of the (B, S) sum stats dominates, and
// the design reads each row once with one warp per lane (32 consecutive
// floats per load), reduces in registers and writes the three outputs
// from lane 0 of the warp.
//
// Numerics: p=2 takes sqrtf of the warp-reduced sum; JAX takes
// pow(sum, 0.5) after a sum in another order, so the two differ by a few
// ulp and accept flags are compared only where |d - eps| exceeds that.
#include "accept_epilogue.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pnorm_accept_weight_kernel(const float* __restrict__ ss, int B, int S,
                           const float* __restrict__ x0,
                           const float* __restrict__ w, float p,
                           const pyabc::AcceptTerms terms) {
  const int row_i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row_i >= B) return;  // whole warps exit together
  const float* row = ss + (size_t)row_i * S;
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
  float d;
  if (p_inf || p == 1.f)
    d = acc;
  else if (p == 2.f)
    d = sqrtf(acc);
  else
    d = powf(acc, 1.f / p);
  pyabc::accept_epilogue(terms, row_i, d);
}

}  // namespace

extern "C" int pyabc_pnorm_accept_weight(
    const float* ss, int B, int S, const float* x0, const float* w, float p,
    const uint8_t* valid, const float* eps, const float* hist_min,
    const float* logpri, const float* logq, float log_offset, const int* m,
    const float* model_logits, const float* log_model_factor, float* d_out,
    uint8_t* acc_out, float* logw_out, void* stream_ptr) {
  if (B <= 0) return 0;
  if (m != nullptr && (model_logits == nullptr ||
                       log_model_factor == nullptr || logpri == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows_per_block = kThreads / 32;
  const int grid = (B + rows_per_block - 1) / rows_per_block;
  const pyabc::AcceptTerms terms{valid,      eps,     hist_min,
                                 logpri,     logq,    log_offset,
                                 m,          model_logits,
                                 log_model_factor,    d_out,
                                 acc_out,    logw_out};
  pnorm_accept_weight_kernel<<<grid, kThreads, 0, stream>>>(ss, B, S, x0, w,
                                                             p, terms);
  return static_cast<int>(cudaGetLastError());
}
