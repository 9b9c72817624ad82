// K21a kernel_accept: noise-model log-density, stochastic accept test and
// importance log-weight of one proposal round (the stochastic twin of K5).
//
// Replaces: pyabc_tpu/distance/kernel.py::IndependentNormalKernel.device_fn
// composed with pyabc_tpu/acceptor/acceptor.py::StochasticAcceptor.
// device_fn and the log-weight sums of pyabc_tpu/inference/util.py::
// _lane_prior / _lane_transition.
//
// Per lane b with sum-stat row x (S,):
//   v = -0.5 sum_s ((log 2 pi + log var_s) + (x_s - x0_s)^2 / var_s)
//   logv = log(max(v, 1e-30)) for a SCALE_LIN kernel, else v
//   log_ratio = (logv - pdf_norm) / T
//   accept = valid & (log u < log_ratio), u the lane's uniform on the
//            accept stream (word 0 of block 0, philox.cuh)
//   log_acc_w = (log_ratio > 0 && apply_iw) ? log_ratio : 0
//   log w = log_acc_w (prior rounds), (logpri + log_acc_w) - logq
//           (transition rounds), -inf where the lane is invalid.
// T and pdf_norm arrive as device scalars (pointers): the temperature and
// the norm are device tensors carried from the previous generation, never
// host floats.
//
// Bound on an H100: bytes. One read of the (B, S) sum stats dominates
// (S = 15 at config 4: 60 bytes a lane against ~45 flops and one Philox
// block). One thread per lane keeps its row's sum in a register; the row
// is read with a stride of S floats, which the L1 serves.
//
// Numerics: the sum runs in order over s, the JAX package's reduction in
// another order, so v differs by a few ulp; accept flags are compared
// where log u lies clear of log_ratio.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
kernel_accept_kernel(const float* __restrict__ ss, int B, int S,
                     const float* __restrict__ x0,
                     const float* __restrict__ var,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ temp,
                     const float* __restrict__ pdf_norm, int lin,
                     int apply_iw, const float* __restrict__ logpri,
                     const float* __restrict__ logq, uint32_t k0,
                     uint32_t k1, uint32_t gen, uint32_t tag,
                     uint32_t max_rounds, const int* __restrict__ counters,
                     float* __restrict__ v_out, uint8_t* __restrict__ acc_out,
                     float* __restrict__ logw_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* row = ss + (size_t)b * S;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float diff = row[s] - x0[s];
    acc += (PYABC_LOG_2PI + logf(var[s])) + diff * diff / var[s];
  }
  const float v = -0.5f * acc;
  const float logv = lin ? logf(nan_max(v, 1e-30f)) : v;
  const float log_ratio = (logv - pdf_norm[0]) / temp[0];
  const pyabc::PhiloxLane rng = pyabc::philox_lane(
      k0, k1, (uint32_t)b, gen, tag, max_rounds, (uint32_t)counters[1]);
  const bool ok = valid[b] != 0;
  const bool a = ok && (logf(rng.uniform(0, 0)) < log_ratio);
  const float log_acc_w = (log_ratio > 0.f && apply_iw) ? log_ratio : 0.f;
  float lw = log_acc_w;
  if (!ok)
    lw = -INFINITY;
  else if (logpri != nullptr)
    lw = (logpri[b] + log_acc_w) - logq[b];
  v_out[b] = v;
  acc_out[b] = a ? 1 : 0;
  logw_out[b] = lw;
}

}  // namespace

extern "C" int pyabc_kernel_accept(
    const float* ss, int B, int S, const float* x0, const float* var,
    const uint8_t* valid, const float* temp, const float* pdf_norm, int lin,
    int apply_iw, const float* logpri, const float* logq, unsigned k0,
    unsigned k1, unsigned gen, unsigned tag, unsigned max_rounds,
    const int* counters, float* v_out, uint8_t* acc_out, float* logw_out,
    void* stream_ptr) {
  if (B <= 0) return 0;
  if (counters == nullptr || (logpri == nullptr) != (logq == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = (B + kThreads - 1) / kThreads;
  kernel_accept_kernel<<<grid, kThreads, 0, stream>>>(
      ss, B, S, x0, var, valid, temp, pdf_norm, lin, apply_iw, logpri, logq,
      k0, k1, gen, tag, max_rounds, counters, v_out, acc_out, logw_out);
  return static_cast<int>(cudaGetLastError());
}
