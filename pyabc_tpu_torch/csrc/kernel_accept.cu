// K21a / K21c kernel_accept: noise-model log-density, stochastic accept
// test and importance log-weight of one proposal round (the stochastic
// twin of K5).
//
// Replaces: the device_fn of every device-compatible noise model of
// pyabc_tpu/distance/kernel.py (K21a IndependentNormalKernel :176; K21c
// NormalKernel :124, IndependentLaplaceKernel :254, BinomialKernel :314,
// PoissonKernel :370, NegativeBinomialKernel :450 in both
// parameterizations) composed with pyabc_tpu/acceptor/acceptor.py::
// StochasticAcceptor.device_fn and the log-weight sums of
// pyabc_tpu/inference/util.py::_lane_prior / _lane_transition.
//
// Per lane b with sum-stat row x (S,):
//   total = scale * sum_s term(x_s, x0_s, par_s) (noise.cuh), or for the
//           full normal -0.5 ((S log 2 pi + logdet) + diff' P diff)
//   v = exp(total) for a SCALE_LIN binomial, Poisson, negative-binomial or
//       full normal kernel (their JAX device_fn), else total
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
// Bound on an H100: bytes for the normal and Laplace families (one read of
// the (B, S) sum stats: 80 bytes a lane at S = 20 against ~100 flops and
// one Philox block); the count families add two or three lgammaf a entry,
// which stay under the bytes' time. One thread per lane keeps its row's
// sum in a register; the row is read with a stride of S floats, which the
// L1 serves. The elementwise kernel is templated on the family, so each
// instantiation carries only its own term.
//
// The full normal (NormalKernel) has a kernel of its own: a block of
// kNormalThreads lanes stages the (S, S) precision and x0 in shared memory
// once, each thread its diff column beside them (laid out [s][thread], so
// a warp's accesses fall in distinct banks), and sums the quadratic form
// in a fixed order: r_j = sum_i diff_i P_ij, then sum_j r_j diff_j. S is
// refused above what the 227 KB of shared memory hold (the wrapper checks
// first: kernels/kernel_accept.py::MAX_NORMAL_S).
//
// Numerics: the sums run in order over s, the JAX package's reduction in
// another order, so v differs by a few ulp (lgammaf against XLA's lgamma
// by a few more); accept flags are compared where log u lies clear of
// log_ratio.
#include "noise.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNormalThreads = 128;
constexpr int kSmemBytes = 232448;

struct AcceptArgs {
  int B;
  const uint8_t* valid;
  const float* temp;
  const float* pdf_norm;
  int lin, exp_lin, apply_iw;
  const float* logpri;
  const float* logq;
  uint32_t k0, k1, gen, tag, max_rounds;
  const int* counters;
  float* v_out;
  uint8_t* acc_out;
  float* logw_out;
};

// the accept test and the log weight of lane b with log-density total
__device__ __forceinline__ void accept_lane(const AcceptArgs& a, int b,
                                            float total) {
  const float v = a.exp_lin ? expf(total) : total;
  const float logv = a.lin ? logf(nan_max(v, 1e-30f)) : v;
  const float log_ratio = (logv - a.pdf_norm[0]) / a.temp[0];
  const pyabc::PhiloxLane rng = pyabc::philox_lane(
      a.k0, a.k1, (uint32_t)b, a.gen, a.tag, a.max_rounds,
      (uint32_t)a.counters[1]);
  const bool ok = a.valid[b] != 0;
  const bool acc = ok && (logf(rng.uniform(0, 0)) < log_ratio);
  const float log_acc_w = (log_ratio > 0.f && a.apply_iw) ? log_ratio : 0.f;
  float lw = log_acc_w;
  if (!ok)
    lw = -INFINITY;
  else if (a.logpri != nullptr)
    lw = (a.logpri[b] + log_acc_w) - a.logq[b];
  a.v_out[b] = v;
  a.acc_out[b] = acc ? 1 : 0;
  a.logw_out[b] = lw;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
kernel_accept_kernel(const float* __restrict__ ss, int S,
                     const float* __restrict__ x0,
                     const float* __restrict__ par, AcceptArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const float* row = ss + (size_t)b * S;
  float acc = 0.f;
  for (int s = 0; s < S; ++s)
    acc = __fadd_rn(acc, pyabc::noise_term<F>(row[s], x0[s], par[s]));
  accept_lane(a, b, __fmul_rn(pyabc::noise_scale<F>(), acc));
}

// params: the (S, S) precision row-major, then logdet, then S log 2 pi
__global__ void __launch_bounds__(kNormalThreads)
normal_accept_kernel(const float* __restrict__ ss, int S,
                     const float* __restrict__ x0,
                     const float* __restrict__ params, AcceptArgs a) {
  extern __shared__ float smem[];
  float* prec = smem;                    // S * S
  float* sx0 = prec + S * S;             // S
  float* diff = sx0 + S;                 // S * kNormalThreads
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) prec[i] = params[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) sx0[i] = x0[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const float* row = ss + (size_t)b * S;
  float* my = diff + threadIdx.x;
  for (int s = 0; s < S; ++s)
    my[s * kNormalThreads] = __fsub_rn(row[s], sx0[s]);
  float quad = 0.f;
  for (int j = 0; j < S; ++j) {
    float r = 0.f;
    for (int i = 0; i < S; ++i)
      r = __fadd_rn(r, __fmul_rn(my[i * kNormalThreads], prec[i * S + j]));
    quad = __fadd_rn(quad, __fmul_rn(r, my[j * kNormalThreads]));
  }
  const float logdet = params[S * S], c = params[S * S + 1];
  accept_lane(a, b, __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(c, logdet), quad)));
}

template <int F>
int launch_family(const float* ss, int S, const float* x0, const float* par,
                  const AcceptArgs& a, cudaStream_t stream) {
  const int grid = (a.B + kThreads - 1) / kThreads;
  kernel_accept_kernel<F><<<grid, kThreads, 0, stream>>>(ss, S, x0, par, a);
  return static_cast<int>(cudaGetLastError());
}

int launch_normal(const float* ss, int S, const float* x0,
                  const float* params, const AcceptArgs& a,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)S * S +
                                       (size_t)S * (kNormalThreads + 1));
  if (smem > (size_t)kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        normal_accept_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (a.B + kNormalThreads - 1) / kNormalThreads;
  normal_accept_kernel<<<grid, kNormalThreads, smem, stream>>>(ss, S, x0,
                                                              params, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// family: kernels/kernel_accept.py::FAMILY_CODES (noise.cuh's NoiseFamily)
extern "C" int pyabc_kernel_accept(
    const float* ss, int B, int S, const float* x0, const float* params,
    int family, const uint8_t* valid, const float* temp,
    const float* pdf_norm, int lin, int apply_iw, const float* logpri,
    const float* logq, unsigned k0, unsigned k1, unsigned gen, unsigned tag,
    unsigned max_rounds, const int* counters, float* v_out,
    uint8_t* acc_out, float* logw_out, void* stream_ptr) {
  if (B <= 0) return 0;
  if (counters == nullptr || (logpri == nullptr) != (logq == nullptr) ||
      S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // the independent normal and Laplace device_fns never exponentiate
  const int exp_lin = lin && family != pyabc::kNoiseIndependentNormal &&
                      family != pyabc::kNoiseLaplace;
  const AcceptArgs a{B, valid, temp, pdf_norm, lin, exp_lin, apply_iw,
                     logpri, logq, k0, k1, gen, tag, max_rounds, counters,
                     v_out, acc_out, logw_out};
  switch (family) {
    case pyabc::kNoiseIndependentNormal:
      return launch_family<pyabc::kNoiseIndependentNormal>(ss, S, x0, params,
                                                           a, stream);
    case pyabc::kNoiseLaplace:
      return launch_family<pyabc::kNoiseLaplace>(ss, S, x0, params, a,
                                                 stream);
    case pyabc::kNoiseBinomial:
      return launch_family<pyabc::kNoiseBinomial>(ss, S, x0, params, a,
                                                  stream);
    case pyabc::kNoisePoisson:
      return launch_family<pyabc::kNoisePoisson>(ss, S, x0, params, a,
                                                 stream);
    case pyabc::kNoiseNegBinSize:
      return launch_family<pyabc::kNoiseNegBinSize>(ss, S, x0, params, a,
                                                    stream);
    case pyabc::kNoiseNegBinMean:
      return launch_family<pyabc::kNoiseNegBinMean>(ss, S, x0, params, a,
                                                    stream);
    case pyabc::kNoiseNormal:
      return launch_normal(ss, S, x0, params, a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
