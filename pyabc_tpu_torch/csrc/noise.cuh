// The noise models' per-entry terms, shared by K21a/K21c (the accept
// kernel, kernel_accept.cu) and K18's noisy mode (segment_round.cu), so
// that both compute the same numbers.
//
// Replaces the elementwise arithmetic of pyabc_tpu/distance/kernel.py:
// IndependentNormalKernel.device_fn (:176) and its device_bound_fn (:198),
// IndependentLaplaceKernel (:254, :261), BinomialKernel (:314, :327) with
// _binom_logpmf (:215), PoissonKernel (:370, :383) and
// NegativeBinomialKernel.device_fn (:450). An elementwise family's
// log-density of a row is scale * sum_s term(x_s, x0_s, par_s) (scale
// -0.5, -1 or 1), each term in the JAX package's order of operations;
// par_s is the column's variance, Laplace scale b or p (the same p in every
// column), unused for Poisson.
//
// The upper bounds of the stochastic retirement (K18's noisy mode) fold a
// segment's entries into acc: the independent normal starts at its
// pdf_max and subtracts 0.5 * sum(diff^2 / var), Laplace starts at its
// pdf_max and subtracts sum(|diff| / b), binomial and Poisson (log scale)
// start at 0 and add their actual log-pmfs.
//
// Every operation is written with a _rn intrinsic: nvcc contracts nothing
// into an FMA, so the inlined copies in both kernels give the same bits,
// and so do the plain PyTorch twins (one rounding per operation; logf,
// log1pf and lgammaf are the same libdevice functions PyTorch calls).
// Rounding to an integer is rintf (half to even, as jnp.round).
#pragma once

#include "common.cuh"

namespace pyabc {

// kernels/kernel_accept.py::FAMILY_CODES
enum NoiseFamily : int {
  kNoiseIndependentNormal = 0,
  kNoiseLaplace = 1,
  kNoiseBinomial = 2,
  kNoisePoisson = 3,
  kNoiseNegBinSize = 4,
  kNoiseNegBinMean = 5,
  kNoiseNormal = 6  // full covariance: its own kernel, no bound
};

// jnp.maximum(x, c): NaN stays NaN.
__device__ __forceinline__ float max_keep_nan(float x, float c) {
  return isnan(x) ? x : fmaxf(x, c);
}

// xlogy(k, p) and xlog1py(m, -p) of jax.scipy.special: 0 where k (m) is 0
__device__ __forceinline__ float xlogy0(float k, float p) {
  return k == 0.f ? 0.f : __fmul_rn(k, logf(p));
}
__device__ __forceinline__ float xlog1py0(float m, float p) {
  return m == 0.f ? 0.f : __fmul_rn(m, log1pf(-p));
}

__device__ __forceinline__ float binom_term(float x, float x0, float p) {
  const float n = max_keep_nan(rintf(x), 0.f);
  const float k = rintf(x0);
  if (!(k >= 0.f && k <= n)) return -INFINITY;
  const float nk = __fsub_rn(n, k);
  float v = __fsub_rn(lgammaf(__fadd_rn(n, 1.f)), lgammaf(__fadd_rn(k, 1.f)));
  v = __fsub_rn(v, lgammaf(__fadd_rn(nk, 1.f)));
  v = __fadd_rn(v, xlogy0(k, p));
  return __fadd_rn(v, xlog1py0(nk, p));
}

__device__ __forceinline__ float poisson_term(float x, float x0) {
  const float lam = max_keep_nan(x, 1e-12f);
  const float k = rintf(x0);
  const float v = __fsub_rn(__fsub_rn(__fmul_rn(k, logf(lam)), lam),
                            lgammaf(__fadd_rn(k, 1.f)));
  return k >= 0.f ? v : -INFINITY;
}

__device__ __forceinline__ float negbin_term(float x, float x0, float p,
                                             bool mean) {
  const float xm = max_keep_nan(x, 1e-12f);
  const float n = mean ? __fdiv_rn(__fmul_rn(xm, p), __fsub_rn(1.f, p)) : xm;
  const float k = rintf(x0);
  float v = __fsub_rn(lgammaf(__fadd_rn(k, n)), lgammaf(n));
  v = __fsub_rn(v, lgammaf(__fadd_rn(k, 1.f)));
  v = __fadd_rn(v, __fmul_rn(n, logf(p)));
  v = __fadd_rn(v, __fmul_rn(k, log1pf(-p)));
  return k >= 0.f ? v : -INFINITY;
}

// The per-entry term of an elementwise family (the summand of its
// log-density before the scale).
template <int F>
__device__ __forceinline__ float noise_term(float x, float x0, float par) {
  if constexpr (F == kNoiseIndependentNormal) {
    const float diff = __fsub_rn(x, x0);
    return __fadd_rn(__fadd_rn(PYABC_LOG_2PI, logf(par)),
                     __fdiv_rn(__fmul_rn(diff, diff), par));
  } else if constexpr (F == kNoiseLaplace) {
    return __fadd_rn(logf(__fmul_rn(2.f, par)),
                     __fdiv_rn(fabsf(__fsub_rn(x, x0)), par));
  } else if constexpr (F == kNoiseBinomial) {
    return binom_term(x, x0, par);
  } else if constexpr (F == kNoisePoisson) {
    return poisson_term(x, x0);
  } else {
    return negbin_term(x, x0, par, F == kNoiseNegBinMean);
  }
}

template <int F>
__device__ __forceinline__ float noise_scale() {
  if constexpr (F == kNoiseIndependentNormal) return -0.5f;
  if constexpr (F == kNoiseLaplace) return -1.f;
  return 1.f;
}

// One entry's part of the upper bound's segment sum (see above).
__device__ __forceinline__ float bound_entry(int family, float x, float x0,
                                             float par) {
  switch (family) {
    case kNoiseIndependentNormal: {
      const float diff = __fsub_rn(x, x0);
      return __fdiv_rn(__fmul_rn(diff, diff), par);
    }
    case kNoiseLaplace:
      return __fdiv_rn(fabsf(__fsub_rn(x, x0)), par);
    case kNoiseBinomial:
      return binom_term(x, x0, par);
    default:
      return poisson_term(x, x0);
  }
}

// acc after a segment whose entries summed to s
__device__ __forceinline__ float bound_update(int family, float acc,
                                              float s) {
  switch (family) {
    case kNoiseIndependentNormal:
      return __fsub_rn(acc, __fmul_rn(0.5f, s));
    case kNoiseLaplace:
      return __fsub_rn(acc, s);
    default:
      return __fadd_rn(acc, s);
  }
}

// _upper_exceeds (kernel.py:41): acc < thr - (1e-3 + 1e-4 |acc|)
__device__ __forceinline__ bool upper_exceeds(float acc, float thr) {
  const float slack = __fadd_rn(1e-3f, __fmul_rn(1e-4f, fabsf(acc)));
  return acc < __fsub_rn(thr, slack);
}

}  // namespace pyabc
