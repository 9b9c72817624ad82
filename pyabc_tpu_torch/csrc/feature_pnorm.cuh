// The weighted p-norm of a learned feature vector against the observed
// one's (pyabc_tpu/distance/pnorm.py::PNormDistance.device_fn, :204-219,
// over the transformed statistics), shared by the linear and the MLP
// transform's accept (linear_sumstat.cu, mlp_sumstat.cu): p = 1, 2, inf
// (NaN kept) or general, each term and the sums in order.
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxFeatures = 8;

__device__ __forceinline__ float feature_pnorm(const float (&s)[kMaxFeatures],
                                               const float* s0,
                                               const float* w, int C,
                                               float p) {
  const bool p_inf = isinf(p);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxFeatures; ++c) {
    if (c >= C) break;
    const float diff = __fmul_rn(w[c], fabsf(__fsub_rn(s[c], s0[c])));
    if (p_inf)
      acc = nan_max(acc, diff);
    else if (p == 1.f)
      acc = __fadd_rn(acc, diff);
    else if (p == 2.f)
      acc = __fadd_rn(acc, __fmul_rn(diff, diff));
    else
      acc = __fadd_rn(acc, powf(diff, p));
  }
  if (p_inf || p == 1.f) return acc;
  if (p == 2.f) return __fsqrt_rn(acc);
  return powf(acc, 1.f / p);
}

}  // namespace
