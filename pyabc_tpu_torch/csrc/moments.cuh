// The moment block's combine and its scale functions, shared by K24d's
// finish (moments.cu, the adaptive p-norm's columns) and K25's sharded
// finish (aggregate.cu, the aggregated distance's value columns).
//
// Replaces: pyabc_tpu/ops/scale_reduce.py::{combine_moments (:102),
// scale_from_moments (:115)}.
//
// A block is (6, C) float32: sum, sum of squares, sum of |x - x0|, count,
// max, min per column. combine_shards_kernel merges the (n, 6, C) blocks in
// shard order (sums added 0..n-1, extrema merged, NaN kept), one thread a
// column; scale_of finishes one column's scale from a block with n =
// max(count, 1), mean = sum / n and the one-pass variance max(E[x^2] -
// mean^2, 0) of the JAX package, every operation rounded once (_rn).
#pragma once

#include "weights.cuh"

namespace pyabc_m {
namespace {  // every source that includes this keeps its own copy

constexpr int kRows = 6;

// scale codes: the order of pyabc_tpu_torch/kernels/moments.py's
// SCALE_NAMES
enum MomentScale {
  kMean = 0, kBias, kSpan, kStd, kRmsd, kMeanAdObs, kStdObs
};

// max(v, 0) with NaN kept (jnp.maximum)
__device__ __forceinline__ float clamp0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

// column c's scale of the (6, C) block mom against the observation xo
__device__ float scale_of(int code, int c, int C, const float* mom,
                          float xo) {
  const float s = mom[c], sq = mom[C + c], ad = mom[2 * C + c];
  const float cnt = mom[3 * C + c];
  const float n = isnan(cnt) ? cnt : fmaxf(cnt, 1.f);
  const float mean = __fdiv_rn(s, n);
  const float var =
      clamp0(__fsub_rn(__fdiv_rn(sq, n), __fmul_rn(mean, mean)));
  switch (code) {
    case kMean:
      return mean;
    case kBias:
      return fabsf(__fsub_rn(mean, xo));
    case kSpan:
      return __fsub_rn(mom[4 * C + c], mom[5 * C + c]);
    case kStd:
      return __fsqrt_rn(var);
    case kRmsd: {
      const float d = __fsub_rn(mean, xo);
      return __fsqrt_rn(__fadd_rn(__fmul_rn(d, d), var));
    }
    case kMeanAdObs:
      return __fdiv_rn(ad, n);
    case kStdObs: {
      const float num =
          __fadd_rn(__fsub_rn(sq, __fmul_rn(__fmul_rn(2.f, xo), s)),
                    __fmul_rn(__fmul_rn(cnt, xo), xo));
      return __fsqrt_rn(clamp0(__fdiv_rn(num, n)));
    }
  }
  return NAN;
}

// one thread a column: the shards' blocks merged in shard order
__global__ void __launch_bounds__(256)
combine_shards_kernel(const float* __restrict__ parts, int n_shards, int C,
                      float* __restrict__ mom) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  for (int r = 0; r < kRows; ++r) {
    float acc = parts[(size_t)r * C + c];
    for (int s = 1; s < n_shards; ++s) {
      const float v = parts[((size_t)s * kRows + r) * C + c];
      acc = r < 4 ? acc + v : r == 4 ? nan_max(acc, v)
                                     : pyabc_w::nan_min(acc, v);
    }
    mom[(size_t)r * C + c] = acc;
  }
}

// the combine's launch on a stream
inline void combine_shards(const float* parts, int n_shards, int C,
                           float* mom, cudaStream_t stream) {
  combine_shards_kernel<<<(C + 255) / 256, 256, 0, stream>>>(parts, n_shards,
                                                              C, mom);
}

}  // namespace
}  // namespace pyabc_m
