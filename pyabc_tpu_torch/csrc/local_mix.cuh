// The log-density of a block's query points under one LocalTransition
// mixture: the component tile loop K14 (local_logpdf.cu) and K16's local
// density (bootstrap_cv.cu) share, so a point's log-density under a
// bootstrap fit equals K14's on the same mixture bit for bit.
//
//   diff_j = q - theta_j,  maha_j = diff_j' P_j diff_j (explicit fmas, in
//   index order), lc_j = lconst_j - 0.5 maha_j, over the components with
//   w_j > 0, as an online max / sum logsumexp; -inf when none is live.
//
// Every thread of the block calls it (the tiles are staged with barriers);
// a thread whose `active` is false stages but computes nothing. The tile
// holds 512 / D components (theta, P, lconst, w), so D = 16 takes 35 KB of
// static shared memory.
#pragma once

#include "common.cuh"

namespace pyabc {

template <int D>
struct MixTile {
  static constexpr int T = 512 / D;
  float th[T * D];
  float p[T * D * D];
  float c[T];
  float w[T];
};

template <int D>
__device__ float local_mix_logpdf(const float (&qv)[D], bool active,
                                  const float* __restrict__ thetas,
                                  const float* __restrict__ precs,
                                  const float* __restrict__ lconst,
                                  const float* __restrict__ weights, int n,
                                  int d, MixTile<D>& sh) {
  constexpr int T = MixTile<D>::T;
  float m = -INFINITY;  // running max of lc over nonzero-weight components
  float s = 0.f;        // running sum of exp(lc_j - m)
  for (int base = 0; base < n; base += T) {
    const int cnt = min(T, n - base);
    __syncthreads();
    for (int idx = threadIdx.x; idx < cnt * D; idx += blockDim.x) {
      const int j = idx / D, k = idx - j * D;
      sh.th[idx] = k < d ? thetas[(size_t)(base + j) * d + k] : 0.f;
    }
    for (int idx = threadIdx.x; idx < cnt * D * D; idx += blockDim.x) {
      const int j = idx / (D * D), e = idx - j * (D * D);
      const int k = e / D, l = e - k * D;
      sh.p[idx] = (k < d && l < d)
                      ? precs[(size_t)(base + j) * d * d + k * d + l]
                      : 0.f;
    }
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      sh.c[j] = lconst[base + j];
      sh.w[j] = weights[base + j];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < cnt; ++j) {
      if (!(sh.w[j] > 0.f)) continue;
      float df[D];
#pragma unroll
      for (int k = 0; k < D; ++k) df[k] = __fsub_rn(qv[k], sh.th[j * D + k]);
      const float* P = sh.p + j * D * D;
      float maha = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float pk = 0.f;
#pragma unroll
        for (int l = 0; l < D; ++l) pk = __fmaf_rn(P[k * D + l], df[l], pk);
        maha = __fmaf_rn(df[k], pk, maha);
      }
      const float lc = __fmaf_rn(-0.5f, maha, sh.c[j]);
      if (lc == -INFINITY) continue;
      if (lc > m) {
        s = __fmaf_rn(s, expf(m - lc), 1.f);
        m = lc;
      } else {
        s = __fadd_rn(s, expf(lc - m));  // NaN lc propagates through s
      }
    }
  }
  return (s == 0.f) ? -INFINITY : m + logf(s);
}

}  // namespace pyabc
