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
//
// local_mix_logpdf_ring is the same arithmetic for R points a thread: each
// component's theta, P, lconst and w are read once from shared memory (16-
// byte loads) and serve the R points, whose sums run as R independent
// chains, each in local_mix_logpdf's order (the online update is written
// with selects, the same operations on the same values). The components
// stream through a ring of kMixStages tiles filled by cp.async, one barrier
// a tile, so the copy of the next tiles overlaps the compute on this one.
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

// One tile of the ring: T components, zeros past d (as MixTile).
template <int D>
struct MixStage {
  static constexpr int T = 512 / D;
  float th[T * D];
  float p[T * D * D];
  float2 cw[T];  // (lconst, w)
};

constexpr int kMixStages = 3;

// Every thread of the block: components [base, base + cnt) of one mixture
// into `st` by 4-byte cp.async (zero-filled past d), one group committed.
template <int D>
__device__ __forceinline__ void mix_stage_copy(
    MixStage<D>& st, const float* __restrict__ thetas,
    const float* __restrict__ precs, const float* __restrict__ lconst,
    const float* __restrict__ weights, int base, int cnt, int d) {
  for (int idx = threadIdx.x; idx < cnt * D; idx += blockDim.x) {
    const int j = idx / D, k = idx - j * D;
    const bool in = k < d;
    cp_async4(&st.th[idx],
              in ? thetas + (size_t)(base + j) * d + k : thetas, in);
  }
  for (int idx = threadIdx.x; idx < cnt * D * D; idx += blockDim.x) {
    const int j = idx / (D * D), e = idx - j * (D * D);
    const int k = e / D, l = e - k * D;
    const bool in = k < d && l < d;
    cp_async4(&st.p[idx],
              in ? precs + (size_t)(base + j) * d * d + k * d + l : precs,
              in);
  }
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
    cp_async4(&st.cw[j].x, lconst + base + j, true);
    cp_async4(&st.cw[j].y, weights + base + j, true);
  }
  cp_async_commit();
}

template <int D>
__device__ __forceinline__ void load_row(const float* src, float (&v)[D]) {
  if constexpr (D >= 4) {
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(src)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = src[k];
  }
}

// R points a thread (qv zero past d) under the mixture's first n
// components -> out[r], bit-equal to local_mix_logpdf on each point. Every
// thread of the block calls it; `ring` is kMixStages tiles of shared memory.
template <int D, int R>
__device__ void local_mix_logpdf_ring(const float (&qv)[R][D],
                                      const float* __restrict__ thetas,
                                      const float* __restrict__ precs,
                                      const float* __restrict__ lconst,
                                      const float* __restrict__ weights,
                                      int n, int d, MixStage<D>* ring,
                                      float (&out)[R]) {
  constexpr int T = MixStage<D>::T;
  float m[R], s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
  }
  const int tiles = (n + T - 1) / T;
  for (int t = 0; t < kMixStages - 1; ++t) {
    if (t < tiles)
      mix_stage_copy<D>(ring[t], thetas, precs, lconst, weights, t * T,
                        min(T, n - t * T), d);
    else
      cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kMixStages - 2>();
    __syncthreads();  // tile t landed; tile t - 1's stage is free
    const int tn = t + kMixStages - 1;
    if (tn < tiles)
      mix_stage_copy<D>(ring[tn % kMixStages], thetas, precs, lconst,
                        weights, tn * T, min(T, n - tn * T), d);
    else
      cp_async_commit();
    const MixStage<D>& st = ring[t % kMixStages];
    const int cnt = min(T, n - t * T);
#pragma unroll 2
    for (int j = 0; j < cnt; ++j) {
      const float2 cw = st.cw[j];
      if (!(cw.y > 0.f)) continue;
      float th[D];
      load_row<D>(st.th + j * D, th);
      float df[R][D], maha[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        maha[r] = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) df[r][k] = __fsub_rn(qv[r][k], th[k]);
      }
      const float* P = st.p + j * D * D;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float prow[D];
        load_row<D>(P + k * D, prow);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float pk = 0.f;
#pragma unroll
          for (int l = 0; l < D; ++l) pk = __fmaf_rn(prow[l], df[r][l], pk);
          maha[r] = __fmaf_rn(df[r][k], pk, maha[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // local_mix_logpdf's update on the same values: m - lc is -(lc -
        // m) bit for bit, so the exp's argument is -|lc - m| on either
        // side (expf(-0) = expf(+0)); the max keeps m on NaN and -inf
        const float lc = __fmaf_rn(-0.5f, maha[r], cw.x);
        const float dl = lc - m[r];
        const float e = expf(-fabsf(dl));
        const float s_new =
            lc > m[r] ? __fmaf_rn(s[r], e, 1.f) : __fadd_rn(s[r], e);
        s[r] = lc == -INFINITY ? s[r] : s_new;
        m[r] = fmaxf(m[r], lc);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    out[r] = (s[r] == 0.f) ? -INFINITY : m[r] + logf(s[r]);
}

}  // namespace pyabc
