// The weighted MultivariateNormalTransition fit of one block, shared by K8
// (mvn_fit.cu, the refit of a generation step) and K16's bootstrap fit
// (bootstrap_cv.cu, one fit per model and bootstrap replicate).
//
// Replaces the moments, bandwidth and factorization of
// pyabc_tpu/transition/multivariatenormal.py::device_fit with
// pyabc_tpu/transition/util.py::device_chol_guarded. On the rows
// i < n of a row source (raw weight w~_i, row theta_i with d = d_max
// columns, the first `dim` real):
//   w = w~ / max(sum w~, 1e-38); mean = w @ theta; sum w^2;
//   cov[k][l] = sum_i (c_ik w_i) c_il with c = theta - mean;
//   smart_cov fill: a diagonal entry <= 0 becomes |mean_k| 1e-4 + 1e-8;
//   ess = 1 / max(sum w^2, 1e-38); factor = Scott ess^(-1/(dim+4)) or
//   Silverman (4/(dim+2))^(1/(dim+4)) ess^(-1/(dim+4)); cov *= (s f)^2;
//   the jitter ladder (chol.cuh); prec = L^-T L^-1 masked to the real dims;
//   logdet = 2 sum_{k < dim} log max(L_kk, 1e-38).
// The moments are block reductions, the d x d work runs on thread 0 in
// shared memory (d <= 32). A row source is a struct with
//   raw_weight(i)  the weight before normalization,
//   theta(i, k)    entry k of row i,
//   put_w(i, w)    keeps the normalized weight (K8 writes it out; K16 not),
//   w(i, ws)       the normalized weight again, in the covariance pass.
// The arithmetic is K8's, in K8's order, so its numbers do not move.
#pragma once

#include "chol.cuh"
#include "common.cuh"

namespace pyabc {

// threads of a fit block: 1024 for the dim buckets up to 4, 256 above,
// where each thread's d + 1 accumulators need more than 64 registers
template <int D>
struct FitThreads {
  static constexpr int value = D <= 4 ? 1024 : 256;
};

// the shared memory of one fit block (row stride D throughout)
template <int D, int kThreads>
struct FitShared {
  float warp[(kThreads / 32) * (D + 1)];
  float part[kThreads];
  float mean[D + 1];  // the weighted mean, then sum w^2 in slot D
  float cov[D * D];
  float L[D * D];
  float Linv[D * D];
  float prec[D * D];  // masked to the real dims
  float vmask[D];
  float logdet;
};

__device__ inline float fit_block_sum(float v, float* s_warp) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < nw ? s_warp[lane] : 0.f);
    if (lane == 0) s_warp[0] = v;
  }
  __syncthreads();
  return s_warp[0];
}

// The fit of rows [0, n) of `rows` into `sh` (mean, L, prec, vmask,
// logdet); every thread of the block calls it, and it returns after a
// barrier. Returns the normalizing sum ws.
template <int D, int kThreads, class Rows>
__device__ inline float fit_params(const Rows& rows, int n, int d, int dim,
                                   float scaling, int selector,
                                   float sel_const, float sel_exp,
                                   FitShared<D, kThreads>& sh) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // 1. w = weights / max(sum, 1e-38)
  float ws = 0.f;
  for (int i = tid; i < n; i += kThreads) ws += rows.raw_weight(i);
  ws = clamp_min_keep_nan(fit_block_sum(ws, sh.warp), 1e-38f);

  // 2. mean = w @ thetas and sum w^2, one block reduction of d + 1 values
  float acc[D + 1];
#pragma unroll
  for (int k = 0; k <= D; ++k) acc[k] = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float w = rows.raw_weight(i) / ws;
    rows.put_w(i, w);
#pragma unroll
    for (int k = 0; k < D; ++k)
      if (k < d) acc[k] += w * rows.theta(i, k);
    acc[D] += w * w;
  }
  __syncthreads();  // every thread has read fit_block_sum's warp[0]
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) sh.warp[warp * (D + 1) + k] = v;
  }
  __syncthreads();
  if (tid <= D) {
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += sh.warp[wi * (D + 1) + tid];
    sh.mean[tid] = s;
  }
  if (tid < D) sh.vmask[tid] = tid < dim ? 1.f : 0.f;
  __syncthreads();

  // 3. cov: entry p = k D + l over the rows g, g + G, ... (G row groups
  // when the threads outnumber the entries, else each thread its entries
  // over all rows)
  constexpr int P = D * D;
  constexpr int G = kThreads >= P ? kThreads / P : 1;
  for (int t = tid; t < (G > 1 ? kThreads : P); t += kThreads) {
    const int p = t % P, g = t / P;
    const int k = p / D, l = p % D;
    float c = 0.f;
    if (g < G && k < d && l < d) {
      const float mk = sh.mean[k], ml = sh.mean[l];
      for (int i = g; i < n; i += G) {
        const float w = rows.w(i, ws);
        const float ck = rows.theta(i, k) - mk;
        const float cl = rows.theta(i, l) - ml;
        c += (ck * w) * cl;
      }
    }
    if (G > 1)
      sh.part[t] = c;
    else
      sh.cov[p] = c;
  }
  __syncthreads();
  if (G > 1 && tid < P) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += sh.part[g * P + tid];
    sh.cov[tid] = s;
  }
  __syncthreads();

  // 4. fill, bandwidth, ladder, inverse, logdet (thread 0, d x d)
  if (tid == 0) {
    float* cov = sh.cov;
    for (int k = 0; k < d; ++k) {
      const float c = cov[k * D + k];
      const float fill = fabsf(sh.mean[k]) * 1e-4f + 1e-8f;
      if (c <= 0.f) cov[k * D + k] = c + (fill - c);
    }
    const float ess = 1.f / clamp_min_keep_nan(sh.mean[D], 1e-38f);
    float factor = powf(ess, sel_exp);
    if (selector == 1) factor = sel_const * factor;
    const float sf = scaling * factor;
    const float sf2 = sf * sf;
    for (int k = 0; k < d; ++k)
      for (int l = 0; l < d; ++l) cov[k * D + l] = cov[k * D + l] * sf2;
    chol_guarded(cov, sh.L, d, D);
    // L^-1 by forward substitution, then P = L^-T L^-1
    float* Linv = sh.Linv;
    for (int c = 0; c < d; ++c) {
      for (int i = 0; i < c; ++i) Linv[i * D + c] = 0.f;
      Linv[c * D + c] = 1.f / sh.L[c * D + c];
      for (int i = c + 1; i < d; ++i) {
        float t = 0.f;
        for (int k = c; k < i; ++k) t += sh.L[i * D + k] * Linv[k * D + c];
        Linv[i * D + c] = -t / sh.L[i * D + i];
      }
    }
    float ld = 0.f;
    for (int k = 0; k < d; ++k)
      ld += sh.vmask[k] * logf(clamp_min_keep_nan(sh.L[k * D + k], 1e-38f));
    sh.logdet = 2.f * ld;
    for (int i = 0; i < d; ++i)
      for (int j = 0; j < d; ++j) {
        float p = 0.f;
        for (int k = (i > j ? i : j); k < d; ++k)
          p += Linv[k * D + i] * Linv[k * D + j];
        sh.prec[i * D + j] = p * (sh.vmask[i] * sh.vmask[j]);
      }
  }
  __syncthreads();
  return ws;
}

// quad = c' P c of one centred row c (the first d entries) under the
// masked precision (row stride D)
template <int D>
__device__ __forceinline__ float fit_quad(const float* c, const float* prec,
                                          int d) {
  float q = 0.f;
#pragma unroll
  for (int l = 0; l < D; ++l) {
    if (l >= d) break;
    float pc = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k)
      if (k < d) pc += c[k] * prec[k * D + l];
    q += pc * c[l];
  }
  return q;
}

}  // namespace pyabc
