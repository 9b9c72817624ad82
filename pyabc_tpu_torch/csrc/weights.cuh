// The adaptive distance's weight update and distance recompute, shared by
// K9 (scale_reduce.cu, the scale over the record ring) and K22's finish
// (moments.cu, the scale from the moment block).
//
// Replaces: pyabc_tpu/distance/pnorm.py::AdaptivePNormDistance::
// device_weight_update (:493) and the recompute of the accepted rows'
// distances under the new weights (pyabc_tpu/inference/util.py:1847).
//
// finish_weights: one block turns a scale per column into the weights
// w = 1 / scale where scale > 0 (else 0), clipped at max_ratio times the
// least positive weight (max_ratio > 0), normalized to mean 1; rows_kernel:
// the weighted p-norm of each row against x0 under w, one warp a row (as
// K5).
#pragma once

#include "common.cuh"

namespace pyabc_w {
namespace {  // every source that includes this keeps its own copy

__device__ __forceinline__ float nan_min(float a, float b) {
  if (isnan(a) || isnan(b)) return a + b;
  return fminf(a, b);
}

// op 0 sum, 1 max (NaN propagates), 2 min (NaN propagates); a fixed tree,
// so the result depends on the thread layout and not on timing
__device__ float block_reduce(float v, int op, float* s_warp) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = op == 0 ? v + o : op == 1 ? nan_max(v, o) : nan_min(v, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float ident = op == 0 ? 0.f : op == 1 ? -INFINITY : INFINITY;
    v = lane < nw ? s_warp[lane] : ident;
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = op == 0 ? v + o : op == 1 ? nan_max(v, o) : nan_min(v, o);
    }
    if (lane == 0) s_warp[0] = v;
  }
  __syncthreads();
  return s_warp[0];
}

// One block: scale_out[c] = scale_of(c), then the weights into w_out.
template <class ScaleOf>
__device__ void finish_weights(ScaleOf scale_of, int S, float max_ratio,
                               int normalize, float* scale_out, float* w_out,
                               float* s_warp) {
  float wmin = INFINITY;
  for (int c = threadIdx.x; c < S; c += blockDim.x) {
    const float sc = scale_of(c);
    scale_out[c] = sc;
    const float w = sc > 0.f ? 1.f / sc : 0.f;
    w_out[c] = w;
    if (w > 0.f) wmin = fminf(wmin, w);
  }
  if (max_ratio > 0.f) {
    wmin = block_reduce(wmin, 2, s_warp);
    const float cap = wmin * max_ratio;
    for (int c = threadIdx.x; c < S; c += blockDim.x)
      w_out[c] = fminf(w_out[c], cap);
  }
  if (normalize) {
    float s = 0.f;
    for (int c = threadIdx.x; c < S; c += blockDim.x) s += w_out[c];
    s = block_reduce(s, 0, s_warp);
    if (s > 0.f) {
      const float f = (float)S / s;
      for (int c = threadIdx.x; c < S; c += blockDim.x)
        w_out[c] = w_out[c] * f;
    }
  }
}

constexpr int kRowThreads = 256;

// Weighted p-norm of each row against x0: one warp per row (as K5).
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const float* __restrict__ rows, int n_rows, int S,
            const float* __restrict__ x0, const float* __restrict__ w,
            float p, float* __restrict__ d_out) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;
  const float* row = rows + (size_t)r * S;
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
  if (p_inf || p == 1.f)
    d_out[r] = acc;
  else if (p == 2.f)
    d_out[r] = sqrtf(acc);
  else
    d_out[r] = powf(acc, 1.f / p);
}

void launch_rows(const float* rows, int n_rows, int S, const float* x0,
                 const float* w, float p, float* d_out, cudaStream_t stream) {
  if (rows == nullptr || n_rows <= 0) return;
  const int per_block = kRowThreads / 32;
  rows_kernel<<<(n_rows + per_block - 1) / per_block, kRowThreads, 0,
                stream>>>(rows, n_rows, S, x0, w, p, d_out);
}

}  // namespace
}  // namespace pyabc_w
