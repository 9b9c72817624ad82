// K26 model_step: the per-model bookkeeping of a generation step of a run
// over several models.
//
// Replaces: the model terms of pyabc_tpu/inference/util.py::multigen_kernel
// (gen_step): the model probabilities, counts and fitted mask of the new
// population (util.py:1879-1886, 1936-1947, 1998-2001) and, for the next
// generation, the masked and row-renormalized perturbation matrix with the
// log model factor (util.py:1640-1652); the model-perturbation draw itself
// (model_perturbation.py::device_rvs, :53) sits in K2 and its log pmf
// (:58) in log_model_factor.
//
// Over the reservoir rows i (model m_i, normalized weight w_i, kept k_i):
//   model_probs[k]  = sum_i [k_i and m_i == k] w_i
//   counts[k]       = #{i : k_i and m_i == k}
//   fitted_next[k]  = counts[k] > 0 | (fitted[k] & counts[k] > 0)
//   log_probs[k]    = model_probs[k] > 0 ? log(max(p, 1e-38)) : -inf
//   matrix[a][b]    = mpk[a][b] fitted_next[b] / row sum (0 for a row
//                     whose sum is 0)
//   factor[b]       = sum_a exp(log_probs[a]) matrix[a][b]
//   log_factor[b]   = factor[b] > 0 ? log(max(f, 1e-38)) : -inf
// Every input and output lies in device memory: the next generation's K2
// (ancestor model and perturbation) and K5 (log weight) read them there,
// and the host reads nothing.
//
// Bound on an H100: bytes (n_cap * 9 bytes in, a few hundred out), so at
// n_cap = 1024 the kernel is launch latency bound. Design: one block of
// 256 threads; each thread keeps K (<= 8) weight and count accumulators
// over its rows, a fixed-order warp then block reduction makes the sums
// deterministic, and thread 0 does the K x K epilogue.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxModels = 8;

__global__ void __launch_bounds__(kThreads)
model_step_kernel(int n, int K, const int* __restrict__ m,
                  const float* __restrict__ w_norm,
                  const uint8_t* __restrict__ k_mask,
                  const uint8_t* __restrict__ fitted,
                  const float* __restrict__ mpk,
                  float* __restrict__ probs_out,
                  float* __restrict__ log_probs_out,
                  int* __restrict__ counts_out,
                  uint8_t* __restrict__ fitted_out,
                  float* __restrict__ matrix_out,
                  float* __restrict__ log_factor_out) {
  __shared__ float s_w[kWarps][kMaxModels];
  __shared__ int s_c[kWarps][kMaxModels];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float acc[kMaxModels];
  int cnt[kMaxModels];
#pragma unroll
  for (int k = 0; k < kMaxModels; ++k) {
    acc[k] = 0.f;
    cnt[k] = 0;
  }
  for (int i = tid; i < n; i += kThreads) {
    if (!k_mask[i]) continue;
    const int mi = m[i];
    const float wi = w_norm[i];
#pragma unroll
    for (int k = 0; k < kMaxModels; ++k)
      if (k == mi) {
        acc[k] += wi;
        cnt[k] += 1;
      }
  }
#pragma unroll
  for (int k = 0; k < kMaxModels; ++k) {
    const float ws = warp_sum(acc[k]);
    int cs = cnt[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cs += __shfl_xor_sync(0xffffffffu, cs, off);
    if (lane == 0) {
      s_w[warp][k] = ws;
      s_c[warp][k] = cs;
    }
  }
  __syncthreads();
  if (tid != 0) return;

  float lp[kMaxModels];
  bool fit[kMaxModels];
  for (int k = 0; k < K; ++k) {
    float p = 0.f;
    int c = 0;
    for (int wi = 0; wi < kWarps; ++wi) {
      p += s_w[wi][k];
      c += s_c[wi][k];
    }
    fit[k] = c > 0 || (fitted[k] != 0 && c > 0);
    lp[k] = p > 0.f ? logf(fmaxf(p, 1e-38f)) : -INFINITY;
    probs_out[k] = p;
    counts_out[k] = c;
    fitted_out[k] = fit[k] ? 1 : 0;
    log_probs_out[k] = lp[k];
  }
  float factor[kMaxModels];
  for (int b = 0; b < K; ++b) factor[b] = 0.f;
  for (int a = 0; a < K; ++a) {
    float row[kMaxModels];
    float rs = 0.f;
    for (int b = 0; b < K; ++b) {
      row[b] = mpk[a * K + b] * (fit[b] ? 1.f : 0.f);
      rs += row[b];
    }
    const float pa = expf(lp[a]);
    for (int b = 0; b < K; ++b) {
      const float v = rs > 0.f ? row[b] / rs : 0.f;
      matrix_out[a * K + b] = v;
      factor[b] += pa * v;
    }
  }
  for (int b = 0; b < K; ++b)
    log_factor_out[b] =
        factor[b] > 0.f ? logf(fmaxf(factor[b], 1e-38f)) : -INFINITY;
}

}  // namespace

extern "C" int pyabc_model_step(int n, int K, const int* m,
                                const float* w_norm, const uint8_t* k_mask,
                                const uint8_t* fitted, const float* mpk,
                                float* probs, float* log_probs, int* counts,
                                uint8_t* fitted_next, float* matrix,
                                float* log_factor, void* stream_ptr) {
  if (n < 0 || K < 1 || K > kMaxModels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  model_step_kernel<<<1, kThreads, 0, stream>>>(
      n, K, m, w_norm, k_mask, fitted, mpk, probs, log_probs, counts,
      fitted_next, matrix, log_factor);
  return static_cast<int>(cudaGetLastError());
}
