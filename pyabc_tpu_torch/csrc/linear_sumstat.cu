// K23 transform (the linear plan): learned summary statistics s(x) =
// ((x - mu) / sd) @ W + b, and the p-norm accept of a round through them.
//
// Replaces: pyabc_tpu/predictor/predictor.py::LinearPredictor.
// device_predict (:125) inside pyabc_tpu/distance/pnorm.py::PNormDistance.
// device_fn (:204-219: x and x0 both through the transform) composed with
// UniformAcceptor.device_fn and the log weight of util.py:400-406; and the
// places the multigen kernel transforms rows: the record ring under an
// adaptive distance (util.py:1818-1828), the reservoir's recompute after a
// boundary refit (:1850-1862) and the packed fetch (:2051-2066).
//
// Three entries over one device function (lin_row: one warp a row, lane l
// the columns l, l + 32, ...; the C' partial sums reduced across the warp
// in a fixed order, so a row transforms to the same bits wherever it is
// transformed):
//   pyabc_linear_transform  (n, S) -> (n, C'): the fetch, the ring, x0;
//   pyabc_linear_accept     per lane the transform, then the weighted
//       p-norm against the transformed x0 (computed by each block in
//       shared memory by the same function), then K5's epilogue
//       (accept_epilogue.cuh): accept, log weight, hist_min;
//   values mode (terms null): the distances only, for the reservoir's
//       recompute after a refit; bit-equal to the accept's distances under
//       the same parameters.
// p = 1, 2, inf (NaN kept) or general, as pnorm_accept.cu.
//
// Bound on an H100: bytes, one read of the (B, S) statistics; W, b, mu,
// sd (a few KB) stay in L1/L2. C' <= 8 (the accumulators live in
// registers).
#include "accept_epilogue.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 8;

// the transform of one row by one warp; every lane returns all C values
__device__ __forceinline__ void lin_row(const float* __restrict__ row,
                                        int S, int C,
                                        const float* __restrict__ W,
                                        const float* __restrict__ b,
                                        const float* __restrict__ mu,
                                        const float* __restrict__ sd,
                                        float (&s)[kMaxC]) {
  const int lane = threadIdx.x & 31;
  float acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.f;
  for (int k = lane; k < S; k += 32) {
    const float xs = __fdiv_rn(__fsub_rn(row[k], mu[k]), sd[k]);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) acc[c] = __fmaf_rn(xs, W[k * C + c], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) s[c] = __fadd_rn(warp_sum(acc[c]), b[c]);
  }
}

__global__ void __launch_bounds__(kThreads)
linear_transform_kernel(const float* __restrict__ x, int n, int S, int C,
                        const float* __restrict__ W,
                        const float* __restrict__ b,
                        const float* __restrict__ mu,
                        const float* __restrict__ sd,
                        float* __restrict__ out) {
  const int row_i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row_i >= n) return;  // whole warps exit together
  float s[kMaxC];
  lin_row(x + (size_t)row_i * S, S, C, W, b, mu, sd, s);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C && lane == c) out[(size_t)row_i * C + c] = s[c];
}

__global__ void __launch_bounds__(kThreads)
linear_accept_kernel(const float* __restrict__ ss, int B, int S, int C,
                     const float* __restrict__ x0,
                     const float* __restrict__ W,
                     const float* __restrict__ b,
                     const float* __restrict__ mu,
                     const float* __restrict__ sd,
                     const float* __restrict__ w, float p, bool values,
                     const pyabc::AcceptTerms terms) {
  __shared__ float s0[kMaxC];
  if (threadIdx.x < 32) {
    float t[kMaxC];
    lin_row(x0, S, C, W, b, mu, sd, t);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < C) s0[c] = t[c];
    }
  }
  __syncthreads();
  const int row_i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row_i >= B) return;
  float s[kMaxC];
  lin_row(ss + (size_t)row_i * S, S, C, W, b, mu, sd, s);
  if ((threadIdx.x & 31) != 0) return;
  const bool p_inf = isinf(p);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
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
  float d;
  if (p_inf || p == 1.f)
    d = acc;
  else if (p == 2.f)
    d = __fsqrt_rn(acc);
  else
    d = powf(acc, 1.f / p);
  if (values)
    terms.d_out[row_i] = d;
  else
    pyabc::accept_epilogue(terms, row_i, d);
}

}  // namespace

// x (n, S) -> out (n, C), C <= 8
extern "C" int pyabc_linear_transform(const float* x, int n, int S, int C,
                                      const float* W, const float* b,
                                      const float* mu, const float* sd,
                                      float* out, void* stream_ptr) {
  if (n <= 0) return 0;
  if (C < 1 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = (n + kWarps - 1) / kWarps;
  linear_transform_kernel<<<grid, kThreads, 0, stream>>>(x, n, S, C, W, b,
                                                         mu, sd, out);
  return static_cast<int>(cudaGetLastError());
}

// ss (B, S) raw statistics, x0 (S,) raw, W (S, C), b (C,), mu, sd (S,),
// w (C,) the feature weights; values != 0: d_out only (valid, eps and the
// other terms unread); else K5's epilogue (accept_epilogue.cuh).
extern "C" int pyabc_linear_accept(
    const float* ss, int B, int S, int C, const float* x0, const float* W,
    const float* b, const float* mu, const float* sd, const float* w,
    float p, int values, const uint8_t* valid, const float* eps,
    const float* hist_min, const float* logpri, const float* logq,
    float log_offset, float* d_out, uint8_t* acc_out, float* logw_out,
    void* stream_ptr) {
  if (B <= 0) return 0;
  if (C < 1 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  if (!values && (valid == nullptr || eps == nullptr || acc_out == nullptr ||
                  logw_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const pyabc::AcceptTerms terms{valid,   eps,     hist_min,
                                 logpri,  logq,    log_offset,
                                 nullptr, nullptr, nullptr,
                                 d_out,   acc_out, logw_out};
  const int grid = (B + kWarps - 1) / kWarps;
  linear_accept_kernel<<<grid, kThreads, 0, stream>>>(
      ss, B, S, C, x0, W, b, mu, sd, w, p, values != 0, terms);
  return static_cast<int>(cudaGetLastError());
}
