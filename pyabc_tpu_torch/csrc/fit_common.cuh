// Shared parts of K23's boundary fits (ridge_fit.cu, mlp_fit.cu): the
// decision read from the round counters, and the masked column passes of
// the standardization (pyabc_tpu/ops/fit.py::masked_standardize, :54).
//
// The decision needs no host read: n_keep = min(n_acc, n_target), the kept
// rows are the first n_keep, gen_ok = n_acc >= min(n_target, n_cap), and a
// fit runs when gen_ok and n_keep >= need. Every pass of a fit that does
// not run returns at once.
//
// The column passes sum in float64 in a fixed order (per chunk of kRows
// rows, then the chunks in order), so a fit repeats bit for bit; two
// passes, never E[x^2] - mu^2.
#pragma once

#include "common.cuh"

namespace {

namespace fit {

constexpr int kThreads = 256;
constexpr int kRows = 256;  // rows a block of the column passes sums
constexpr int kNAcc = 0, kNTarget = 4;

struct Decision {
  int n_keep;
  bool fit;
};

__device__ __forceinline__ Decision decide(const int* counters, int n_cap,
                                           int need) {
  const int n_acc = counters[kNAcc], n_tgt = counters[kNTarget];
  const int n_keep = min(n_acc, n_tgt);
  const bool gen_ok = n_acc >= min(n_tgt, n_cap);
  return Decision{n_keep, gen_ok && n_keep >= need};
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// per chunk of kRows kept rows, one thread a column: the sums of x's Q
// columns
__global__ void __launch_bounds__(kThreads)
col_sums_kernel(const float* __restrict__ x, int n_cap, int Q,
                const int* __restrict__ counters, int need,
                double* __restrict__ part) {
  const Decision dec = decide(counters, n_cap, need);
  if (!dec.fit) return;
  const int r0 = blockIdx.x * kRows;
  if (r0 >= dec.n_keep) return;
  const int r1 = min(r0 + kRows, dec.n_keep);
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    double s = 0.0;
    for (int r = r0; r < r1; ++r) s += (double)x[(size_t)r * Q + q];
    part[(size_t)blockIdx.x * Q + q] = s;
  }
}

// the sums' finish (one block): mu = sum / max(n_keep, 1)
__global__ void __launch_bounds__(kThreads)
col_mean_kernel(const double* __restrict__ part, int n_cap, int Q,
                const int* __restrict__ counters, int need,
                float* __restrict__ mu) {
  const Decision dec = decide(counters, n_cap, need);
  if (!dec.fit) return;
  const int chunks = (dec.n_keep + kRows - 1) / kRows;
  const double n = fmax((double)dec.n_keep, 1.0);
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    double s = 0.0;
    for (int k = 0; k < chunks; ++k) s += part[(size_t)k * Q + q];
    mu[q] = (float)(s / n);
  }
}

// per chunk: the column sums of (x - mu)^2
__global__ void __launch_bounds__(kThreads)
col_dev_kernel(const float* __restrict__ x, int n_cap, int Q,
               const int* __restrict__ counters, int need,
               const float* __restrict__ mu, double* __restrict__ part) {
  const Decision dec = decide(counters, n_cap, need);
  if (!dec.fit) return;
  const int r0 = blockIdx.x * kRows;
  if (r0 >= dec.n_keep) return;
  const int r1 = min(r0 + kRows, dec.n_keep);
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    const double m = (double)mu[q];
    double s = 0.0;
    for (int r = r0; r < r1; ++r) {
      const double d = (double)x[(size_t)r * Q + q] - m;
      s += d * d;
    }
    part[(size_t)blockIdx.x * Q + q] = s;
  }
}

// the deviations' finish (one block): sd = sqrt(var), sd <= 1e-12 -> 1
__global__ void __launch_bounds__(kThreads)
col_sd_kernel(const double* __restrict__ part, int n_cap, int Q,
              const int* __restrict__ counters, int need,
              float* __restrict__ sd) {
  const Decision dec = decide(counters, n_cap, need);
  if (!dec.fit) return;
  const int chunks = (dec.n_keep + kRows - 1) / kRows;
  const double n = fmax((double)dec.n_keep, 1.0);
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    double s = 0.0;
    for (int k = 0; k < chunks; ++k) s += part[(size_t)k * Q + q];
    const float v = (float)sqrt(s / n);
    sd[q] = v > 1e-12f ? v : 1.f;
  }
}

// the masked standardization of x (n_cap, Q) into mu, sd: four launches;
// part holds ceil(n_cap / kRows) Q doubles
inline void standardize(const float* x, int n_cap, int Q, const int* counters,
                        int need, float* mu, float* sd, double* part,
                        cudaStream_t stream) {
  const int chunks = (n_cap + kRows - 1) / kRows;
  col_sums_kernel<<<chunks, kThreads, 0, stream>>>(x, n_cap, Q, counters,
                                                   need, part);
  col_mean_kernel<<<1, kThreads, 0, stream>>>(part, n_cap, Q, counters, need,
                                              mu);
  col_dev_kernel<<<chunks, kThreads, 0, stream>>>(x, n_cap, Q, counters, need,
                                                  mu, part);
  col_sd_kernel<<<1, kThreads, 0, stream>>>(part, n_cap, Q, counters, need,
                                            sd);
}

// raise a kernel's dynamic shared memory limit to what the block's opt-in
// limit leaves beside its static variables, once; returns the limit in
// bytes (negative: the CUDA error, negated). The first call is never
// inside a graph capture: each wrapper's first call runs eagerly.
template <class K>
inline int raise_smem(K kernel, int* cached) {
  if (*cached >= 0) return *cached;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error for the next launch's check
    return -static_cast<int>(err);
  }
  *cached = optin - (int)fa.sharedSizeBytes;
  return *cached;
}

}  // namespace fit

}  // namespace
