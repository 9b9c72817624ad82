// Shared helpers of the pyabc_tpu_torch CUDA kernels.
//
// Every kernel is launched from an extern "C" entry point that takes raw
// device pointers and the caller's CUDA stream (PyTorch's current stream)
// and returns cudaGetLastError() of the launch: a refused launch never runs,
// and the Python wrapper raises on any nonzero return.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PYABC_LOG_2PI 1.8378770664093453f

// max(a, b) that propagates NaN like jnp.max (fmaxf drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a) || isnan(b)) return a + b;
  return fmaxf(a, b);
}

// jnp.clip(x, lo, hi) semantics: NaN stays NaN (fminf/fmaxf would drop it).
__device__ __forceinline__ float clip_keep_nan(float x, float lo, float hi) {
  if (isnan(x)) return x;
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_nan_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += up;
  }
  return v;
}
