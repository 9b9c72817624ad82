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

// cp.async (sm_80+): a copy from global to shared memory that bypasses the
// registers; commit_group closes a group of them and wait_group<N> waits
// until at most N groups are pending. A barrier after the wait makes the
// copies of every thread visible to the block.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// 4 bytes, or 4 zero bytes where `pred` is false (the source is not read).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
