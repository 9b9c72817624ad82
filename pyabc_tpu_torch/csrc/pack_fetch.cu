// K10 pack_fetch: the narrowing pack of a chunk's rows before the host read.
//
// Replaces: pyabc_tpu/ops/pack.py::pack_outs with _cast_monotone_down (the
// rows of the fetch tree and its sum stats).
//
// rows: for generation g < n_gen and reservoir row i < n_keep,
//   out[g, i, 0:d] = narrow(theta_g[i, :])
//   out[g, i, d]   = narrow_down(dist_g[i])
//   out[g, i, d+1] = narrow(logw_g[i])
// cast: out[g, i, 0:S] = narrow(ss_g[i, :]) for the generations History
// stores.
// narrow() is IEEE round-to-nearest-even into the fetch dtype (float32,
// float16 or bfloat16); narrow_down() is _cast_monotone_down: where the
// nearest value lies above x it takes narrow(x * (1 -+ step)) instead (step
// 2^-10 for float16, 2^-7 for bfloat16), so a stored distance never exceeds
// the float32 distance and the invariant distance <= eps_used survives the
// cast. The same float32 multiply and the same casts as the plain version
// give bit-identical output.
//
// models (a run over several models, pack.py:124-125): out[g, i] =
// (int8) m_g[i], the model index of each kept row; a plain narrowing of
// int32 indices below 128, bit-exact.
//
// Each generation's rows stay in their own reservoir: the kernel reads them
// through a table of per-generation pointers passed by value (up to
// kMaxGen per launch; the wrapper launches once per kMaxGen generations),
// so nothing stacks the generations first.
//
// Bound on an H100: bytes (each kept row read once, the narrowed rows
// written once). One thread per output element, neighbouring threads on
// neighbouring elements of a row.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGen = 32;

struct GenRows {
  const float* a[kMaxGen];  // theta (rows) or sum stats (cast)
  const float* dist[kMaxGen];
  const float* logw[kMaxGen];
};

struct GenModels {
  const int* m[kMaxGen];
};

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow_down(float x, float step) {
  const T cast = narrow<T>(x);
  if (!(widen(cast) > x)) return cast;
  return narrow<T>(x * (x >= 0.f ? 1.f - step : 1.f + step));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_rows_kernel(GenRows src, int n_gen, int n_keep, int d, float step,
                 T* __restrict__ out) {
  const int w = d + 2;
  const long long per_gen = (long long)n_keep * w;
  const long long total = per_gen * n_gen;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(idx / per_gen);
    const long long r = idx - g * per_gen;
    const int i = (int)(r / w), k = (int)(r - (long long)i * w);
    T v;
    if (k < d) {
      v = narrow<T>(src.a[g][(size_t)i * d + k]);
    } else if (k == d) {
      v = narrow_down<T>(src.dist[g][i], step);
    } else {
      v = narrow<T>(src.logw[g][i]);
    }
    out[idx] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cast_rows_kernel(GenRows src, int n_gen, int n_keep, int S,
                 T* __restrict__ out) {
  const long long per_gen = (long long)n_keep * S;
  const long long total = per_gen * n_gen;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(idx / per_gen);
    out[idx] = narrow<T>(src.a[g][idx - g * per_gen]);
  }
}

__global__ void __launch_bounds__(kThreads)
pack_models_kernel(GenModels src, int n_gen, int n_keep,
                   int8_t* __restrict__ out) {
  const long long total = (long long)n_keep * n_gen;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(idx / n_keep);
    out[idx] = (int8_t)src.m[g][idx - (long long)g * n_keep];
  }
}

int grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < 4096 ? blocks : 4096);
}

bool fill(GenRows* t, int n_gen, const void* const* a, const void* const* dist,
          const void* const* logw) {
  if (n_gen <= 0 || n_gen > kMaxGen) return false;
  for (int g = 0; g < n_gen; ++g) {
    t->a[g] = static_cast<const float*>(a[g]);
    t->dist[g] = dist ? static_cast<const float*>(dist[g]) : nullptr;
    t->logw[g] = logw ? static_cast<const float*>(logw[g]) : nullptr;
  }
  return true;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. theta/dist/logw are host arrays
// of n_gen device pointers.
extern "C" int pyabc_pack_rows(int n_gen, const void* const* theta,
                               const void* const* dist,
                               const void* const* logw, int n_keep, int d,
                               int dtype, void* out, void* stream_ptr) {
  GenRows src;
  if (!fill(&src, n_gen, theta, dist, logw) || n_keep < 0 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)n_gen * n_keep * (d + 2);
  if (total == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = grid_for(total);
  if (dtype == 0) {
    pack_rows_kernel<float><<<grid, kThreads, 0, stream>>>(
        src, n_gen, n_keep, d, 0.f, static_cast<float*>(out));
  } else if (dtype == 1) {
    pack_rows_kernel<__half><<<grid, kThreads, 0, stream>>>(
        src, n_gen, n_keep, d, 0x1p-10f, static_cast<__half*>(out));
  } else if (dtype == 2) {
    pack_rows_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        src, n_gen, n_keep, d, 0x1p-7f, static_cast<__nv_bfloat16*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pyabc_cast_rows(int n_gen, const void* const* src_rows,
                               int n_keep, int S, int dtype, void* out,
                               void* stream_ptr) {
  GenRows src;
  if (!fill(&src, n_gen, src_rows, nullptr, nullptr) || n_keep < 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)n_gen * n_keep * S;
  if (total == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = grid_for(total);
  if (dtype == 0) {
    cast_rows_kernel<float><<<grid, kThreads, 0, stream>>>(
        src, n_gen, n_keep, S, static_cast<float*>(out));
  } else if (dtype == 1) {
    cast_rows_kernel<__half><<<grid, kThreads, 0, stream>>>(
        src, n_gen, n_keep, S, static_cast<__half*>(out));
  } else if (dtype == 2) {
    cast_rows_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        src, n_gen, n_keep, S, static_cast<__nv_bfloat16*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// models: m is a host array of n_gen device pointers to int32 rows; out
// (n_gen, n_keep) int8.
extern "C" int pyabc_pack_models(int n_gen, const void* const* m, int n_keep,
                                 void* out, void* stream_ptr) {
  if (n_gen <= 0 || n_gen > kMaxGen || n_keep < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GenModels src;
  for (int g = 0; g < n_gen; ++g) src.m[g] = static_cast<const int*>(m[g]);
  const long long total = (long long)n_gen * n_keep;
  if (total == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  pack_models_kernel<<<grid_for(total), kThreads, 0, stream>>>(
      src, n_gen, n_keep, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
