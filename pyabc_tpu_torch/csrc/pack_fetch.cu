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
// Merge mode (K24c, sharded fused sampling): replaces pack_outs(
// merge_index=) (pyabc_tpu/ops/pack.py:105-110) with the merge of
// pyabc_tpu/ops/shard.py::merge_index (:58-76). Generation g's reservoir
// is shard-blocked (n shards of cap_loc rows, shard s keeping its first
// quota_s = n_g / n (+1 on the first n_g % n shards) rows); output row
// i < n_g reads source row s * cap_loc + off, where i is the off-th kept
// row of shard s in dense order, computed from n_g, n and cap_loc in the
// kernel. Rows n_g <= i < n_keep (a listed size's smaller generation) read
// row i. The same gather serves rows, sum stats and models.
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

// The merge of shard-blocked reservoirs (shards = 0: row i is row i).
struct Merge {
  int n[kMaxGen];
  int shards;
  int cap_loc;
};

__device__ __forceinline__ int merged_row(const Merge& mg, int g, int i) {
  if (mg.shards <= 0) return i;
  const int n = mg.n[g];
  if (i >= n) return i;
  const int base = n / mg.shards, extra = n % mg.shards;
  const int head = extra * (base + 1);  // rows of the shards with one more
  int s, off;
  if (i < head) {
    s = i / (base + 1);
    off = i - s * (base + 1);
  } else {  // base > 0 here, since i < n
    const int j = i - head;
    s = extra + j / base;
    off = j - (s - extra) * base;
  }
  return s * mg.cap_loc + off;
}

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
pack_rows_kernel(GenRows src, Merge mg, int n_gen, int n_keep, int d,
                 float step, T* __restrict__ out) {
  const int w = d + 2;
  const long long per_gen = (long long)n_keep * w;
  const long long total = per_gen * n_gen;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(idx / per_gen);
    const long long r = idx - g * per_gen;
    const int i = (int)(r / w), k = (int)(r - (long long)i * w);
    const int src_i = merged_row(mg, g, i);
    T v;
    if (k < d) {
      v = narrow<T>(src.a[g][(size_t)src_i * d + k]);
    } else if (k == d) {
      v = narrow_down<T>(src.dist[g][src_i], step);
    } else {
      v = narrow<T>(src.logw[g][src_i]);
    }
    out[idx] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cast_rows_kernel(GenRows src, Merge mg, int n_gen, int n_keep, int S,
                 T* __restrict__ out) {
  const long long per_gen = (long long)n_keep * S;
  const long long total = per_gen * n_gen;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(idx / per_gen);
    const long long r = idx - g * per_gen;
    const int i = (int)(r / S), k = (int)(r - (long long)i * S);
    out[idx] = narrow<T>(src.a[g][(size_t)merged_row(mg, g, i) * S + k]);
  }
}

__global__ void __launch_bounds__(kThreads)
pack_models_kernel(GenModels src, Merge mg, int n_gen, int n_keep,
                   int8_t* __restrict__ out) {
  const long long total = (long long)n_keep * n_gen;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(idx / n_keep);
    const int i = (int)(idx - (long long)g * n_keep);
    out[idx] = (int8_t)src.m[g][merged_row(mg, g, i)];
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

// merge_n: n_gen generation sizes, or nullptr (no merge)
bool fill_merge(Merge* mg, int n_gen, const int* merge_n, int shards,
                int cap_loc) {
  mg->shards = merge_n != nullptr ? shards : 0;
  mg->cap_loc = cap_loc;
  for (int g = 0; g < n_gen && g < kMaxGen; ++g)
    mg->n[g] = merge_n != nullptr ? merge_n[g] : 0;
  return merge_n == nullptr || (shards > 0 && cap_loc > 0);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. theta/dist/logw are host arrays
// of n_gen device pointers.
// merge_n: a host array of the n_gen generation sizes of a merge (shards,
// cap_loc), or nullptr.
extern "C" int pyabc_pack_rows(int n_gen, const void* const* theta,
                               const void* const* dist,
                               const void* const* logw, int n_keep, int d,
                               int dtype, const int* merge_n, int shards,
                               int cap_loc, void* out, void* stream_ptr) {
  GenRows src;
  Merge mg;
  if (!fill(&src, n_gen, theta, dist, logw) || n_keep < 0 || d < 0 ||
      !fill_merge(&mg, n_gen, merge_n, shards, cap_loc))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)n_gen * n_keep * (d + 2);
  if (total == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = grid_for(total);
  if (dtype == 0) {
    pack_rows_kernel<float><<<grid, kThreads, 0, stream>>>(
        src, mg, n_gen, n_keep, d, 0.f, static_cast<float*>(out));
  } else if (dtype == 1) {
    pack_rows_kernel<__half><<<grid, kThreads, 0, stream>>>(
        src, mg, n_gen, n_keep, d, 0x1p-10f, static_cast<__half*>(out));
  } else if (dtype == 2) {
    pack_rows_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        src, mg, n_gen, n_keep, d, 0x1p-7f, static_cast<__nv_bfloat16*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pyabc_cast_rows(int n_gen, const void* const* src_rows,
                               int n_keep, int S, int dtype,
                               const int* merge_n, int shards, int cap_loc,
                               void* out, void* stream_ptr) {
  GenRows src;
  Merge mg;
  if (!fill(&src, n_gen, src_rows, nullptr, nullptr) || n_keep < 0 ||
      S < 0 || !fill_merge(&mg, n_gen, merge_n, shards, cap_loc))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)n_gen * n_keep * S;
  if (total == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = grid_for(total);
  if (dtype == 0) {
    cast_rows_kernel<float><<<grid, kThreads, 0, stream>>>(
        src, mg, n_gen, n_keep, S, static_cast<float*>(out));
  } else if (dtype == 1) {
    cast_rows_kernel<__half><<<grid, kThreads, 0, stream>>>(
        src, mg, n_gen, n_keep, S, static_cast<__half*>(out));
  } else if (dtype == 2) {
    cast_rows_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        src, mg, n_gen, n_keep, S, static_cast<__nv_bfloat16*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// models: m is a host array of n_gen device pointers to int32 rows; out
// (n_gen, n_keep) int8.
extern "C" int pyabc_pack_models(int n_gen, const void* const* m, int n_keep,
                                 const int* merge_n, int shards, int cap_loc,
                                 void* out, void* stream_ptr) {
  Merge mg;
  if (n_gen <= 0 || n_gen > kMaxGen || n_keep < 0 ||
      !fill_merge(&mg, n_gen, merge_n, shards, cap_loc))
    return static_cast<int>(cudaErrorInvalidValue);
  GenModels src;
  for (int g = 0; g < n_gen; ++g) src.m[g] = static_cast<const int*>(m[g]);
  const long long total = (long long)n_gen * n_keep;
  if (total == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  pack_models_kernel<<<grid_for(total), kThreads, 0, stream>>>(
      src, mg, n_gen, n_keep, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
