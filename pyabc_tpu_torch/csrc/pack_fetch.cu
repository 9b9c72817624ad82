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
// written once). A thread, or a group of gs threads (a power of two up to
// 32, by the row's width), owns a row: the block's rows are found once
// each (merged_row, 32-bit arithmetic), theta or the sum stats are read in
// 16-byte loads where d * 4 and the pointers allow, and the narrowed rows
// are staged in shared memory at the output's offset modulo 16, so the
// block's contiguous output goes out as coalesced 16-byte stores (a row
// wider than the stage is written in place instead).
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGen = 32;
constexpr int kStageBytes = 16384;  // a block's staged output

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

// Copy a block's staged output s to dst (s and dst agree modulo 16): the
// unaligned head and tail bytes one by one, the rest as 16-byte stores.
__device__ __forceinline__ void store_staged(const unsigned char* s,
                                             unsigned char* dst, int nbytes) {
  const int head = min(nbytes, (int)((16 - ((uintptr_t)dst & 15)) & 15));
  const int body = (nbytes - head) >> 4;
  for (int k = threadIdx.x; k < head; k += blockDim.x) dst[k] = s[k];
  const uint4* sv = reinterpret_cast<const uint4*>(s + head);
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  for (int k = threadIdx.x; k < body; k += blockDim.x) dv[k] = sv[k];
  for (int k = head + (body << 4) + threadIdx.x; k < nbytes; k += blockDim.x)
    dst[k] = s[k];
}

// How a launch lays out its rows: gs = 1 << log_gs threads a row, rows a
// block, 16-byte loads of the floats (vec), staged output (staged).
struct Layout {
  int log_gs;
  int rows;
  int vec;
  int staged;
};

// rows (kPack): out[g, i, :] = narrow(a_g[src, 0:d]), narrow_down(dist),
// narrow(logw), w = d + 2; cast: out[g, i, :] = narrow(a_g[src, 0:d]).
// Block (x, g) holds rows x * rows .. of generation g.
template <typename T, bool kPack>
__global__ void __launch_bounds__(kThreads)
rows_kernel(GenRows src, Merge mg, int n_keep, int d, Layout lay, float step,
            T* __restrict__ out) {
  __shared__ __align__(16) unsigned char s_raw[kStageBytes + 16];
  __shared__ int s_src[kThreads];
  const int g = blockIdx.y;
  const int w = kPack ? d + 2 : d;
  const int r0 = blockIdx.x * lay.rows;
  const int rows = min(lay.rows, n_keep - r0);
  T* base = out + ((size_t)g * n_keep + r0) * w;
  const int mis = (int)((uintptr_t)base & 15);
  T* stage = lay.staged ? reinterpret_cast<T*>(s_raw + mis) : base;
  if (lay.log_gs > 0) {  // a group a row: its source row found once
    for (int r = threadIdx.x; r < rows; r += kThreads)
      s_src[r] = merged_row(mg, g, r0 + r);
    __syncthreads();
  }
  const int gs = 1 << lay.log_gs;
  const int j = threadIdx.x & (gs - 1);
  const float* a_g = src.a[g];
  for (int r = threadIdx.x >> lay.log_gs; r < rows;
       r += kThreads >> lay.log_gs) {
    const int si = lay.log_gs > 0 ? s_src[r] : merged_row(mg, g, r0 + r);
    const float* a = a_g + (size_t)si * d;
    T* o = stage + (size_t)r * w;
    for (int c = 4 * j; c < d; c += 4 * gs) {
      if (lay.vec) {
        const float4 v = *reinterpret_cast<const float4*>(a + c);
        o[c] = narrow<T>(v.x);
        o[c + 1] = narrow<T>(v.y);
        o[c + 2] = narrow<T>(v.z);
        o[c + 3] = narrow<T>(v.w);
      } else {
        for (int q = c; q < min(d, c + 4); ++q) o[q] = narrow<T>(a[q]);
      }
    }
    if (kPack && j == 0) {
      o[d] = narrow_down<T>(src.dist[g][si], step);
      o[d + 1] = narrow<T>(src.logw[g][si]);
    }
  }
  if (!lay.staged) return;
  __syncthreads();
  store_staged(s_raw + mis, reinterpret_cast<unsigned char*>(base),
               rows * w * (int)sizeof(T));
}

// models: a thread a row, out[g, i] = (int8) m_g[src].
__global__ void __launch_bounds__(kThreads)
pack_models_kernel(GenModels src, Merge mg, int n_keep,
                   int8_t* __restrict__ out) {
  __shared__ __align__(16) unsigned char s_raw[kThreads + 16];
  const int g = blockIdx.y;
  const int r0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n_keep - r0);
  int8_t* base = out + (size_t)g * n_keep + r0;
  const int mis = (int)((uintptr_t)base & 15);
  if ((int)threadIdx.x < rows)
    s_raw[mis + threadIdx.x] =
        (unsigned char)(int8_t)src.m[g][merged_row(mg, g, r0 + threadIdx.x)];
  __syncthreads();
  store_staged(s_raw + mis, reinterpret_cast<unsigned char*>(base), rows);
}

// The layout of rows of width w (d floats read a row) in T of `size` bytes.
Layout layout_for(int d, int w, int size, bool vec) {
  Layout lay{0, kThreads, vec ? 1 : 0, 1};
  const int chunks = (d + 3) / 4;  // a thread's reads go 4 columns at a time
  while ((1 << lay.log_gs) < chunks && lay.log_gs < 5) ++lay.log_gs;
  lay.rows = kThreads >> lay.log_gs;
  const int fit = kStageBytes / max(1, w * size);
  if (fit < 1) {
    lay.rows = 1;
    lay.staged = 0;
  } else {
    lay.rows = min(lay.rows, fit);
  }
  return lay;
}

bool aligned16(const float* const* p, int n_gen) {
  for (int g = 0; g < n_gen; ++g)
    if (((uintptr_t)p[g] & 15) != 0) return false;
  return true;
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

template <typename T, bool kPack>
int launch_rows(const GenRows& src, const Merge& mg, int n_gen, int n_keep,
                int d, float step, void* out, cudaStream_t stream) {
  const int w = kPack ? d + 2 : d;
  const Layout lay = layout_for(d, w, (int)sizeof(T),
                                d % 4 == 0 && aligned16(src.a, n_gen));
  const dim3 grid((unsigned)((n_keep + lay.rows - 1) / lay.rows),
                  (unsigned)n_gen);
  rows_kernel<T, kPack><<<grid, kThreads, 0, stream>>>(
      src, mg, n_keep, d, lay, step, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool kPack>
int launch_dtype(int dtype, const GenRows& src, const Merge& mg, int n_gen,
                 int n_keep, int d, void* out, cudaStream_t stream) {
  if (dtype == 0)
    return launch_rows<float, kPack>(src, mg, n_gen, n_keep, d, 0.f, out,
                                     stream);
  if (dtype == 1)
    return launch_rows<__half, kPack>(src, mg, n_gen, n_keep, d, 0x1p-10f,
                                      out, stream);
  if (dtype == 2)
    return launch_rows<__nv_bfloat16, kPack>(src, mg, n_gen, n_keep, d,
                                             0x1p-7f, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (n_keep == 0) return 0;
  return launch_dtype<true>(dtype, src, mg, n_gen, n_keep, d, out,
                            static_cast<cudaStream_t>(stream_ptr));
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
  if (n_keep == 0 || S == 0) return 0;
  return launch_dtype<false>(dtype, src, mg, n_gen, n_keep, S, out,
                             static_cast<cudaStream_t>(stream_ptr));
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
  if (n_keep == 0) return 0;
  const dim3 grid((unsigned)((n_keep + kThreads - 1) / kThreads),
                  (unsigned)n_gen);
  pack_models_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(
                                              stream_ptr)>>>(
      src, mg, n_keep, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
