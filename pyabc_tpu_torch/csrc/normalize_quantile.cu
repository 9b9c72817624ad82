// K7 normalize_quantile: the importance-weight normalization and the
// quantile epsilon of a generation step, one launch each.
//
// Replaces: pyabc_tpu/ops/stats.py::normalize_log_weights and
// weighted_quantile, as used at pyabc_tpu/inference/util.py:1774 and
// :1866-1872 (the multigen kernel's normalization, calibration and quantile
// epsilon, with its masking and multiplier).
//
// normalize: log_w masked to -inf where mask == 0, m = max (NaN
//   propagates), w = exp(log_w - m) (m = 0 where it is not finite),
//   w / sum(w) where the sum is positive, else all zeros (the all-masked
//   generation).
// quantile epsilon: points d where mask, else +inf; weights w (or the mask
//   as float, without w) where mask, else 0; the least v with
//   float32(W(<= v) / W) >= alpha, times the multiplier in float32
//   (__fmul_rn). That is the plain version's stable argsort + cumsum + left
//   search, exactly for counts and, for float weights, except where alpha
//   lies within float rounding of a step of the CDF. All-zero weights (or a
//   NaN, infinite or negative one) give the largest point; NaN sorts above
//   +inf.
//
// Bound on an H100: bytes, a few KB at the main-path size (n_cap = 1024),
// so both are latency bound. The design keeps everything on chip and
// launches once:
// - Block mode (n <= 16384): one block of 1024 threads. normalize keeps a
//   thread's 16 rows in registers across the max, the exp and the sum
//   (one read, one write, two block reductions of one barrier each). The
//   quantile loads the n order-preserving uint32 keys (select.cuh's
//   key_of) and the weights into shared memory once (12 bytes a row, 192
//   KB at 16384) and runs the four 8-bit radix passes inside the block: a
//   warp aggregates the lanes that share a bin (__match_any_sync,
//   __reduce_add_sync) and its leader adds count and weight to the
//   block's 256 bins; warp 0 then picks the bin by a warp-parallel prefix
//   scan (8 bins a lane). Two barriers a pass (the bins are double
//   buffered, the next pass's cleared during this one's histogram); a pass
//   that leaves a single candidate ends the selection with its key.
// - Cluster mode (16385 <= n <= 131072): the same bodies on a cluster of 8
//   blocks, each holding a slice of ceil(n / 8) rows; the maxima and sums
//   (normalize) and the 256-bin histograms (quantile) are read over
//   distributed shared memory in rank order, so every rank takes the same
//   decision without another launch.
// - Passes mode (n > 131072): the three-sweep normalization and the
//   four-pass radix selection of select.cuh, with a masking launch before
//   and a multiply after.
// The same bits from run to run: the weights are summed as 64-bit
// fixed-point integers (each weight scaled exactly by a power of two so
// that the largest is below 2^46, truncated; the sum of 131072 of them fits
// in 64 bits), so the order in which atomics land does not matter. The
// truncation moves the CDF by less than 2^-28 of the total weight, below
// float32's rounding of the ratio, and is exact for counts. The
// normalization's sums are fixed trees.
#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"
#include "select.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kPerThread = 16;  // normalize: the rows a thread holds
constexpr int kBlockRows = kThreads * kPerThread;  // 16384
constexpr int kClusterBlocks = 8;
constexpr int kClusterRows = kClusterBlocks * kBlockRows;  // 131072
constexpr int kBins = 256;
constexpr int kFixedBits = 46;
constexpr unsigned kFull = 0xffffffffu;

// A block reduction with one barrier: every warp folds the warps' partials
// in the same butterfly, so every thread holds the same value. s_part (one
// float a warp) serves one reduction only.
template <int T>
__device__ float block_reduce(float v, bool is_max, float* s_part) {
  v = is_max ? warp_nan_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0) s_part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < T / 32 ? s_part[lane] : (is_max ? -INFINITY : 0.f);
  return is_max ? warp_nan_max(v) : warp_sum(v);
}

// The rows [lo, hi) of this block: all n in a lone block, a slice of
// ceil(n / C) on rank r of a cluster of C.
template <int C>
__device__ __forceinline__ void my_rows(int n, int* lo, int* hi) {
  if constexpr (C == 1) {
    *lo = 0;
    *hi = n;
  } else {
    const int per = (n + C - 1) / C;
    *lo = min(n, (int)cg::this_cluster().block_rank() * per);
    *hi = min(n, *lo + per);
  }
}

template <int C>
__device__ __forceinline__ void cluster_or_block_sync() {
  if constexpr (C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Every rank's value of s_val, folded in rank order (call after a cluster
// barrier that follows the writes).
template <int C>
__device__ float fold_ranks(float* s_val, bool is_max) {
  cg::cluster_group cl = cg::this_cluster();
  float v = is_max ? -INFINITY : 0.f;
#pragma unroll
  for (int r = 0; r < C; ++r) {
    const float x = *cl.map_shared_rank(s_val, r);
    v = is_max ? nan_max(v, x) : v + x;
  }
  return v;
}

// T threads, kPerThread rows each, on one block (C = 1) or a cluster.
template <int T, int C>
__device__ void normalize_rows(const float* __restrict__ log_w,
                               const uint8_t* __restrict__ mask, int n,
                               float* __restrict__ out) {
  __shared__ float s_max_part[32], s_sum_part[32];
  __shared__ float s_part[2];  // this block's max and sum, for the ranks
  int lo, hi;
  my_rows<C>(n, &lo, &hi);
  float v[kPerThread];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = lo + threadIdx.x + k * T;
    v[k] = -INFINITY;
    if (i < hi) v[k] = (mask != nullptr && !mask[i]) ? -INFINITY : log_w[i];
    m = nan_max(m, v[k]);
  }
  m = block_reduce<T>(m, true, s_max_part);
  if constexpr (C > 1) {
    if (threadIdx.x == 0) s_part[0] = m;
    cg::this_cluster().sync();
    m = fold_ranks<C>(&s_part[0], true);
  }
  const float safe = isfinite(m) ? m : 0.f;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    v[k] = expf(v[k] - safe);
    s += v[k];
  }
  s = block_reduce<T>(s, false, s_sum_part);
  if constexpr (C > 1) {
    if (threadIdx.x == 0) s_part[1] = s;
    cg::this_cluster().sync();
    s = fold_ranks<C>(&s_part[1], false);
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = lo + threadIdx.x + k * T;
    if (i < hi) out[i] = s > 0.f ? v[k] / s : 0.f;
  }
  // no rank leaves while another may still read its s_part
  if constexpr (C > 1) cg::this_cluster().sync();
}

template <int T>
__global__ void __launch_bounds__(T)
normalize_block_kernel(const float* __restrict__ log_w,
                       const uint8_t* __restrict__ mask, int n,
                       float* __restrict__ out) {
  normalize_rows<T, 1>(log_w, mask, n, out);
}

__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
__launch_bounds__(kThreads)
normalize_cluster_kernel(const float* __restrict__ log_w,
                         const uint8_t* __restrict__ mask, int n,
                         float* __restrict__ out) {
  normalize_rows<kThreads, kClusterBlocks>(log_w, mask, n, out);
}

// Passes mode: three sweeps over n rows by one block.
__global__ void __launch_bounds__(kThreads)
normalize_passes_kernel(const float* __restrict__ log_w,
                        const uint8_t* __restrict__ mask, int n,
                        float* __restrict__ out) {
  __shared__ float s_max_part[32], s_sum_part[32];
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = (mask != nullptr && !mask[i]) ? -INFINITY : log_w[i];
    m = nan_max(m, v);
  }
  m = block_reduce<kThreads>(m, true, s_max_part);
  const float safe = isfinite(m) ? m : 0.f;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = (mask != nullptr && !mask[i]) ? -INFINITY : log_w[i];
    const float e = expf(v - safe);
    out[i] = e;
    s += e;
  }
  s = block_reduce<kThreads>(s, false, s_sum_part);
  for (int i = threadIdx.x; i < n; i += kThreads)
    out[i] = s > 0.f ? out[i] / s : 0.f;
}

struct EpsArgs {
  const float* d;
  const uint8_t* mask;  // nullptr: every row kept
  const float* w;       // nullptr: the mask as float (unweighted)
  int n;
  float alpha;
  float multiplier;
  float* out;
};

// T threads on one block (C = 1) or a cluster; the slice's keys and
// fixed-point weights in dynamic shared memory (12 bytes a row).
template <int T, int C>
__device__ void quantile_rows(const EpsArgs a) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ unsigned s_cnt[2][kBins];  // pass p fills buffer p & 1
  __shared__ unsigned long long s_wsum[2][kBins];
  // the cluster's histogram, merged over the ranks
  __shared__ unsigned s_mcnt[C > 1 ? kBins : 1];
  __shared__ unsigned long long s_mw[C > 1 ? kBins : 1];
  __shared__ float s_max_part[32];
  __shared__ float s_wmax;
  __shared__ int s_bad, s_one, s_has;
  __shared__ uint32_t s_prefix, s_found;
  __shared__ unsigned long long s_below, s_total;
  int lo, hi;
  my_rows<C>(a.n, &lo, &hi);
  const int rows = hi - lo;
  const int cap = C == 1 ? a.n : (a.n + C - 1) / C;
  unsigned long long* s_fix = reinterpret_cast<unsigned long long*>(s_dyn);
  uint32_t* s_key = reinterpret_cast<uint32_t*>(s_fix + cap);
  const int lane = threadIdx.x & 31;

  for (int b = threadIdx.x; b < kBins; b += T) {
    s_cnt[0][b] = 0;
    s_wsum[0][b] = 0;
  }
  if (threadIdx.x == 0) s_has = 0;
  // one read: keys, and the weights' bits until their scale is known
  float wmax = 0.f;
  int bad = 0;
  for (int i = threadIdx.x; i < rows; i += T) {
    const int j = lo + i;
    const bool keep = a.mask == nullptr || a.mask[j];
    const float x = keep ? a.d[j] : INFINITY;
    const float wt = keep ? (a.w != nullptr ? a.w[j] : 1.f) : 0.f;
    s_key[i] = pyabc_select::key_of(x);
    s_fix[i] = __float_as_uint(wt);
    bad |= !(wt >= 0.f) || isinf(wt);
    wmax = fmaxf(wmax, wt);
  }
  wmax = block_reduce<T>(wmax, true, s_max_part);
  bad = __syncthreads_or(bad);
  if constexpr (C > 1) {
    if (threadIdx.x == 0) {
      s_wmax = wmax;
      s_bad = bad;
    }
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    wmax = fold_ranks<C>(&s_wmax, true);
    for (int r = 0; r < C; ++r) bad |= *cl.map_shared_rank(&s_bad, r);
  }
  // w 2^(46 - e) < 2^46 for wmax = f 2^e, f in [0.5, 1): exact in double
  int e = 0;
  frexpf(wmax, &e);
  for (int i = threadIdx.x; i < rows; i += T) {
    const float wt = __uint_as_float((uint32_t)s_fix[i]);
    s_fix[i] = bad ? 0ull : __double2ull_rz(ldexp((double)wt, kFixedBits - e));
  }

  uint32_t prefix = 0;
  unsigned long long below = 0, total = 0;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t hmask = pass == 0 ? 0u : (0xFFFFFFFFu << (32 - 8 * pass));
    unsigned* cnt = s_cnt[pass & 1];
    unsigned long long* wsum = s_wsum[pass & 1];
    // the next pass's bins, last read before the barrier that ended the
    // pass before this one
    for (int b = threadIdx.x; b < kBins; b += T) {
      s_cnt[(pass + 1) & 1][b] = 0;
      s_wsum[(pass + 1) & 1][b] = 0;
    }
    for (int i0 = 0; i0 < rows; i0 += T) {  // the same trips block-wide
      const int i = i0 + threadIdx.x;
      uint32_t key = 0;
      bool in = false;
      if (i < rows) {
        key = s_key[i];
        in = ((key ^ prefix) & hmask) == 0;
      }
      const unsigned act = __ballot_sync(kFull, in);
      if (in) {
        const unsigned bin = (key >> shift) & 0xFFu;
        const unsigned peers = __match_any_sync(act, bin);
        const unsigned long long f = s_fix[i];  // < 2^46: two 23-bit halves
        const unsigned lo23 =
            __reduce_add_sync(peers, (unsigned)(f & 0x7FFFFFu));
        const unsigned hi23 = __reduce_add_sync(peers, (unsigned)(f >> 23));
        if (lane == __ffs(peers) - 1) {
          atomicAdd(&cnt[bin], (unsigned)__popc(peers));
          atomicAdd(&wsum[bin], ((unsigned long long)hi23 << 23) + lo23);
        }
      }
    }
    cluster_or_block_sync<C>();
    const unsigned* h_cnt = cnt;
    const unsigned long long* h_w = wsum;
    if constexpr (C > 1) {
      cg::cluster_group cl = cg::this_cluster();
      for (int b = threadIdx.x; b < kBins; b += T) {
        unsigned c = 0;
        unsigned long long w = 0;
        for (int r = 0; r < C; ++r) {
          c += *cl.map_shared_rank(&cnt[b], r);
          w += *cl.map_shared_rank(&wsum[b], r);
        }
        s_mcnt[b] = c;
        s_mw[b] = w;
      }
      __syncthreads();
      h_cnt = s_mcnt;
      h_w = s_mw;
    }
    if (threadIdx.x < 32) {
      // warp 0: lane l holds bins 8l .. 8l + 7
      unsigned c[8];
      unsigned long long wb[8];
      unsigned long long lane_w = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        c[k] = h_cnt[lane * 8 + k];
        wb[k] = h_w[lane * 8 + k];
        lane_w += wb[k];
      }
      unsigned long long incl = lane_w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long up = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += up;
      }
      if (pass == 0) total = __shfl_sync(kFull, incl, 31);
      unsigned long long cum = below + incl - lane_w;
      int first = -1, last = -1;
      unsigned first_c = 0, last_c = 0;
      unsigned long long first_before = 0, last_before = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (c[k] == 0) continue;
        const unsigned long long before = cum;
        cum += wb[k];
        last = k;
        last_c = c[k];
        last_before = before;
        // an all-zero (or poisoned) total leaves the plain cdf NaN, and
        // its search runs off the end: the largest point is taken
        if (first < 0 && total > 0 &&
            (float)((double)cum / (double)total) >= a.alpha) {
          first = k;
          first_c = c[k];
          first_before = before;
        }
      }
      const unsigned hit = __ballot_sync(kFull, first >= 0);
      const unsigned any = __ballot_sync(kFull, last >= 0);
      const int src = hit ? __ffs(hit) - 1 : 31 - __clz(any);
      const int k_sel = __shfl_sync(kFull, hit ? first : last, src);
      const unsigned c_sel = __shfl_sync(kFull, hit ? first_c : last_c, src);
      const unsigned long long b_sel =
          __shfl_sync(kFull, hit ? first_before : last_before, src);
      if (lane == 0) {
        s_prefix = prefix | ((uint32_t)(src * 8 + k_sel) << shift);
        s_below = b_sel;
        s_total = total;
        s_one = c_sel == 1;
      }
    }
    // every rank has read this pass's bins before the next pass clears them
    cluster_or_block_sync<C>();
    prefix = s_prefix;
    below = s_below;
    total = s_total;
    if (pass < 3 && s_one) {
      // one candidate left: its key is what the remaining passes select
      const uint32_t chosen = 0xFFFFFFFFu << shift;
      for (int i = threadIdx.x; i < rows; i += T) {
        const uint32_t key = s_key[i];
        if (((key ^ prefix) & chosen) == 0) {
          s_found = key;
          s_has = 1;
        }
      }
      cluster_or_block_sync<C>();
      if constexpr (C > 1) {
        cg::cluster_group cl = cg::this_cluster();
        for (int r = 0; r < C; ++r)
          if (*cl.map_shared_rank(&s_has, r))
            prefix = *cl.map_shared_rank(&s_found, r);
        cl.sync();  // no rank leaves while another may still read it
      } else {
        prefix = s_found;
      }
      break;
    }
  }
  if (lo == 0 && threadIdx.x == 0)
    *a.out = __fmul_rn(pyabc_select::float_of(prefix), a.multiplier);
}

template <int T>
__global__ void __launch_bounds__(T) quantile_block_kernel(EpsArgs a) {
  quantile_rows<T, 1>(a);
}

__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
__launch_bounds__(kThreads) quantile_cluster_kernel(EpsArgs a) {
  quantile_rows<kThreads, kClusterBlocks>(a);
}

// Passes mode: the masked points and weights for select.cuh, and the
// multiplier after it.
__global__ void masked_points_kernel(EpsArgs a, float* __restrict__ pts,
                                     float* __restrict__ wts) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += gridDim.x * blockDim.x) {
    const bool keep = a.mask == nullptr || a.mask[i];
    pts[i] = keep ? a.d[i] : INFINITY;
    wts[i] = keep ? (a.w != nullptr ? a.w[i] : 1.f) : 0.f;
  }
}

__global__ void multiply_kernel(const float* __restrict__ q, float m,
                                float* __restrict__ out) {
  *out = __fmul_rn(*q, m);
}

size_t quantile_smem(int rows) {
  return (size_t)rows * (sizeof(unsigned long long) + sizeof(uint32_t));
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The attribute belongs to the kernels on the current device: raise it once
// a device (two threads that race both set it, which is harmless).
constexpr int kMaxDevices = 64;
std::atomic<bool> smem_set[kMaxDevices];

cudaError_t allow_quantile_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev < kMaxDevices;
  if (known && smem_set[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  const size_t most = quantile_smem(kBlockRows);
  err = allow_smem((const void*)quantile_block_kernel<kThreads>, most);
  if (err == cudaSuccess)
    err = allow_smem((const void*)quantile_cluster_kernel, most);
  if (err == cudaSuccess && known)
    smem_set[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// Modes by size (the wrapper counts them): block n <= 16384, cluster n <=
// 131072, passes above.
extern "C" int pyabc_normalize_log_weights(const float* log_w,
                                           const uint8_t* mask, int n,
                                           float* out, void* stream_ptr) {
  if (n <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= kBlockRows)
    normalize_block_kernel<kThreads><<<1, kThreads, 0, stream>>>(
        log_w, mask, n, out);
  else if (n <= kClusterRows)
    normalize_cluster_kernel<<<kClusterBlocks, kThreads, 0, stream>>>(
        log_w, mask, n, out);
  else
    normalize_passes_kernel<<<1, kThreads, 0, stream>>>(log_w, mask, n, out);
  return static_cast<int>(cudaGetLastError());
}

// workspace: passes mode only, select.cuh's for one weighted column and
// then 2 n + 1 floats (the masked points and weights, the quantile).
extern "C" int pyabc_quantile_epsilon(const float* d, const uint8_t* mask,
                                      const float* w, int n, float alpha,
                                      float multiplier, void* workspace,
                                      float* out, void* stream_ptr) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const EpsArgs a{d, mask, w, n, alpha, multiplier, out};
  const cudaError_t err = allow_quantile_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= kBlockRows) {
    quantile_block_kernel<kThreads>
        <<<1, kThreads, quantile_smem(n), stream>>>(a);
  } else if (n <= kClusterRows) {
    quantile_cluster_kernel<<<kClusterBlocks, kThreads,
                              quantile_smem((n + kClusterBlocks - 1) /
                                            kClusterBlocks),
                              stream>>>(a);
  } else {
    char* ws = static_cast<char*>(workspace);
    float* pts = reinterpret_cast<float*>(
        ws + pyabc_select::workspace_bytes(1, 1, true));
    float* wts = pts + n;
    float* q = wts + n;
    masked_points_kernel<<<min(1024, (n + 255) / 256), 256, 0, stream>>>(
        a, pts, wts);
    const pyabc_select::Source src{pts, 1, nullptr, wts, nullptr, 0};
    pyabc_select::select_run(src, n, 1, 1, pyabc_select::kQuantile, alpha,
                             true, workspace, q, stream);
    multiply_kernel<<<1, 1, 0, stream>>>(q, multiplier, out);
  }
  return static_cast<int>(cudaGetLastError());
}
