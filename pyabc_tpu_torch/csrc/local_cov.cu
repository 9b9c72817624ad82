// K12 local_cov: LocalTransition's k-nearest-neighbour covariance field.
//
// Replaces: pyabc_tpu/transition/local_transition.py::_device_cov_field
// with pyabc_tpu/ops/select.py::{radius_bisect, compact_within_radius,
// threshold_neighbors} (the plain twin is kernels/local_cov.py).
//
// Two launches on the caller's stream, skipped at once when the refit
// flag in device memory reads 0 (K15's cadence decision, no host branch):
//
// 1. prep (one block): w = weights / max(sum, 1e-38), the valid count
//    c = #(weights > 0), X = thetas * vmask, |x|^2 per row (the norm form),
//    k_dyn = min(k_table[c], k_cap) with the table built on the host in
//    float64 (an f32 product would round differently), the squared
//    Silverman factor at k_dyn times scaling, and the ancestor CDF
//    cummax(where(w > 0, cumsum(w), 0)) that K2's local mode searches.
// 2. field (one block of 256 threads per row i): the row's squared
//    distances into shared memory, the neighbour selection there, then the
//    covariance of the selected neighbours. Nothing of size (n, n) reaches
//    device memory.
//    - distances follow the JAX size rule: n_cap <= 4096 (dense) the diff
//      form sum_k (x_ik - x_jk)^2, above it |x_i|^2 + |x_j|^2 - 2 x_i.x_j
//      clamped at 0; invalid candidates (weight 0) are +inf. Each
//      operation is written with the _rn intrinsics (no FMA contraction),
//      in the plain version's order, so both give the same distances and
//      the same selections bit for bit.
//    - top-k: the k_dyn smallest by (distance, index) (lax.top_k's set):
//      a 32-step binary search on the float bits (distances are >= +0, so
//      their bits order like their values) finds the k_dyn-th value V with
//      block-wide counts; every candidate below V and the lowest-index
//      candidates equal to V are taken. The covariance divides by k_dyn.
//    - threshold: radius_bisect operation for operation on the [::stride]
//      subsample (hi0 the finite max or 0, lo0 0, 26 steps of
//      mid = 0.5 (lo + hi), ok = count(sq <= mid) >= ceil(k_dyn / stride)),
//      then the within-radius candidates compacted in candidate order into
//      a buffer of ceil(k_cap / stride), the count clipped to it. The
//      covariance divides by that realized count.
//    - covariance: sum over the selected valid neighbours of
//      (x_j - x_i)(x_j - x_i)^T (d^2 entries x neighbour groups over the
//      threads, then a shared-memory sum), / count, * factor^2, the real
//      block kept, max(trace / dim, 1e-10) EPS on the real diagonal and 1
//      on the padded one.
//
// Bound on an H100: operations. Per row at the scale lane (n_cap 16384,
// d 4, stride 4): 4096 distances, 26 counting passes over them and the
// covariance over ~1024 neighbours, some 3e5 operations, 5e9 for the
// field against 16384 x 16 floats written. The design pays one block
// barrier per bisection step (counts are warp sums, double-buffered in
// shared memory); a row's distances live only in shared memory.
#include "common.cuh"

namespace {

constexpr int kPrepThreads = 1024;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-3f;  // LocalTransition.EPS
constexpr int kBisectIters = 26;

__device__ float block_sum_f(float v, float* s_warp) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < nw ? s_warp[lane] : 0.f);
    if (lane == 0) s_warp[0] = v;
  }
  __syncthreads();
  return s_warp[0];
}

__device__ __forceinline__ float warp_scan_f(float v, bool is_max) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = is_max ? fmaxf(v, up) : v + up;
  }
  return v;
}

// Exclusive block scan (sum or max, values >= 0) of one float per thread.
__device__ float block_excl_scan_f(float v, bool is_max, float* s_warp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const float incl = warp_scan_f(v, is_max);
  __syncthreads();
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float t = lane < nw ? s_warp[lane] : 0.f;
    s_warp[lane] = warp_scan_f(t, is_max);
  }
  __syncthreads();
  const float before_warp = warp > 0 ? s_warp[warp - 1] : 0.f;
  const float up = __shfl_up_sync(0xffffffffu, incl, 1);
  const float in_warp = lane > 0 ? up : 0.f;
  return is_max ? fmaxf(before_warp, in_warp) : before_warp + in_warp;
}

__global__ void __launch_bounds__(kPrepThreads)
local_prep_kernel(const float* __restrict__ thetas,
                  const float* __restrict__ weights, int n, int d, int dim,
                  const int* __restrict__ k_table, int k_cap,
                  float sel_const, float sel_exp, float scaling,
                  const int* __restrict__ flag, float* __restrict__ X,
                  float* __restrict__ w_out, float* __restrict__ cdf,
                  float* __restrict__ norms, int* __restrict__ k_dyn_out,
                  float* __restrict__ factor2_out) {
  if (flag != nullptr && flag[0] == 0) return;
  __shared__ float s_warp[32];
  const int tid = threadIdx.x;
  float ws = 0.f, cv = 0.f;
  for (int i = tid; i < n; i += kPrepThreads) {
    const float w = weights[i];
    ws += w;
    cv += w > 0.f ? 1.f : 0.f;
  }
  ws = block_sum_f(ws, s_warp);
  const int c = (int)block_sum_f(cv, s_warp);  // exact below 2^24 rows
  const float denom = ws < 1e-38f ? 1e-38f : ws;
  for (int i = tid; i < n; i += kPrepThreads) {
    w_out[i] = weights[i] / denom;
    float nrm = 0.f;
    for (int k = 0; k < d; ++k) {
      const float x = thetas[(size_t)i * d + k] * (k < dim ? 1.f : 0.f);
      X[(size_t)i * d + k] = x;
      const float p = __fmul_rn(x, x);
      nrm = k == 0 ? p : __fadd_rn(nrm, p);
    }
    if (norms != nullptr) norms[i] = nrm;
  }
  if (tid == 0) {
    const int k_dyn = min(k_table[c], k_cap);
    const float f = sel_const * powf((float)k_dyn, sel_exp) * scaling;
    k_dyn_out[0] = k_dyn;
    factor2_out[0] = f * f;
  }
  __syncthreads();  // w_out written by every thread before the scan
  const int chunk = (n + kPrepThreads - 1) / kPrepThreads;
  const int a = min(n, tid * chunk), b = min(n, a + chunk);
  float run_sum = 0.f;
  for (int i = a; i < b; ++i) run_sum += w_out[i];
  float run = block_excl_scan_f(run_sum, false, s_warp);
  float local_max = 0.f;
  for (int i = a; i < b; ++i) {
    const float w = w_out[i];
    run += w;
    const float v = w > 0.f ? run : 0.f;
    local_max = fmaxf(local_max, v);
    cdf[i] = v;
  }
  float cur = block_excl_scan_f(local_max, true, s_warp);
  for (int i = a; i < b; ++i) {
    cur = fmaxf(cur, cdf[i]);
    cdf[i] = cur;
  }
}

// Block-wide count (every thread gets the total). `buf` is 2 x kWarps ints;
// alternating `parity` between calls lets one barrier per call suffice.
__device__ __forceinline__ int block_count(int v, int* buf, int parity) {
  v = __reduce_add_sync(0xffffffffu, (unsigned)v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) buf[parity * kWarps + warp] = v;
  __syncthreads();
  int tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot += buf[parity * kWarps + w];
  return tot;
}

// Exclusive block scan of one int per thread; `total` gets the sum.
__device__ __forceinline__ int block_excl_scan_i(int v, int* buf,
                                                 int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int incl = warp_inclusive_scan(v);
  __syncthreads();  // an earlier scan may still be reading buf
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  int before = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = buf[w];
    before += w < warp ? x : 0;
    tot += x;
  }
  *total = tot;
  return before + incl - v;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
local_field_kernel(const float* __restrict__ X,
                   const float* __restrict__ norms,
                   const float* __restrict__ weights, int n, int d, int dim,
                   const int* __restrict__ k_dyn_p,
                   const float* __restrict__ factor2_p, int k_cap, int topk,
                   int stride, const int* __restrict__ flag,
                   float* __restrict__ covs, int* __restrict__ cnt_out,
                   int* __restrict__ idx_out, int buf) {
  if (flag != nullptr && flag[0] == 0) return;
  extern __shared__ float smem[];
  const int m = topk ? n : (n + stride - 1) / stride;  // candidates
  float* s_sq = smem;
  int* s_idx = reinterpret_cast<int*>(smem + m);
  __shared__ int s_red[2 * kWarps];
  __shared__ int s_scan[kWarps];
  __shared__ float s_fred[2 * kWarps];
  constexpr int P = D * D;
  constexpr int G = kThreads >= P ? kThreads / P : 1;
  __shared__ float s_part[G * P];
  __shared__ float s_cov[P];
  const int i = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int k_dyn = k_dyn_p[0];
  const bool dense = norms == nullptr;
  float xi[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xi[k] = k < d ? X[(size_t)i * d + k] : 0.f;
  const float ni = dense ? 0.f : norms[i];

  // 1. the row's squared distances to the candidates (the subsample)
  for (int s = tid; s < m; s += kThreads) {
    const int j = topk ? s : s * stride;
    float v = INFINITY;
    if (weights[j] > 0.f) {
      const float* xj = X + (size_t)j * d;
      if (dense) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (k >= d) break;
          const float df = __fsub_rn(xi[k], xj[k]);
          const float p = __fmul_rn(df, df);
          v = k == 0 ? p : __fadd_rn(v, p);
        }
      } else {
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (k >= d) break;
          const float p = __fmul_rn(xi[k], xj[k]);
          dot = k == 0 ? p : __fadd_rn(dot, p);
        }
        v = __fsub_rn(__fadd_rn(ni, norms[j]), __fmul_rn(2.f, dot));
        v = v < 0.f ? 0.f : v;
      }
      if (v == 0.f) v = 0.f;  // +0: the bits then order like the values
    }
    s_sq[s] = v;
  }
  __syncthreads();

  // 2. selection into s_idx (candidate order), `sel` entries
  const int chunk = (m + kThreads - 1) / kThreads;
  const int a = min(m, tid * chunk), b = min(m, a + chunk);
  int sel = 0, parity = 0, total = 0;
  if (topk) {
    const int k = min(k_dyn, m);
    unsigned lo = 0u, hi = 0xffffffffu;
    while (lo < hi) {  // smallest V with count(bits <= V) >= k
      const unsigned mid = lo + ((hi - lo) >> 1);
      int c = 0;
      for (int s = tid; s < m; s += kThreads)
        c += __float_as_uint(s_sq[s]) <= mid ? 1 : 0;
      c = block_count(c, s_red, parity);
      parity ^= 1;
      if (c >= k)
        hi = mid;
      else
        lo = mid + 1;
    }
    const unsigned V = lo;
    int below = 0, eq = 0;
    for (int s = a; s < b; ++s) {
      const unsigned u = __float_as_uint(s_sq[s]);
      below += u < V ? 1 : 0;
      eq += u == V ? 1 : 0;
    }
    int n_below = 0;
    const int eq_before = block_excl_scan_i(eq, s_scan, &total);
    block_excl_scan_i(below, s_scan, &n_below);
    const int need = k - n_below;
    int mine = 0, r = eq_before;
    for (int s = a; s < b; ++s) {
      const unsigned u = __float_as_uint(s_sq[s]);
      mine += (u < V || (u == V && r++ < need)) ? 1 : 0;
    }
    int pos = block_excl_scan_i(mine, s_scan, &total);
    r = eq_before;
    for (int s = a; s < b; ++s) {
      const unsigned u = __float_as_uint(s_sq[s]);
      if (u < V || (u == V && r++ < need)) {
        if (pos < buf) s_idx[pos] = s;
        ++pos;
      }
    }
    sel = min(k, buf);
  } else {
    const int k_sub = (k_dyn + stride - 1) / stride;
    float mx = -INFINITY;
    for (int s = tid; s < m; s += kThreads) {
      const float v = s_sq[s];
      if (isfinite(v)) mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) s_fred[warp] = mx;
    __syncthreads();
    float hi = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) hi = fmaxf(hi, s_fred[w]);
    if (!isfinite(hi)) hi = 0.f;
    float lo = 0.f;
    for (int it = 0; it < kBisectIters; ++it) {
      const float mid = 0.5f * __fadd_rn(lo, hi);
      int c = 0;
      for (int s = tid; s < m; s += kThreads) c += s_sq[s] <= mid ? 1 : 0;
      c = block_count(c, s_red, parity);
      parity ^= 1;
      if (c >= k_sub)
        hi = mid;
      else
        lo = mid;
    }
    const float rad = hi;
    int mine = 0;
    for (int s = a; s < b; ++s) mine += s_sq[s] <= rad ? 1 : 0;
    int pos = block_excl_scan_i(mine, s_scan, &total);
    for (int s = a; s < b; ++s) {
      if (s_sq[s] <= rad) {
        if (pos < buf) s_idx[pos] = s * stride;
        ++pos;
      }
    }
    sel = min(total, buf);
  }
  __syncthreads();

  // 3. the neighbours' covariance: entry p of group g over q = g, g + G..
  for (int t = tid; t < G * P; t += kThreads) {
    const int p = t % P, g = t / P;
    const int k = p / D, l = p % D;
    float acc = 0.f;
    if (k < d && l < d) {
      const float xk = X[(size_t)i * d + k], xl = X[(size_t)i * d + l];
      for (int q = g; q < sel; q += G) {
        const int j = s_idx[q];
        if (weights[j] > 0.f) {
          const float ck = X[(size_t)j * d + k] - xk;
          const float cl = X[(size_t)j * d + l] - xl;
          acc += ck * cl;
        }
      }
    }
    s_part[t] = acc;
  }
  __syncthreads();
  if (tid < P) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += s_part[g * P + tid];
    const int div = topk ? k_dyn : sel;
    s_cov[tid] = s / (float)(div > 1 ? div : 1) * factor2_p[0];
  }
  __syncthreads();
  if (tid < P) {
    const int k = tid / D, l = tid % D;
    if (k < d && l < d) {
      float tr = 0.f;
      for (int e = 0; e < d; ++e) tr += s_cov[e * D + e];
      tr = tr / (float)dim;
      const float jit = (tr < 1e-10f ? 1e-10f : tr) * kEps;
      const bool real = k < dim && l < dim;
      float v = real ? s_cov[tid] : 0.f;
      if (k == l) v += k < dim ? jit : 1.f;
      covs[(size_t)i * d * d + k * d + l] = v;
    }
  }
  if (tid == 0) cnt_out[i] = topk ? k_dyn : sel;
  if (idx_out != nullptr)
    for (int p = tid; p < buf; p += kThreads)
      idx_out[(size_t)i * buf + p] = p < sel ? s_idx[p] : 0;
}

template <int D>
int launch_field(const float* X, const float* norms, const float* weights,
                 int n, int d, int dim, const int* k_dyn,
                 const float* factor2, int k_cap, int topk, int stride,
                 const int* flag, float* covs, int* cnt, int* idx, int buf,
                 cudaStream_t stream) {
  const int m = topk ? n : (n + stride - 1) / stride;
  const size_t smem = (size_t)m * sizeof(float) + (size_t)buf * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_field_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  local_field_kernel<D><<<n, kThreads, smem, stream>>>(
      X, norms, weights, n, d, dim, k_dyn, factor2, k_cap, topk, stride,
      flag, covs, cnt, idx, buf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// thetas (n, d), weights (n,), k_table (n + 1,) int32 on the device; flag
// nullable (int32, 0 = skip); norms null selects the diff form (dense);
// idx nullable (n, buf) int32. Scratch k_dyn (1 int) and factor2 (1 float)
// carry the prep kernel's scalars to the field kernel.
extern "C" int pyabc_local_cov(
    const float* thetas, const float* weights, int n, int d, int dim,
    const int* k_table, int k_cap, float sel_const, float sel_exp,
    float scaling, int topk, int stride, const int* flag, float* X,
    float* w, float* cdf, float* norms, int* k_dyn, float* factor2,
    float* covs, int* cnt, int* idx, int buf, void* stream_ptr) {
  if (n <= 0 || d <= 0 || d > 16 || dim <= 0 || dim > d || stride < 1 ||
      buf < 1 || k_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  local_prep_kernel<<<1, kPrepThreads, 0, stream>>>(
      thetas, weights, n, d, dim, k_table, k_cap, sel_const, sel_exp,
      scaling, flag, X, w, cdf, norms, k_dyn, factor2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
#define PYABC_FIELD(DB)                                                     \
  return launch_field<DB>(X, norms, weights, n, d, dim, k_dyn, factor2,   \
                          k_cap,                                           \
                          topk, stride, flag, covs, cnt, idx, buf, stream)
  if (d <= 1) PYABC_FIELD(1);
  if (d <= 2) PYABC_FIELD(2);
  if (d <= 4) PYABC_FIELD(4);
  if (d <= 8) PYABC_FIELD(8);
  PYABC_FIELD(16);
#undef PYABC_FIELD
}
