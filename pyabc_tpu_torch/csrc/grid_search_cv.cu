// K17 grid_search_cv: GridSearchCV's cross-validated bandwidth selection
// over the MVN scaling, the refit of a generation step.
//
// Replaces: pyabc_tpu/transition/grid_search.py::GridSearchCV.device_fit
// (:119-208) with fold_ids (:22-35), as the JAX package's fused refit calls
// it per model (inference/util.py:1898-1948).
//
// On thetas (n, d) (d = d_max, the first dim real), the normalized weights
// (n,), the fold ids folds (n,) (-1: no fold) with F folds and C candidate
// scalings s_i, for each model k (weights masked to m == k; one model: m
// null):
//   fold f: K8's fit at scaling 1 on w~ = where(folds != f, w_k, 0)
//   (mvn_fit.cuh: weights renormalized, the bandwidth from the fold's own
//   ESS, the jitter ladder), giving P_f, logdet_f and the fit weights
//   w_j = w~_j / ws_f;
//   each held-out row q (folds[q] == f, w_k[q] > 0), for every scaling:
//   logdens_i = logsumexp_j(log w_j - 0.5 (dim log 2 pi + logdet_f
//   + 2 dim log s_i + maha_qj / s_i^2)), maha_qj = (q - theta_j)' P_f
//   (q - theta_j) over the components of positive weight, floored at
//   log(1e-300); score_i += sum_q w_k[q] logdens_i (0 for a fold with
//   fewer than 2 train rows of positive weight or no test row of positive
//   weight: the JAX package's fold_ok);
//   the winner: the first maximum of the scores (NaN first, as argmax);
//   the full-data fit at scaling 1 (K8's own entry) scaled by s_best:
//   chol s, prec / s^2, quad / s^2, logdet + 2 dim log s.
// A skipped test row (weight 0) or component (weight 0) adds 0 in the JAX
// package's masked form too.
//
// Bound on an H100: operations. The held-out pairs (q, j) number about
// n^2 (F - 1) / F a model, each d^2 + 2 d multiply-adds and C
// exponentials: at LV config 2 under a 5-point grid with cv 5 (n 1000,
// d 4) some 8e5 pairs, at n 16384 some 2.1e8 (1.1e9 exponentials). The fold
// fits read n (d + 2) floats F times.
//
// Design, in six launches on the caller's stream:
//   1. fold lists (one block a model): each model's rows of positive
//      weight grouped by fold, by an ordered block compaction per fold,
//      with the fold offsets and the count of positive rows;
//   2. fold fits (one block a fold and model): mvn_fit.cuh's fit on the
//      train weights, keeping P_f, logdet_f and ws_f;
//   3. scoring (a block of 128 held-out rows of one fold and model, and a
//      split of the components): each thread keeps its row in registers
//      and C online log-sum-exp states (the scalings share the maha); the
//      block stages 128 components (theta_j, log w_j) at a time in shared
//      memory beside P_f; the splits' states go to scratch;
//   4. fold sums (one block a fold and model): each row merges its splits'
//      states in order, adds the scaling's constant, floors and weights
//      it; a fixed tree sums the rows, so a shape always gives the same
//      bits;
//   5. the full fit: K8's entry (mvn_fit.cu) at scaling 1;
//   6. finish (one block a model): the scores summed over the folds in
//      order, the argmax, and the full fit scaled by the winner.
// A simple kernel, not a fast one: no tensor cores; a fold's blocks beyond
// its test rows return at once.
#include "common.cuh"
#include "mvn_fit.cuh"

extern "C" int pyabc_mvn_fit(const float* thetas, const float* weights,
                             int n, int d, int dim, float scaling,
                             int selector, float sel_const, float sel_exp,
                             float* th, float* w, float* chol, float* prec,
                             float* center, float* thc, float* quad,
                             float* logdet, float* cdf, void* stream_ptr);
extern "C" int pyabc_mvn_fit_models(
    const float* thetas, const float* weights, const int* m, int n_models,
    int n, int d, const int* dims, const float* scaling, const int* selector,
    const float* sel_const, const float* sel_exp, float* th, float* w,
    float* chol, float* prec, float* center, float* thc, float* quad,
    float* logdet, float* cdf, void* stream_ptr);

namespace {

using pyabc::FitShared;
using pyabc::FitThreads;
constexpr int kMaxModels = 8;
constexpr int kMaxC = 16;
constexpr int kMaxFolds = 64;
constexpr int kRows = 128;  // held-out rows of a scoring block
constexpr int kTile = 128;  // components a scoring block stages at once
constexpr int kListThreads = 1024;
constexpr int kSumThreads = 256;
constexpr int kFinishThreads = 1024;
constexpr float kLogFloor = -690.775527898213705f;  // log(1e-300)
constexpr double kLog2Pi = 1.8378770664093453;

// per-model fit statics and the scalings, passed by value
struct GridModels {
  int dim[kMaxModels];
  int selector[kMaxModels];
  float sel_const[kMaxModels];
  float sel_exp[kMaxModels];
};
struct Scalings {
  float s[kMaxC];
};

__device__ __forceinline__ float weight_of(const float* w, const int* m,
                                           int model, int i) {
  return (m == nullptr || m[i] == model) ? w[i] : 0.f;
}

// Exclusive block scan of one int a thread; *total gets the block's sum.
__device__ int block_exclusive_scan_int(int v, int* s_warp, int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int incl = warp_inclusive_scan(v);
  __syncthreads();
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_inclusive_scan(lane < nw ? s_warp[lane] : 0);
    s_warp[lane] = t;
  }
  __syncthreads();
  *total = s_warp[nw - 1];
  return (warp > 0 ? s_warp[warp - 1] : 0) + incl - v;
}

// 1. each model's rows of positive weight grouped by fold, in row order
// within a fold: lists (K, n), offsets (K, F + 2) = the F + 1 fold
// offsets and the count of positive rows
__global__ void __launch_bounds__(kListThreads)
fold_lists_kernel(const float* __restrict__ w, const int* __restrict__ m,
                  const int* __restrict__ folds, int n, int F,
                  int* __restrict__ lists, int* __restrict__ offsets) {
  __shared__ int s_warp[32];
  const int k = blockIdx.x, tid = threadIdx.x;
  const int chunk = (n + kListThreads - 1) / kListThreads;
  const int a = min(n, tid * chunk), b = min(n, a + chunk);
  int* list = lists + (size_t)k * n;
  int* off = offsets + (size_t)k * (F + 2);
  int np = 0;
  for (int i = a; i < b; ++i) np += weight_of(w, m, k, i) > 0.f;
  int npos;
  block_exclusive_scan_int(np, s_warp, &npos);
  int base = 0;
  for (int f = 0; f < F; ++f) {
    int c = 0;
    for (int i = a; i < b; ++i)
      c += folds[i] == f && weight_of(w, m, k, i) > 0.f;
    int total;
    int pos = base + block_exclusive_scan_int(c, s_warp, &total);
    for (int i = a; i < b; ++i)
      if (folds[i] == f && weight_of(w, m, k, i) > 0.f) list[pos++] = i;
    if (tid == 0) off[f] = base;
    base += total;
  }
  if (tid == 0) {
    off[F] = base;
    off[F + 1] = npos;
  }
}

// fold f's train rows of model k as a row source of mvn_fit.cuh
struct FoldRows {
  const float* thetas;
  const float* wts;
  const int* m;
  const int* folds;
  int model, fold, d;
  __device__ __forceinline__ float raw_weight(int i) const {
    return folds[i] != fold ? weight_of(wts, m, model, i) : 0.f;
  }
  __device__ __forceinline__ float theta(int i, int k) const {
    return thetas[(size_t)i * d + k];
  }
  __device__ __forceinline__ void put_w(int, float) const {}
  __device__ __forceinline__ float w(int i, float ws) const {
    return raw_weight(i) / ws;
  }
};

// 2. fold fits: fold_fit (K, F, d d + 2) = P_f (masked), logdet_f, ws_f
template <int D>
__global__ void __launch_bounds__(FitThreads<D>::value)
fold_fit_kernel(const float* __restrict__ thetas,
                const float* __restrict__ w, const int* __restrict__ m,
                const int* __restrict__ folds, int n, int d, int F,
                GridModels gm, float* __restrict__ fold_fit) {
  constexpr int kThreads = FitThreads<D>::value;
  __shared__ FitShared<D, kThreads> sh;
  const int f = blockIdx.x, k = blockIdx.y, tid = threadIdx.x;
  const FoldRows rows{thetas, w, m, folds, k, f, d};
  const float ws = pyabc::fit_params<D, kThreads>(
      rows, n, d, gm.dim[k], 1.f, gm.selector[k], gm.sel_const[k],
      gm.sel_exp[k], sh);
  float* out = fold_fit + ((size_t)k * F + f) * (d * d + 2);
  for (int p = tid; p < d * d; p += kThreads)
    out[p] = sh.prec[(p / d) * D + p % d];
  if (tid == 0) {
    out[d * d] = sh.logdet;
    out[d * d + 1] = ws;
  }
}

// 3. the split log-sum-exp states parts (K, S, n, C, 2) = (max, sum) of
// log w_j - 0.5 maha_qj / s_i^2 over split z's components, at each held-out
// row's place in its model's list
template <int D>
__global__ void __launch_bounds__(kRows)
score_kernel(const float* __restrict__ thetas, const float* __restrict__ w,
             const int* __restrict__ m, const int* __restrict__ folds,
             const int* __restrict__ lists, const int* __restrict__ offsets,
             const float* __restrict__ fold_fit, int n, int d, int F, int C,
             int S, GridModels gm, Scalings sc, float* __restrict__ parts) {
  const int f = blockIdx.y % F, k = blockIdx.y / F, z = blockIdx.z;
  const int* off = offsets + (size_t)k * (F + 2);
  const int lo = off[f], cnt = off[f + 1] - lo;
  const int r0 = blockIdx.x * kRows;
  if (r0 >= cnt) return;  // the whole block: no row of this fold left
  __shared__ float s_th[kTile * D];
  __shared__ float s_lw[kTile];
  __shared__ float s_prec[D * D];
  __shared__ float s_inv[kMaxC];
  const int tid = threadIdx.x;
  const float* ff = fold_fit + ((size_t)k * F + f) * (d * d + 2);
  const float ws = ff[d * d + 1];
  const int dim = gm.dim[k];
  for (int p = tid; p < D * D; p += kRows) {
    const int a = p / D, b = p % D;
    s_prec[p] = (a < d && b < d) ? ff[a * d + b] : 0.f;
  }
  if (tid < C) s_inv[tid] = 1.f / expf(2.f * logf(sc.s[tid]));
  const int pos = r0 + tid;
  const bool live = pos < cnt;
  const int row = live ? lists[(size_t)k * n + lo + pos] : 0;
  float q[D];
#pragma unroll
  for (int c = 0; c < D; ++c)
    q[c] = (live && c < d) ? thetas[(size_t)row * d + c] : 0.f;
  float mx[kMaxC], sm[kMaxC];
#pragma unroll
  for (int i = 0; i < kMaxC; ++i) {
    mx[i] = -INFINITY;
    sm[i] = 0.f;
  }
  const int per = ((n + S - 1) / S + kTile - 1) / kTile * kTile;
  const int j0 = z * per, j1 = min(n, j0 + per);
  for (int t0 = j0; t0 < j1; t0 += kTile) {
    __syncthreads();  // the last tile's reads are done (and s_prec ready)
    for (int jj = tid; jj < kTile; jj += kRows) {
      const int j = t0 + jj;
      float lw = -INFINITY;
      if (j < j1) {
        const float raw = folds[j] != f ? weight_of(w, m, k, j) : 0.f;
        if (raw > 0.f) lw = logf(raw / ws);
#pragma unroll
        for (int c = 0; c < D; ++c)
          s_th[jj * D + c] =
              (c < d && c < dim) ? thetas[(size_t)j * d + c] : 0.f;
      }
      s_lw[jj] = lw;
    }
    __syncthreads();
    const int tn = min(kTile, j1 - t0);
    for (int jj = 0; jj < tn; ++jj) {
      const float lw = s_lw[jj];
      if (lw == -INFINITY) continue;  // the same for every thread
      float u[D];
#pragma unroll
      for (int c = 0; c < D; ++c) u[c] = q[c] - s_th[jj * D + c];
      float maha = 0.f;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        float pu = 0.f;
#pragma unroll
        for (int b = 0; b < D; ++b) pu += s_prec[a * D + b] * u[b];
        maha += u[a] * pu;
      }
#pragma unroll
      for (int i = 0; i < kMaxC; ++i) {
        if (i >= C) break;
        const float x = lw - 0.5f * (maha * s_inv[i]);
        if (x > mx[i]) {
          sm[i] = sm[i] * expf(mx[i] - x) + 1.f;
          mx[i] = x;
        } else {
          sm[i] += expf(x - mx[i]);
        }
      }
    }
  }
  if (!live) return;
  float* out = parts + (((size_t)k * S + z) * n + lo + pos) * C * 2;
  for (int i = 0; i < C; ++i) {
    out[2 * i] = mx[i];
    out[2 * i + 1] = sm[i];
  }
}

// 4. fold sums: fold_scores (K, F, C), 0 for a fold that fold_ok skips
__global__ void __launch_bounds__(kSumThreads)
fold_sum_kernel(const float* __restrict__ w, const int* __restrict__ lists,
                const int* __restrict__ offsets,
                const float* __restrict__ fold_fit,
                const float* __restrict__ parts, int n, int d, int F, int C,
                int S, GridModels gm, Scalings sc,
                float* __restrict__ fold_scores) {
  __shared__ float s_red[kMaxC * kSumThreads];
  const int f = blockIdx.x, k = blockIdx.y, tid = threadIdx.x;
  const int* off = offsets + (size_t)k * (F + 2);
  const int lo = off[f], cnt = off[f + 1] - lo, npos = off[F + 1];
  const float logdet = fold_fit[((size_t)k * F + f) * (d * d + 2) + d * d];
  const int dim = gm.dim[k];
  const float dim_2pi = (float)(dim * kLog2Pi);
  float cst[kMaxC], acc[kMaxC];
#pragma unroll
  for (int i = 0; i < kMaxC; ++i) {
    cst[i] = i < C ? -0.5f * (dim_2pi + logdet
                               + (2.f * dim) * logf(sc.s[i]))
                   : 0.f;
    acc[i] = 0.f;
  }
  for (int p = tid; p < cnt; p += kSumThreads) {
    const int row = lists[(size_t)k * n + lo + p];
    const float qw = w[row];
#pragma unroll
    for (int i = 0; i < kMaxC; ++i) {
      if (i >= C) break;
      float M = -INFINITY, sum = 0.f;
      for (int z = 0; z < S; ++z) {
        const float* st = parts + (((size_t)k * S + z) * n + lo + p) * C * 2;
        const float mz = st[2 * i], sz = st[2 * i + 1];
        if (mz == -INFINITY) continue;
        if (mz > M) {
          sum = sum * expf(M - mz) + sz;
          M = mz;
        } else {
          sum += sz * expf(mz - M);
        }
      }
      const float lse = M == -INFINITY ? -INFINITY : M + logf(sum);
      acc[i] += qw * nan_max(cst[i] + lse, kLogFloor);
    }
  }
  for (int i = 0; i < C; ++i) s_red[i * kSumThreads + tid] = acc[i];
  __syncthreads();
  for (int h = kSumThreads / 2; h > 0; h >>= 1) {
    if (tid < h)
      for (int i = 0; i < C; ++i)
        s_red[i * kSumThreads + tid] += s_red[i * kSumThreads + tid + h];
    __syncthreads();
  }
  if (tid < C) {
    const bool ok = npos - cnt >= 2 && cnt >= 1;
    fold_scores[((size_t)k * F + f) * C + tid] =
        ok ? s_red[tid * kSumThreads] : 0.f;
  }
}

// 6. finish: the scores, the winner and the full fit scaled by it
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const float* __restrict__ fold_scores, int n, int d, int F,
              int C, GridModels gm, Scalings sc, float* __restrict__ chol,
              float* __restrict__ prec, float* __restrict__ quad,
              float* __restrict__ logdet, float* __restrict__ scores,
              int* __restrict__ best) {
  __shared__ float s_best;
  const int k = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) {
    float v[kMaxC];
    for (int i = 0; i < C; ++i) {
      float t = 0.f;
      for (int f = 0; f < F; ++f) t += fold_scores[((size_t)k * F + f) * C + i];
      v[i] = t;
      scores[(size_t)k * C + i] = t;
    }
    int b = 0;
    float bv = v[0];
    for (int i = 1; i < C; ++i) {
      if (isnan(bv)) break;
      if (isnan(v[i]) || v[i] > bv) {
        b = i;
        bv = v[i];
      }
    }
    best[k] = b;
    const float s = sc.s[b];
    s_best = s;
    float* ch = chol + (size_t)k * d * d;
    float* pr = prec + (size_t)k * d * d;
    for (int p = 0; p < d * d; ++p) {
      ch[p] = ch[p] * s;
      pr[p] = pr[p] / (s * s);
    }
    logdet[k] = logdet[k] + (2.f * gm.dim[k]) * logf(s);
  }
  __syncthreads();
  const float s2 = s_best * s_best;
  float* qd = quad + (size_t)k * n;
  for (int i = tid; i < n; i += kFinishThreads) qd[i] = qd[i] / s2;
}

template <int D>
int launch_folds(const float* thetas, const float* w, const int* m,
                 const int* folds, const int* lists, const int* offsets,
                 int K, int n, int d, int F, int C, int S,
                 const GridModels& gm, const Scalings& sc, float* fold_fit,
                 float* parts, cudaStream_t stream) {
  fold_fit_kernel<D><<<dim3(F, K), FitThreads<D>::value, 0, stream>>>(
      thetas, w, m, folds, n, d, F, gm, fold_fit);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const dim3 grid((n + kRows - 1) / kRows, F * K, S);
  score_kernel<D><<<grid, kRows, 0, stream>>>(thetas, w, m, folds, lists,
                                              offsets, fold_fit, n, d, F, C,
                                              S, gm, sc, parts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m: (n,) int32 model of each row, or null for one model (K = 1); dims,
// scalings, selector, sel_const, sel_exp: host arrays (K, C, K, K, K
// entries); th ... cdf: K8's outputs (stacked over the models when K > 1);
// lists (K, n), offsets (K, F + 2), fold_fit (K, F, d d + 2), parts (K, S,
// n, C, 2), fold_scores (K, F, C): scratch; scores (K, C), best (K,).
extern "C" int pyabc_grid_search_cv(
    const float* thetas, const float* weights, const int* m,
    const int* folds, int K, int n, int d, int F, int C, int S,
    const int* dims, const float* scalings, const int* selector,
    const float* sel_const, const float* sel_exp, float* th, float* w,
    float* chol, float* prec, float* center, float* thc, float* quad,
    float* logdet, float* cdf, int* lists, int* offsets, float* fold_fit,
    float* parts, float* fold_scores, float* scores, int* best,
    void* stream_ptr) {
  if (n <= 0 || d <= 0 || d > 32 || K < 1 || K > kMaxModels || F < 1 ||
      F > kMaxFolds || C < 1 || C > kMaxC || S < 1 ||
      (K > 1 && m == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  GridModels gm{};
  float ones[kMaxModels];
  for (int k = 0; k < K; ++k) {
    gm.dim[k] = dims[k];
    gm.selector[k] = selector[k];
    gm.sel_const[k] = sel_const[k];
    gm.sel_exp[k] = sel_exp[k];
    ones[k] = 1.f;
  }
  Scalings sc{};
  for (int i = 0; i < C; ++i) sc.s[i] = scalings[i];
  fold_lists_kernel<<<K, kListThreads, 0, stream>>>(weights, m, folds, n, F,
                                                    lists, offsets);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
#define PYABC_FOLDS(DB)                                                      \
  err = launch_folds<DB>(thetas, weights, m, folds, lists, offsets, K, n, d, \
                         F, C, S, gm, sc, fold_fit, parts, stream)
  if (d <= 1)
    PYABC_FOLDS(1);
  else if (d <= 2)
    PYABC_FOLDS(2);
  else if (d <= 4)
    PYABC_FOLDS(4);
  else if (d <= 8)
    PYABC_FOLDS(8);
  else if (d <= 16)
    PYABC_FOLDS(16);
  else
    PYABC_FOLDS(32);
#undef PYABC_FOLDS
  if (err) return err;
  fold_sum_kernel<<<dim3(F, K), kSumThreads, 0, stream>>>(
      weights, lists, offsets, fold_fit, parts, n, d, F, C, S, gm, sc,
      fold_scores);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (m == nullptr)
    err = pyabc_mvn_fit(thetas, weights, n, d, dims[0], 1.f, selector[0],
                        sel_const[0], sel_exp[0], th, w, chol, prec, center,
                        thc, quad, logdet, cdf, stream_ptr);
  else
    err = pyabc_mvn_fit_models(thetas, weights, m, K, n, d, dims, ones,
                               selector, sel_const, sel_exp, th, w, chol,
                               prec, center, thc, quad, logdet, cdf,
                               stream_ptr);
  if (err) return err;
  finish_kernel<<<K, kFinishThreads, 0, stream>>>(fold_scores, n, d, F, C, gm,
                                                  sc, chol, prec, quad,
                                                  logdet, scores, best);
  return static_cast<int>(cudaGetLastError());
}
