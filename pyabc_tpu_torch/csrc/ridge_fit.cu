// K23 ridge_fit: the boundary refit of a linear learned summary statistic
// (Fearnhead-Prangle: theta regressed on the raw statistics of the
// generation's accepted reservoir).
//
// Replaces: pyabc_tpu/ops/fit.py::{masked_standardize (:54), ridge_fit
// (:69), keep_if_finite (:165)} as pyabc_tpu/inference/util.py:1777-1811
// calls them at a chunk's last active generation.
//
// The decision is read from the round counters in device memory, with no
// host read (fit_common.cuh, shared with the MLP fit): the kept rows are
// the first n_keep = min(n_acc, n_target). A fit that does not run
// returns from every pass at once, and the last one copies the old
// parameters.
//
// Passes (a stream of six launches, each a fixed order of sums, so a run
// repeats bit for bit; no float atomics):
//   1. per chunk of kRows rows, one thread a column: the column sums of x,
//      the sum of the weights and the weighted sums of y, in float64; one
//      block adds the chunks in order: mu = sum / n, the weights' scale n /
//      sum(w) and ym = sum(w y) scale / n;
//   2. the same for the squared deviations (x - mu)^2 (two passes, never
//      E[x^2] - mu^2: counts in the thousands would cancel in float32);
//      sd = sqrt(var), sd <= 1e-12 replaced by 1;
//   3. a grid of 32 x 32 tiles of Z^T diag(w) Z, Z = [xs | y - ym] (xs =
//      (x - mu) / sd in float32, as the JAX package forms it), over chunks
//      of kGramRows rows, partial sums in float64; one thread an entry adds
//      the chunks in order: A = xs^T diag(w) xs + alpha I, B = xs^T diag(w)
//      (y - ym);
//   4. one block factors A by Cholesky in dynamic shared memory (float64,
//      S (S + C + 1) doubles: at most 227 KB, hence S <= 160; a warp a row
//      of the trailing update, the pivot column copied aside so that no
//      two lanes read one bank), solves for the C columns of W (a warp a
//      column, each row's dot product across the warp, L^T copied into
//      the upper triangle for the back substitution's rows), and applies
//      keep_if_finite against the old parameters.
// flags[0] = the fit's parameters are finite (1 when no fit ran), flags[1]
// = the fit ran.
//
// Declared difference: the normal equations in float64 (JAX: float32 and
// LU). A is SPD for alpha > 0; float64 keeps the fit the same in any
// summation order where the Gram's condition number reaches 1e4.
//
// Bound on an H100: operations, the n S (S + C) multiply-adds of the Gram;
// the reads of x (n S floats, twice) come next. The design keeps every
// partial sum in float64 and the factorization in one block: simple and
// exact first.
#include "fit_common.cuh"

namespace {

using fit::decide;
using fit::Decision;
using fit::kRows;  // rows a block of passes 1-2 sums
using fit::kThreads;
using fit::warp_sum_f64;
constexpr int kGramRows = 1024;  // rows a block of pass 3 sums
constexpr int kTile = 32;

// pass 1: per chunk, thread q < S the column sum of x, q == S the weights'
// sum, S < q <= S + C the weighted sum of y's column q - S - 1
__global__ void __launch_bounds__(kThreads)
ridge_sums_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ w, int n_cap, int S, int C,
                  const int* __restrict__ counters, int need,
                  double* __restrict__ part) {
  const Decision dec = decide(counters, n_cap, need);
  if (!dec.fit) return;
  const int r0 = blockIdx.x * kRows;
  if (r0 >= dec.n_keep) return;
  const int r1 = min(r0 + kRows, dec.n_keep);
  const int Q = S + 1 + C;
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    double s = 0.0;
    if (q < S) {
      for (int r = r0; r < r1; ++r) s += (double)x[(size_t)r * S + q];
    } else if (q == S) {
      for (int r = r0; r < r1; ++r) s += (double)fmaxf(w[r], 0.f);
    } else {
      const int c = q - S - 1;
      for (int r = r0; r < r1; ++r)
        s += (double)fmaxf(w[r], 0.f) * (double)y[(size_t)r * C + c];
    }
    part[(size_t)blockIdx.x * Q + q] = s;
  }
}

// pass 1's finish (one block): mu (float32), the weights' scale and ym
__global__ void __launch_bounds__(kThreads)
ridge_sums_finish_kernel(const double* __restrict__ part, int n_cap, int S,
                         int C, const int* __restrict__ counters, int need,
                         float* __restrict__ mu, double* __restrict__ fin) {
  const Decision dec = decide(counters, n_cap, need);
  if (!dec.fit) return;
  const int chunks = (dec.n_keep + kRows - 1) / kRows;
  const int Q = S + 1 + C;
  const double n = fmax((double)dec.n_keep, 1.0);
  __shared__ double sw;
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int k = 0; k < chunks; ++k) s += part[(size_t)k * Q + S];
    sw = s;
    fin[0] = n;
    fin[1] = n / fmax(s, 1e-30);  // the weights' scale: sum to n
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    if (q == S) continue;
    double s = 0.0;
    for (int k = 0; k < chunks; ++k) s += part[(size_t)k * Q + q];
    if (q < S)
      mu[q] = (float)(s / n);
    else
      fin[2 + q - S - 1] = s * (n / fmax(sw, 1e-30)) / n;  // ym
  }
}

// Z[r, j]: xs = (x - mu) / sd for j < S, y - ym for S <= j < S + C
__device__ __forceinline__ double z_value(const float* x, const float* y,
                                          int r, int j, int S, int C,
                                          const float* mu, const float* sd,
                                          const double* ym) {
  if (j < S)
    return (double)__fdiv_rn(__fsub_rn(x[(size_t)r * S + j], mu[j]), sd[j]);
  return (double)y[(size_t)r * C + (j - S)] - ym[j - S];
}

// pass 3: tile (blockIdx.x, blockIdx.y) of Z^T diag(w') Z over the rows of
// chunk blockIdx.z, w' the weights scaled to sum n
__global__ void __launch_bounds__(kThreads)
ridge_gram_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ w, int n_cap, int S, int C,
                  const int* __restrict__ counters, int need,
                  const float* __restrict__ mu, const float* __restrict__ sd,
                  const double* __restrict__ fin, double* __restrict__ part) {
  const Decision dec = decide(counters, n_cap, need);
  if (!dec.fit) return;
  const int r0 = blockIdx.z * kGramRows;
  if (r0 >= dec.n_keep) return;
  const int r1 = min(r0 + kGramRows, dec.n_keep);
  const int Wd = S + C;
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  __shared__ double zi[kTile][kTile + 1];
  __shared__ double zj[kTile][kTile + 1];
  const double scale = fin[1];
  const double* ym = fin + 2;
  const int ti = threadIdx.x / kTile;  // 0..7: rows ti, ti + 8, ...
  const int tj = threadIdx.x % kTile;
  double acc[kTile * kTile / kThreads] = {0.0, 0.0, 0.0, 0.0};
  for (int rb = r0; rb < r1; rb += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += blockDim.x) {
      const int rr = e / kTile, cc = e % kTile;
      const int r = rb + rr;
      double a = 0.0, b = 0.0;
      if (r < r1) {
        const double wr = (double)fmaxf(w[r], 0.f) * scale;
        if (i0 + cc < S)
          a = z_value(x, y, r, i0 + cc, S, C, mu, sd, ym) * wr;
        if (j0 + cc < Wd) b = z_value(x, y, r, j0 + cc, S, C, mu, sd, ym);
      }
      zi[rr][cc] = a;
      zj[rr][cc] = b;
    }
    __syncthreads();
    for (int rr = 0; rr < kTile; ++rr) {
      const double bj = zj[rr][tj];
#pragma unroll
      for (int u = 0; u < kTile * kTile / kThreads; ++u)
        acc[u] += zi[rr][ti + u * (kThreads / kTile)] * bj;
    }
    __syncthreads();
  }
  double* out = part + (size_t)blockIdx.z * S * Wd;
#pragma unroll
  for (int u = 0; u < kTile * kTile / kThreads; ++u) {
    const int i = i0 + ti + u * (kThreads / kTile), j = j0 + tj;
    if (i < S && j < Wd) out[(size_t)i * Wd + j] = acc[u];
  }
}

// pass 3's finish: each entry adds its chunks in order; alpha on A's
// diagonal
__global__ void __launch_bounds__(kThreads)
ridge_gram_finish_kernel(const double* __restrict__ part, int n_cap, int S,
                         int C, const int* __restrict__ counters, int need,
                         double alpha, double* __restrict__ ab) {
  const Decision dec = decide(counters, n_cap, need);
  if (!dec.fit) return;
  const int chunks = (dec.n_keep + kGramRows - 1) / kGramRows;
  const int Wd = S + C;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= S * Wd) return;
  double s = 0.0;
  for (int k = 0; k < chunks; ++k) s += part[(size_t)k * S * Wd + e];
  if (e / Wd == e % Wd) s += alpha;
  ab[e] = s;
}

// pass 4: Cholesky of A and the solve for B's C columns in shared memory,
// then keep_if_finite and the outputs
__global__ void __launch_bounds__(kThreads)
ridge_solve_kernel(const double* __restrict__ ab, int n_cap, int S, int C,
                   const int* __restrict__ counters, int need,
                   const double* __restrict__ fin,
                   const float* __restrict__ W_old,
                   const float* __restrict__ b_old,
                   const float* __restrict__ mu_old,
                   const float* __restrict__ sd_old, float* __restrict__ W,
                   float* __restrict__ b, float* __restrict__ mu,
                   float* __restrict__ sd, int* __restrict__ flags) {
  extern __shared__ double sm[];
  const Decision dec = decide(counters, n_cap, need);
  const int Wd = S + C;
  __shared__ int ok;
  if (threadIdx.x == 0) ok = 1;
  if (dec.fit) {
    double* L = sm;          // (S, S), lower triangle
    double* X = sm + S * S;  // (S, C)
    for (int e = threadIdx.x; e < S * Wd; e += blockDim.x) {
      const int i = e / Wd, j = e % Wd;
      if (j < S)
        L[i * S + j] = ab[e];
      else
        X[i * C + (j - S)] = ab[e];
    }
    __syncthreads();
    double* colk = X + S * C;  // (S,) column k of L for the update
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    for (int k = 0; k < S; ++k) {
      if (threadIdx.x == 0) L[k * S + k] = sqrt(L[k * S + k]);
      __syncthreads();
      const double dkk = L[k * S + k];
      for (int i = k + 1 + threadIdx.x; i < S; i += blockDim.x) {
        const double v = L[i * S + k] / dkk;
        L[i * S + k] = v;
        colk[i] = v;
      }
      __syncthreads();
      // the trailing update, a warp a row: row i's entries (k, i], the
      // lanes on neighbouring columns
      for (int i = k + 1 + warp; i < S; i += n_warps) {
        const double ci = colk[i];
        for (int j = k + 1 + lane; j <= i; j += 32)
          L[i * S + j] -= ci * colk[j];
      }
      __syncthreads();
    }
    // L^T into the upper triangle: the back substitution reads rows
    for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
      const int i = e / S, j = e % S;
      if (j > i) L[i * S + j] = L[j * S + i];
    }
    __syncthreads();
    // L y = B, then L^T W = y: one warp a column, each row's dot product
    // across the warp's lanes
    for (int c = warp; c < C; c += n_warps) {
      for (int i = 0; i < S; ++i) {
        double s = 0.0;
        for (int k = lane; k < i; k += 32) s += L[i * S + k] * X[k * C + c];
        s = warp_sum_f64(s);
        if (lane == 0) X[i * C + c] = (X[i * C + c] - s) / L[i * S + i];
        __syncwarp();
      }
      for (int i = S - 1; i >= 0; --i) {
        double s = 0.0;
        for (int k = i + 1 + lane; k < S; k += 32)
          s += L[i * S + k] * X[k * C + c];
        s = warp_sum_f64(s);
        if (lane == 0) X[i * C + c] = (X[i * C + c] - s) / L[i * S + i];
        __syncwarp();
      }
    }
    __syncthreads();
    // keep_if_finite over W, b, mu and sd
    int bad = 0;
    for (int e = threadIdx.x; e < S * C; e += blockDim.x)
      bad |= !isfinite((float)X[e]);
    for (int e = threadIdx.x; e < C; e += blockDim.x)
      bad |= !isfinite((float)fin[2 + e]);
    for (int e = threadIdx.x; e < S; e += blockDim.x)
      bad |= !isfinite(mu[e]) | !isfinite(sd[e]);
    if (bad) atomicAnd(&ok, 0);
    __syncthreads();
  } else {
    __syncthreads();
  }
  const bool take = dec.fit && ok;
  const double* X = sm + S * S;
  for (int e = threadIdx.x; e < S * C; e += blockDim.x)
    W[e] = take ? (float)X[e] : W_old[e];
  for (int e = threadIdx.x; e < C; e += blockDim.x)
    b[e] = take ? (float)fin[2 + e] : b_old[e];
  for (int e = threadIdx.x; e < S; e += blockDim.x) {
    if (!take) {
      mu[e] = mu_old[e];
      sd[e] = sd_old[e];
    }
  }
  if (threadIdx.x == 0) {
    flags[0] = ok;
    flags[1] = dec.fit ? 1 : 0;
  }
}

}  // namespace

// x (n_cap, S), y (n_cap, C), w (n_cap,) the weights (exp of the
// normalized log weights; rows past n_keep are never read), counters the
// round counters (n_acc at 0, n_target at 4); *_old the parameters in
// effect; W, b, mu, sd the outputs; flags (2,) int32. Float64 scratch:
// part1 ceil(n_cap / kRows) (S + 1 + C), part3 ceil(n_cap / kGramRows) S
// (S + C), ab S (S + C) + 2 + C (kernels/ridge_fit.py sizes them).
extern "C" int pyabc_ridge_fit(
    const float* x, const float* y, const float* w, int n_cap, int S, int C,
    const int* counters, int need, float alpha, const float* W_old,
    const float* b_old, const float* mu_old, const float* sd_old, float* W,
    float* b, float* mu, float* sd, int* flags, double* part1,
    double* part3, double* ab, void* stream_ptr) {
  if (n_cap <= 0 || S <= 0 || C <= 0 || C > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(double) * (size_t)S * (S + C + 1);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // the solve's dynamic shared memory may use what the block's opt-in
  // limit leaves beside its static variables
  static int smem_cached = -1;
  const int smem_max = fit::raise_smem(ridge_solve_kernel, &smem_cached);
  if (smem_max < 0) return -smem_max;
  if ((long long)smem > smem_max)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n_cap + kRows - 1) / kRows;
  const int gchunks = (n_cap + kGramRows - 1) / kGramRows;
  double* fin = ab + (size_t)S * (S + C);
  ridge_sums_kernel<<<chunks, kThreads, 0, stream>>>(x, y, w, n_cap, S, C,
                                                     counters, need, part1);
  ridge_sums_finish_kernel<<<1, kThreads, 0, stream>>>(
      part1, n_cap, S, C, counters, need, mu, fin);
  fit::col_dev_kernel<<<chunks, kThreads, 0, stream>>>(x, n_cap, S,
                                                       counters, need, mu,
                                                       part1);
  fit::col_sd_kernel<<<1, kThreads, 0, stream>>>(part1, n_cap, S, counters,
                                                 need, sd);
  const dim3 grid((S + kTile - 1) / kTile, (S + C + kTile - 1) / kTile,
                  gchunks);
  ridge_gram_kernel<<<grid, kThreads, 0, stream>>>(
      x, y, w, n_cap, S, C, counters, need, mu, sd, fin, part3);
  const int entries = S * (S + C);
  ridge_gram_finish_kernel<<<(entries + kThreads - 1) / kThreads, kThreads,
                             0, stream>>>(part3, n_cap, S, C, counters, need,
                                          (double)alpha, ab);
  ridge_solve_kernel<<<1, kThreads, smem, stream>>>(
      ab, n_cap, S, C, counters, need, fin, W_old, b_old, mu_old, sd_old, W,
      b, mu, sd, flags);
  return static_cast<int>(cudaGetLastError());
}
