// K23 mlp_fit: the boundary refit of an MLP learned summary statistic
// (Fearnhead-Prangle: a tanh network of theta on the raw statistics of the
// generation's accepted reservoir), and the seed fit of MLPPredictor.fit.
//
// Replaces: pyabc_tpu/ops/fit.py::{masked_standardize (:54),
// _mlp_forward (:102), mlp_fit_steps (:112-162), keep_if_finite (:165)} as
// pyabc_tpu/inference/util.py:1777-1811 calls them at a chunk's last
// active generation; and the jitted Adam loop of
// pyabc_tpu/predictor/predictor.py::MLPPredictor.fit (:205-246), which
// runs here from a fresh init with the host's standardization.
//
// The decision comes from the round counters (fit_common.cuh, shared with
// the ridge fit). A fit is a stream of launches:
//   1. init: the working parameters (the output buffer) = the carried
//      ones (warm start), Adam's moments = 0; without standardization the
//      carried mu, sd, ymu, ysd are copied to the outputs;
//   2. with standardization, fit_common.cuh's column passes over x and
//      over y (mu, sd, ymu, ysd of the kept rows, float64 sums);
//   3. one block: the sum of max(w, 0) over the kept rows (float64, a
//      fixed order) -> the weights' divisor max(sum / n, 1e-30) and the
//      loss's 2 / (n C');
//   4. n_steps times: the step kernel, then the Adam kernel;
//   5. one block: keep_if_finite over every leaf (the layers, mu, sd, ymu,
//      ysd), the old parameters back where the fit did not run or is not
//      finite, flags = [ok, fit].
// The step kernel: each block takes a tile of kTileRows kept rows and holds
// the layers in shared memory (each weight row padded to an odd length,
// so neither the forward's nor the backward's reads meet on a bank). It
// standardizes its rows, runs the forward (tanh hidden layers, a linear
// head), the loss gradient (wts 2 / (n C') (pred - ys)) and the backward
// (g_z = (g @ w^T) (1 - h^2), in place over h once h's own weight gradient
// is taken) as small products in shared memory, each thread a 2 x 2 tile
// of outputs, and writes one partial gradient per block (the packed order
// of the parameters). The Adam kernel, one thread a parameter, adds the
// blocks' partials in block order (float64), then applies the moment and
// bias-corrected update in float32 (b1 0.9, b2 0.999, eps 1e-8, t = step +
// 1). No float atomics: a fit gives the same bits run to run.
//
// Bound on an H100: operations, about 6 n (S H_1 + H_1 H_2 + ... + H_L C')
// a step (forward, the weight gradients, the backward); FP32 FMA, no
// tensor cores. The design is the simple one: a block's products read
// shared memory for every multiply-add (2 loads for 4 FMAs), and the
// partial gradients (blocks x P floats) cross device memory twice a step.
#include "fit_common.cuh"

namespace {

using fit::decide;
using fit::Decision;
using fit::kThreads;

constexpr int kTileRows = 32;  // rows a block of the step kernel takes
constexpr int kMaxDepth = 4;   // layers: at most three hidden ones
constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);

struct Net {
  int depth;                  // layers (hidden + 1)
  int width[kMaxDepth + 1];   // S, H_1, ..., C'
};

__host__ __device__ __forceinline__ int odd(int n) { return n | 1; }

// the step kernel's shared memory: each layer's w (fan_in rows of odd
// length) and b, then the activations of every width (kTileRows rows of
// odd length): x's standardized rows, each hidden layer, the head's
// gradient
__host__ __device__ __forceinline__ size_t step_smem_floats(const Net& net) {
  size_t n = 0;
  for (int l = 0; l < net.depth; ++l)
    n += (size_t)net.width[l] * odd(net.width[l + 1]) + net.width[l + 1];
  for (int l = 0; l <= net.depth; ++l)
    n += (size_t)kTileRows * odd(net.width[l]);
  return n;
}

// C(i, j) = sum_k A(i, k) B(k, j) over shared memory, A(i, k) = A[i a_i +
// k a_k], B(k, j) = B[k b_k + j b_j]; a 16 x 16 grid of threads, each a 2 x
// 2 tile (rows i, i + 16; columns j, j + 16) of every 32 x 32 tile; the
// k-sum in order, then ep(i, j, sum)
template <class Ep>
__device__ __forceinline__ void block_gemm(int M, int N, int K,
                                           const float* A, int a_i, int a_k,
                                           const float* B, int b_k, int b_j,
                                           Ep ep) {
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  const int tiles_n = (N + 31) >> 5;
  const int tiles = ((M + 31) >> 5) * tiles_n;
  for (int st = 0; st < tiles; ++st) {
    const int i0 = (st / tiles_n) * 32 + ti, j0 = (st % tiles_n) * 32 + tj;
    const bool iin[2] = {i0 < M, i0 + 16 < M};
    const bool jin[2] = {j0 < N, j0 + 16 < N};
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int k = 0; k < K; ++k) {
      float a[2], b[2];
#pragma unroll
      for (int v = 0; v < 2; ++v)
        a[v] = iin[v] ? A[(i0 + 16 * v) * a_i + k * a_k] : 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        b[u] = jin[u] ? B[k * b_k + (j0 + 16 * u) * b_j] : 0.f;
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          acc[v][u] = __fmaf_rn(a[v], b[u], acc[v][u]);
    }
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (iin[v] && jin[u]) ep(i0 + 16 * v, j0 + 16 * u, acc[v][u]);
  }
}

// 1. the warm start and zero moments; without standardization the carried
// mu, sd, ymu, ysd to the outputs
__global__ void __launch_bounds__(kThreads)
mlp_init_kernel(int P, int S, int C, int standardize,
                const float* __restrict__ old, float* __restrict__ params,
                float* __restrict__ mom, const float* __restrict__ old_mu,
                const float* __restrict__ old_sd,
                const float* __restrict__ old_ymu,
                const float* __restrict__ old_ysd, float* __restrict__ mu,
                float* __restrict__ sd, float* __restrict__ ymu,
                float* __restrict__ ysd) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < P) {
    params[e] = old[e];
    mom[e] = 0.f;
    mom[P + e] = 0.f;
  }
  if (!standardize) {
    if (e < S) {
      mu[e] = old_mu[e];
      sd[e] = old_sd[e];
    }
    if (e < C) {
      ymu[e] = old_ymu[e];
      ysd[e] = old_ysd[e];
    }
  }
}

// 3. the weights' divisor and the loss's scale (one block)
__global__ void __launch_bounds__(kThreads)
mlp_wsum_kernel(const float* __restrict__ w, int n_cap, int C,
                const int* __restrict__ counters, int need,
                float* __restrict__ wfin) {
  const Decision dec = decide(counters, n_cap, need);
  if (!dec.fit) return;
  __shared__ double red[kThreads];
  double s = 0.0;
  for (int r = threadIdx.x; r < dec.n_keep; r += blockDim.x)
    s += (double)fmaxf(w[r], 0.f);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const double n = fmax((double)dec.n_keep, 1.0);
    wfin[0] = (float)fmax(red[0] / n, 1e-30);
    wfin[1] = (float)(2.0 / (n * C));
  }
}

// 4a. one block's partial gradient over its tile of kept rows
__global__ void __launch_bounds__(kThreads)
mlp_step_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ w, int n_cap,
                const int* __restrict__ counters, int need, Net net, int P,
                const float* __restrict__ params,
                const float* __restrict__ mu, const float* __restrict__ sd,
                const float* __restrict__ ymu,
                const float* __restrict__ ysd,
                const float* __restrict__ wfin, float* __restrict__ part) {
  extern __shared__ float sm[];
  const Decision dec = decide(counters, n_cap, need);
  if (!dec.fit) return;
  const int r0 = blockIdx.x * kTileRows;
  if (r0 >= dec.n_keep) return;
  const int rows = min(kTileRows, dec.n_keep - r0);
  const int L = net.depth, S = net.width[0], C = net.width[L];
  // where each layer sits: packed (global) and padded (shared)
  int gw[kMaxDepth], sw[kMaxDepth], sb[kMaxDepth];
  float* act[kMaxDepth + 1];
  int ld[kMaxDepth + 1];
  {
    int g = 0, o = 0;
    for (int l = 0; l < L; ++l) {
      const int fi = net.width[l], fo = net.width[l + 1];
      gw[l] = g;
      g += fi * fo + fo;
      sw[l] = o;
      o += fi * odd(fo);
      sb[l] = o;
      o += fo;
    }
    for (int l = 0; l <= L; ++l) {
      ld[l] = odd(net.width[l]);
      act[l] = sm + o;
      o += kTileRows * ld[l];
    }
  }
  for (int l = 0; l < L; ++l) {
    const int fi = net.width[l], fo = net.width[l + 1];
    for (int e = threadIdx.x; e < fi * fo; e += blockDim.x)
      sm[sw[l] + (e / fo) * odd(fo) + e % fo] = params[gw[l] + e];
    for (int e = threadIdx.x; e < fo; e += blockDim.x)
      sm[sb[l] + e] = params[gw[l] + fi * fo + e];
  }
  for (int e = threadIdx.x; e < rows * S; e += blockDim.x) {
    const int r = e / S, k = e % S;
    act[0][r * ld[0] + k] =
        __fdiv_rn(__fsub_rn(x[(size_t)(r0 + r) * S + k], mu[k]), sd[k]);
  }
  __syncthreads();
  // the forward: tanh(h @ w + b) through the hidden layers
  for (int l = 0; l + 1 < L; ++l) {
    float* out = act[l + 1];
    const float* b = sm + sb[l];
    const int ldo = ld[l + 1];
    block_gemm(rows, net.width[l + 1], net.width[l], act[l], ld[l], 1,
               sm + sw[l], odd(net.width[l + 1]), 1,
               [&](int i, int j, float acc) {
                 out[i * ldo + j] = tanhf(__fadd_rn(acc, b[j]));
               });
    __syncthreads();
  }
  // the head and the loss gradient: (wts 2 / (n C')) (pred - ys)
  {
    const float* b = sm + sb[L - 1];
    float* g = act[L];
    const int ldg = ld[L];
    const float denom = wfin[0], coef = wfin[1];
    block_gemm(rows, C, net.width[L - 1], act[L - 1], ld[L - 1], 1,
               sm + sw[L - 1], odd(C), 1, [&](int i, int j, float acc) {
                 const int r = r0 + i;
                 const float pred = __fadd_rn(acc, b[j]);
                 const float ys = __fdiv_rn(
                     __fsub_rn(y[(size_t)r * C + j], ymu[j]), ysd[j]);
                 const float wts = __fdiv_rn(fmaxf(w[r], 0.f), denom);
                 g[i * ldg + j] =
                     __fmul_rn(__fmul_rn(wts, coef), __fsub_rn(pred, ys));
               });
    __syncthreads();
  }
  // the backward: layer l's gradient from g_z in act[l + 1] and its input
  // in act[l]; then g_z of layer l - 1 in place over act[l]
  float* out = part + (size_t)blockIdx.x * P;
  for (int l = L - 1; l >= 0; --l) {
    const int fi = net.width[l], fo = net.width[l + 1];
    const float* gz = act[l + 1];
    const int ldg = ld[l + 1];
    float* dw = out + gw[l];
    block_gemm(fi, fo, rows, act[l], 1, ld[l], gz, ldg, 1,
               [&](int i, int j, float acc) { dw[i * fo + j] = acc; });
    for (int j = threadIdx.x; j < fo; j += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s = __fadd_rn(s, gz[r * ldg + j]);
      out[gw[l] + fi * fo + j] = s;
    }
    __syncthreads();
    if (l == 0) break;
    float* h = act[l];
    const int ldh = ld[l];
    block_gemm(rows, fi, fo, gz, ldg, 1, sm + sw[l], 1, odd(fo),
               [&](int i, int j, float acc) {
                 const float hv = h[i * ldh + j];
                 h[i * ldh + j] =
                     __fmul_rn(acc, __fsub_rn(1.f, __fmul_rn(hv, hv)));
               });
    __syncthreads();
  }
}

// 4b. the blocks' partials added in order, then Adam's update; grad
// (nullable) gets the gradient
__global__ void __launch_bounds__(kThreads)
mlp_adam_kernel(int n_cap, const int* __restrict__ counters, int need, int P,
                const float* __restrict__ part, float* __restrict__ params,
                float* __restrict__ mom, int t, float lr,
                float* __restrict__ grad) {
  const Decision dec = decide(counters, n_cap, need);
  if (!dec.fit) return;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P) return;
  const int blocks = (dec.n_keep + kTileRows - 1) / kTileRows;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += (double)part[(size_t)b * P + e];
  const float g = (float)s;
  if (grad != nullptr) grad[e] = g;
  const float m = __fadd_rn(__fmul_rn(kB1, mom[e]), __fmul_rn(kOneMinusB1, g));
  const float v = __fadd_rn(__fmul_rn(kB2, mom[P + e]),
                            __fmul_rn(__fmul_rn(kOneMinusB2, g), g));
  mom[e] = m;
  mom[P + e] = v;
  const float tt = (float)t;
  const float corr1 = __fsub_rn(1.f, powf(kB1, tt));
  const float corr2 = __fsub_rn(1.f, powf(kB2, tt));
  const float step =
      __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m, corr1)),
                __fadd_rn(__fsqrt_rn(__fdiv_rn(v, corr2)), kEps));
  params[e] = __fsub_rn(params[e], step);
}

// 5. keep_if_finite and the decision's outcome (one block)
__global__ void __launch_bounds__(1024)
mlp_guard_kernel(int n_cap, const int* __restrict__ counters, int need,
                 int P, int S, int C, const float* __restrict__ old,
                 const float* __restrict__ old_mu,
                 const float* __restrict__ old_sd,
                 const float* __restrict__ old_ymu,
                 const float* __restrict__ old_ysd,
                 float* __restrict__ params, float* __restrict__ mu,
                 float* __restrict__ sd, float* __restrict__ ymu,
                 float* __restrict__ ysd, int* __restrict__ flags) {
  const Decision dec = decide(counters, n_cap, need);
  int bad = 0;
  if (dec.fit) {
    for (int e = threadIdx.x; e < P; e += blockDim.x)
      bad |= !isfinite(params[e]);
    for (int e = threadIdx.x; e < S; e += blockDim.x)
      bad |= !isfinite(mu[e]) | !isfinite(sd[e]);
    for (int e = threadIdx.x; e < C; e += blockDim.x)
      bad |= !isfinite(ymu[e]) | !isfinite(ysd[e]);
  }
  const bool ok = !__syncthreads_or(bad);
  const bool take = dec.fit && ok;
  if (!take) {
    for (int e = threadIdx.x; e < P; e += blockDim.x) params[e] = old[e];
    for (int e = threadIdx.x; e < S; e += blockDim.x) {
      mu[e] = old_mu[e];
      sd[e] = old_sd[e];
    }
    for (int e = threadIdx.x; e < C; e += blockDim.x) {
      ymu[e] = old_ymu[e];
      ysd[e] = old_ysd[e];
    }
  }
  if (threadIdx.x == 0) {
    flags[0] = ok ? 1 : 0;
    flags[1] = dec.fit ? 1 : 0;
  }
}

}  // namespace

// x (n_cap, S) raw statistics (or rows already standardized, with
// standardize 0 and the carried mu 0, sd 1), y (n_cap, C) the targets, w
// (n_cap,) the weights (rows past n_keep never read); widths a HOST array
// of depth + 1 ints (S, H_1, ..., C); counters the round counters (n_acc
// at 0, n_target at 4); old the carried parameters packed (P floats:
// each layer's w row-major, then its b) with old_mu, old_sd (S), old_ymu,
// old_ysd (C); params, mu, sd, ymu, ysd the outputs; flags (2,) int32.
// Scratch: part ceil(n_cap / 32) P floats, cols ceil(n_cap / 256)
// max(S, C) doubles, mom 2 P floats, wfin 2 floats
// (kernels/mlp_fit.py sizes them). grad (nullable, P floats) gets the
// last step's gradient (the wrapper's gradient entry: one step at lr 0).
extern "C" int pyabc_mlp_fit(
    const float* x, const float* y, const float* w, int n_cap,
    const int* widths, int depth, const int* counters, int need, float lr,
    int n_steps, int standardize, const float* old, const float* old_mu,
    const float* old_sd, const float* old_ymu, const float* old_ysd,
    float* params, float* mu, float* sd, float* ymu, float* ysd, int* flags,
    float* part, double* cols, float* mom, float* wfin, float* grad,
    void* stream_ptr) {
  if (n_cap <= 0 || depth < 1 || depth > kMaxDepth || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  net.depth = depth;
  int P = 0;
  for (int l = 0; l <= depth; ++l) {
    net.width[l] = widths[l];
    if (widths[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < depth; ++l)
    P += net.width[l] * net.width[l + 1] + net.width[l + 1];
  const int S = net.width[0], C = net.width[depth];
  const size_t smem = sizeof(float) * step_smem_floats(net);
  static int smem_cached = -1;
  const int smem_max = fit::raise_smem(mlp_step_kernel, &smem_cached);
  if (smem_max < 0) return -smem_max;
  if ((long long)smem > smem_max)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int wide = P > S ? P : S;
  mlp_init_kernel<<<(wide + kThreads - 1) / kThreads, kThreads, 0,
                    stream>>>(P, S, C, standardize, old, params, mom, old_mu,
                              old_sd, old_ymu, old_ysd, mu, sd, ymu, ysd);
  if (standardize) {
    fit::standardize(x, n_cap, S, counters, need, mu, sd, cols, stream);
    fit::standardize(y, n_cap, C, counters, need, ymu, ysd, cols, stream);
  }
  mlp_wsum_kernel<<<1, kThreads, 0, stream>>>(w, n_cap, C, counters, need,
                                              wfin);
  const int tiles = (n_cap + kTileRows - 1) / kTileRows;
  const int pgrid = (P + kThreads - 1) / kThreads;
  for (int i = 0; i < n_steps; ++i) {
    mlp_step_kernel<<<tiles, kThreads, smem, stream>>>(
        x, y, w, n_cap, counters, need, net, P, params, mu, sd, ymu, ysd,
        wfin, part);
    mlp_adam_kernel<<<pgrid, kThreads, 0, stream>>>(
        n_cap, counters, need, P, part, params, mom, i + 1, lr,
        i + 1 == n_steps ? grad : nullptr);
  }
  mlp_guard_kernel<<<1, 1024, 0, stream>>>(n_cap, counters, need, P, S, C,
                                           old, old_mu, old_sd, old_ymu,
                                           old_ysd, params, mu, sd, ymu, ysd,
                                           flags);
  return static_cast<int>(cudaGetLastError());
}
