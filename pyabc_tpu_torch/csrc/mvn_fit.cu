// K8 mvn_fit: the MultivariateNormalTransition refit of a generation step.
//
// Replaces: pyabc_tpu/transition/multivariatenormal.py::device_fit with
// pyabc_tpu/transition/util.py::device_chol_guarded (the jitter ladder).
//
// On n rows thetas (n, d) (d = d_max, the first `dim` real) and weights (n,):
//   w = weights / max(sum, 1e-38); mean = w @ thetas;
//   cov[k][l] = sum_i (c_ik w_i) c_il with c = thetas - mean;
//   smart_cov fill: a diagonal entry <= 0 becomes |mean_k| 1e-4 + 1e-8;
//   ess = 1 / max(sum w^2, 1e-38); factor = Scott ess^(-1/(dim+4)) or
//   Silverman (4/(dim+2))^(1/(dim+4)) ess^(-1/(dim+4)); cov *= (s f)^2;
//   Cholesky with the jitter ladder: rung 0 is cov itself, then
//   cov + (j tr) I for j = 1e-10, 1e-7, 1e-4 (tr = max(trace / d, 1e-30)):
//   the first rung whose factor exists (every pivot > 0) and is finite.
//   a factor that fails is NaN on and below the diagonal (jnp semantics);
//   prec = L^-T L^-1 from the factor, in the plain version too: a
//   covariance that only the ladder's last rung factorizes is singular in
//   float32, where an LU inverse can come back infinite (with no factor
//   the precision is NaN);
//   logdet = 2 sum_{k < dim} log max(L_kk, 1e-38); chol and prec masked to
//   the real dims; the epilogue writes thetas * vmask, the centred rows,
//   quad_i = c_i' P c_i and the ancestor CDF that K2 searches:
//   cdf = cummax(where(w > 0, cumsum(w), 0)).
//
// K > 1 mode (a run over several models, util.py:1908-1948): one launch
// with a grid of K blocks, block k fitting model k on the shared d_max-
// padded reservoir with w_k = where(m == k, weights, 0) and model k's dim,
// scaling and bandwidth rule, into slice k of stacked outputs (thetas
// (K, n, d), chol (K, d, d), logdet (K,), ...). A model with no weight
// stays finite: w = 0 / 1e-38, the smart_cov fill and an ESS of 1e38 give
// a tiny positive covariance (its params are masked out by `fitted`). With
// m null the launch is the single-model one (one block, model slot 0).
//
// Bound on an H100: bytes (n (d + 1) floats in, 2 n d + 3 n out, a few KB
// at the main-path size), so at n_cap = 1024 the kernel is latency bound.
// Design: one block (1024 threads; 256 for d > 4, whose accumulators need
// the registers). The weighted moments are block reductions (the
// covariance splits its d^2 entries and the rows across the threads),
// thread 0 runs the d x d ladder Cholesky (chol.cuh, shared with K13) and
// the inverse in shared memory (d <= 32, a few thousand flops at most);
// steps 1-4 live in mvn_fit.cuh, shared with K16's bootstrap fit. All
// threads write the rows; the
// cdf is a chunked scan (each thread a contiguous run of rows, a block
// scan of the run totals), then the same for the running max.
#include "chol.cuh"
#include "common.cuh"
#include "mvn_fit.cuh"

namespace {

using pyabc::FitShared;
using pyabc::FitThreads;
constexpr int kMaxModels = 8;

// per-model fit statics, passed by value: block k reads slot k
struct FitModels {
  int dim[kMaxModels];
  float scaling[kMaxModels];
  int selector[kMaxModels];
  float sel_const[kMaxModels];
  float sel_exp[kMaxModels];
};

using pyabc::chol_guarded;

__device__ __forceinline__ float warp_scan_sum(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

__device__ __forceinline__ float warp_scan_max(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = fmaxf(v, up);
  }
  return v;
}

// Exclusive block scan (sum or max) of one value per thread.
__device__ float block_exclusive_scan(float v, bool is_max, float* s_warp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const float incl = is_max ? warp_scan_max(v) : warp_scan_sum(v);
  __syncthreads();
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float t = lane < nw ? s_warp[lane] : 0.f;
    const float ti = is_max ? warp_scan_max(t) : warp_scan_sum(t);
    s_warp[lane] = ti;
  }
  __syncthreads();
  const float ident = is_max ? 0.f : 0.f;  // cdf values are >= 0
  const float before_warp = warp > 0 ? s_warp[warp - 1] : ident;
  const float excl_in_warp = __shfl_up_sync(0xffffffffu, incl, 1);
  const float in_warp = lane > 0 ? excl_in_warp : ident;
  return is_max ? fmaxf(before_warp, in_warp) : before_warp + in_warp;
}

// K8's row source: the reservoir rows, model `model`'s weights only when
// m is given; the normalized weights go to w_out and are read back from it
struct ReservoirRows {
  const float* thetas;
  const float* weights;
  const int* m;
  int model, d;
  float* w_out;
  __device__ __forceinline__ float raw_weight(int i) const {
    return (m == nullptr || m[i] == model) ? weights[i] : 0.f;
  }
  __device__ __forceinline__ float theta(int i, int k) const {
    return thetas[(size_t)i * d + k];
  }
  __device__ __forceinline__ void put_w(int i, float w) const {
    w_out[i] = w;
  }
  __device__ __forceinline__ float w(int i, float) const { return w_out[i]; }
};

template <int D>
__global__ void __launch_bounds__(FitThreads<D>::value)
mvn_fit_kernel(const float* __restrict__ thetas,
               const float* __restrict__ weights,
               const int* __restrict__ m, int n, int d, FitModels fm,
               float* __restrict__ th_out, float* __restrict__ w_out,
               float* __restrict__ chol_out, float* __restrict__ prec_out,
               float* __restrict__ center_out, float* __restrict__ thc_out,
               float* __restrict__ quad_out, float* __restrict__ logdet_out,
               float* __restrict__ cdf_out) {
  constexpr int kThreads = FitThreads<D>::value;
  // model slot of this block: its statics and its slice of every output
  const int model = blockIdx.x;
  th_out += (size_t)model * n * d;
  w_out += (size_t)model * n;
  chol_out += (size_t)model * d * d;
  prec_out += (size_t)model * d * d;
  center_out += (size_t)model * d;
  thc_out += (size_t)model * n * d;
  quad_out += (size_t)model * n;
  logdet_out += model;
  cdf_out += (size_t)model * n;
  __shared__ FitShared<D, kThreads> sh;
  const int tid = threadIdx.x;

  // 1-4. weights, moments, bandwidth, ladder, precision, logdet
  const ReservoirRows rows{thetas, weights, m, model, d, w_out};
  pyabc::fit_params<D, kThreads>(rows, n, d, fm.dim[model],
                                 fm.scaling[model], fm.selector[model],
                                 fm.sel_const[model], fm.sel_exp[model], sh);
  if (tid == 0) {
    logdet_out[0] = sh.logdet;
    for (int i = 0; i < d; ++i)
      for (int j = 0; j < d; ++j) {
        prec_out[i * d + j] = sh.prec[i * D + j];
        chol_out[i * d + j] = sh.L[i * D + j] * (sh.vmask[i] * sh.vmask[j]);
      }
    for (int k = 0; k < d; ++k) center_out[k] = sh.mean[k] * sh.vmask[k];
  }
  const float* s_mean = sh.mean;
  const float* s_vmask = sh.vmask;
  float* s_warp = sh.warp;

  // 5. rows: thetas * vmask, centred rows, quad
  for (int i = tid; i < n; i += kThreads) {
    float c[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k >= d) break;
      const float th = thetas[(size_t)i * d + k] * s_vmask[k];
      th_out[(size_t)i * d + k] = th;
      c[k] = th - s_mean[k] * s_vmask[k];
      thc_out[(size_t)i * d + k] = c[k];
    }
    quad_out[i] = pyabc::fit_quad<D>(c, sh.prec, d);
  }

  // 6. cdf: each thread a contiguous run of rows, sums then running max
  const int chunk = (n + kThreads - 1) / kThreads;
  const int a = min(n, tid * chunk), b = min(n, a + chunk);
  float run_sum = 0.f;
  for (int i = a; i < b; ++i) run_sum += w_out[i];
  float run = block_exclusive_scan(run_sum, false, s_warp);
  float local_max = 0.f;
  for (int i = a; i < b; ++i) {
    const float w = w_out[i];
    run += w;
    const float v = w > 0.f ? run : 0.f;
    local_max = fmaxf(local_max, v);
    cdf_out[i] = v;
  }
  float cur = block_exclusive_scan(local_max, true, s_warp);
  for (int i = a; i < b; ++i) {
    cur = fmaxf(cur, cdf_out[i]);
    cdf_out[i] = cur;
  }
}

template <int D>
void launch(const float* thetas, const float* weights, const int* m,
            int n_models, int n, int d, const FitModels& fm, float* th,
            float* w, float* chol, float* prec, float* center, float* thc,
            float* quad, float* logdet, float* cdf, cudaStream_t stream) {
  mvn_fit_kernel<D><<<n_models, FitThreads<D>::value, 0, stream>>>(
      thetas, weights, m, n, d, fm, th, w, chol, prec, center, thc, quad,
      logdet, cdf);
}

int launch_fit(const float* thetas, const float* weights, const int* m,
               int n_models, int n, int d, const FitModels& fm, float* th,
               float* w, float* chol, float* prec, float* center, float* thc,
               float* quad, float* logdet, float* cdf, cudaStream_t stream) {
#define PYABC_FIT(DB)                                                        \
  launch<DB>(thetas, weights, m, n_models, n, d, fm, th, w, chol, prec,     \
             center, thc, quad, logdet, cdf, stream)
  if (d <= 1)
    PYABC_FIT(1);
  else if (d <= 2)
    PYABC_FIT(2);
  else if (d <= 4)
    PYABC_FIT(4);
  else if (d <= 8)
    PYABC_FIT(8);
  else if (d <= 16)
    PYABC_FIT(16);
  else if (d <= 32)
    PYABC_FIT(32);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef PYABC_FIT
  return static_cast<int>(cudaGetLastError());
}

__global__ void chol_guarded_kernel(const float* cov, int d, float* chol,
                                    float* cov_used, int* rung) {
  __shared__ float A[32 * 32], L[32 * 32];
  for (int i = 0; i < d * d; ++i) A[i] = cov[i];
  rung[0] = chol_guarded(A, L, d, d);
  for (int i = 0; i < d * d; ++i) {
    chol[i] = L[i];
    cov_used[i] = A[i];
  }
}

}  // namespace

extern "C" int pyabc_mvn_fit(const float* thetas, const float* weights, int n,
                             int d, int dim, float scaling, int selector,
                             float sel_const, float sel_exp, float* th,
                             float* w, float* chol, float* prec,
                             float* center, float* thc, float* quad,
                             float* logdet, float* cdf, void* stream_ptr) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  FitModels fm{};
  fm.dim[0] = dim;
  fm.scaling[0] = scaling;
  fm.selector[0] = selector;
  fm.sel_const[0] = sel_const;
  fm.sel_exp[0] = sel_exp;
  return launch_fit(thetas, weights, nullptr, 1, n, d, fm, th, w, chol, prec,
                    center, thc, quad, logdet, cdf,
                    static_cast<cudaStream_t>(stream_ptr));
}

// K > 1 mode: m (n,) int32 model of each reservoir row; dims, scaling,
// selector, sel_const and sel_exp are host arrays of n_models entries;
// every output is stacked over the models.
extern "C" int pyabc_mvn_fit_models(
    const float* thetas, const float* weights, const int* m, int n_models,
    int n, int d, const int* dims, const float* scaling, const int* selector,
    const float* sel_const, const float* sel_exp, float* th, float* w,
    float* chol, float* prec, float* center, float* thc, float* quad,
    float* logdet, float* cdf, void* stream_ptr) {
  if (n <= 0 || m == nullptr || n_models < 1 || n_models > kMaxModels)
    return static_cast<int>(cudaErrorInvalidValue);
  FitModels fm{};
  for (int k = 0; k < n_models; ++k) {
    fm.dim[k] = dims[k];
    fm.scaling[k] = scaling[k];
    fm.selector[k] = selector[k];
    fm.sel_const[k] = sel_const[k];
    fm.sel_exp[k] = sel_exp[k];
  }
  return launch_fit(thetas, weights, m, n_models, n, d, fm, th, w, chol,
                    prec, center, thc, quad, logdet, cdf,
                    static_cast<cudaStream_t>(stream_ptr));
}

// Card check of the ladder alone, on a given d x d matrix.
extern "C" int pyabc_chol_guarded(const float* cov, int d, float* chol,
                                  float* cov_used, int* rung,
                                  void* stream_ptr) {
  if (d <= 0 || d > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  chol_guarded_kernel<<<1, 1, 0, stream>>>(cov, d, chol, cov_used, rung);
  return static_cast<int>(cudaGetLastError());
}
