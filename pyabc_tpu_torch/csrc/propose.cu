// K2 propose (with K1, philox.cuh): the proposal of one round.
//
// Replaces: pyabc_tpu/inference/util.py::_switch_propose_sim (the fixed
// unroll of N_REDRAWS draws against zero prior mass), _lane_transition and
// _lane_prior, transition/multivariatenormal.py::device_rvs and
// core/random_variables.py::Distribution.rvs_array / logpdf_array, with the
// threefry key tree replaced by in-kernel Philox4x32-10.
//
// One thread per lane, two modes (the plain twin is kernels/propose.py):
//   transition (cdf != nullptr): for redraw j = 0..n_redraws-1 at blocks
//     base = j (1 + nb), nb = ceil(d / 4): u from word 0 of block base,
//     x = min(u * cdf[n-1], nextafter(cdf[n-1], 0)), the ancestor is the
//     first row with cdf > x (upper bound; zero-weight rows repeat the
//     previous cdf and are never picked; all-zero weights or NaN give the
//     last row, as torch.searchsorted + clamp does), then
//     theta = thetas[idx] + chol z with z the normals from block base + 1
//     (local mode, chol_per_row: LocalTransition's per-row factor
//     chol[idx], local_transition.py::device_rvs);
//     the first draw whose prior log-density is finite is kept, else the
//     last one;
//   prior (cdf == nullptr): theta_k = loc + scale z_k (norm, normal k from
//     block 0) or loc + scale u_k (uniform, word k % 4 of block nb + k / 4);
//     every lane is valid.
// The prior log-density sums, dim by dim in order, the norm density
// -0.5 (z^2 + log 2 pi) - log scale or the uniform's -log scale on
// [loc, hi] (else -inf). The round index is read from counters[1] on the
// device; the generation and stream tag are arguments.
//
// Bound on an H100: operations, and tiny ones. Per lane and redraw one
// binary search over n (log2 n dependent loads), (1 + nb) Philox blocks of
// 10 rounds each and d^2 multiply-adds; the inputs are n (d + 1) floats
// read by every lane from L2. At B = 4096 lanes the kernel is latency
// bound: each thread's Philox rounds and search steps are a dependent
// chain, and B / 128 blocks fill the card once.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 128;

struct Prior {
  const int* kind;
  const float* loc;
  const float* scale;
  const float* hi;
  const float* log_scale;
};

__device__ __forceinline__ float prior_logpdf_dim(const Prior& p, int k,
                                                  float x) {
  const float ls = p.log_scale[k];
  if (p.kind[k] == 0) {
    const float z = (x - p.loc[k]) / p.scale[k];
    return -0.5f * (z * z + PYABC_LOG_2PI) - ls;
  }
  return (x >= p.loc[k] && x <= p.hi[k]) ? -ls : -INFINITY;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
propose_kernel(int B, int d, int n, const float* __restrict__ cdf,
               const float* __restrict__ thetas,
               const float* __restrict__ chol, int chol_per_row, Prior pr,
               uint32_t k0, uint32_t k1, uint32_t gen, uint32_t tag,
               uint32_t max_rounds, const int* __restrict__ counters,
               int n_redraws, float* __restrict__ theta_out,
               float* __restrict__ logpri_out,
               uint8_t* __restrict__ valid_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const pyabc::PhiloxLane rng = pyabc::philox_lane(
      k0, k1, (uint32_t)b, gen, tag, max_rounds, (uint32_t)counters[1]);
  const int nb = (d + 3) >> 2;
  float th[D];
  float lp = 0.f;
  bool valid = true;

  if (cdf == nullptr) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k >= d) break;
      const float r = pr.kind[k] == 0
                          ? rng.normal(0, k)
                          : rng.uniform((uint32_t)(nb + (k >> 2)), k & 3);
      th[k] = pr.loc[k] + pr.scale[k] * r;
      const float part = prior_logpdf_dim(pr, k, th[k]);
      lp = (k == 0) ? part : lp + part;
    }
  } else {
    const float total = cdf[n - 1];
    const float below = nextafterf(total, 0.f);
    for (int j = 0; j < n_redraws; ++j) {
      const uint32_t base = (uint32_t)(j * (1 + nb));
      float x = rng.uniform(base, 0) * total;
      if (!isnan(x) && !(x <= below)) x = below;  // torch.minimum
      int idx = n - 1;
      if (!isnan(x)) {
        int lo = 0, hi = n;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cdf[mid] <= x)
            lo = mid + 1;
          else
            hi = mid;
        }
        idx = min(lo, n - 1);
      }
      float z[D];
#pragma unroll
      for (int k = 0; k < D; ++k) z[k] = (k < d) ? rng.normal(base + 1, k) : 0.f;
      const float* anc = thetas + (size_t)idx * d;
      const float* L = chol_per_row ? chol + (size_t)idx * d * d : chol;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (k >= d) break;
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < D; ++m)
          if (m < d) acc += L[k * d + m] * z[m];
        th[k] = anc[k] + acc;
        const float part = prior_logpdf_dim(pr, k, th[k]);
        lp = (k == 0) ? part : lp + part;
      }
      if (isfinite(lp)) break;
    }
    valid = isfinite(lp);
  }
#pragma unroll
  for (int k = 0; k < D; ++k)
    if (k < d) theta_out[(size_t)b * d + k] = th[k];
  logpri_out[b] = lp;
  valid_out[b] = valid ? 1 : 0;
}

template <int D>
void launch(int B, int d, int n, const float* cdf, const float* thetas,
            const float* chol, int chol_per_row, Prior pr, uint32_t k0,
            uint32_t k1,
            uint32_t gen, uint32_t tag, uint32_t max_rounds,
            const int* counters, int n_redraws, float* theta, float* logpri,
            uint8_t* valid, cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  propose_kernel<D><<<grid, kThreads, 0, stream>>>(
      B, d, n, cdf, thetas, chol, chol_per_row, pr, k0, k1, gen, tag,
      max_rounds, counters, n_redraws, theta, logpri, valid);
}

// Inverse-CDF categorical draw over K probabilities p[0..K) (p_k = f(k)):
// the first k whose running sum exceeds u * total (capped just below the
// total), so a model of probability 0 is never drawn; an all-zero row
// draws uniformly, as jax.random.categorical does on log(0 + 1e-38).
template <typename P>
__device__ __forceinline__ int categorical(int K, float u, P p) {
  float total = 0.f;
  for (int k = 0; k < K; ++k) total += p(k);
  if (!(total > 0.f)) return min((int)(u * (float)K), K - 1);
  float x = u * total;
  const float below = nextafterf(total, 0.f);
  if (!(x <= below)) x = below;
  float cum = 0.f;
  for (int k = 0; k < K; ++k) {
    cum += p(k);
    if (cum > x) return k;
  }
  return K - 1;
}

// K > 1 mode (a run over several models; the plain twin is
// kernels/propose.py::propose_models_plain). Priors are (K, d) arrays with
// model m's dims[m] real entries first; theta rows are d = d_max wide and
// their padded entries are exactly 0. The model draws come from the MODEL
// stream (model_tag) at block 0: word 0 picks the prior model (prior mode)
// or the ancestor model from exp(log_model_probs) (transition mode), word
// 1 the perturbed model from row m_anc of the masked matrix mpk. The theta
// draws then follow the single-model layout on the lane's own stream with
// nb = ceil(d_max / 4), from model m's prior or from model m's fit
// (cdf (K, n), thetas (K, n, d), chol (K, d, d)).
template <int D>
__global__ void __launch_bounds__(kThreads)
propose_models_kernel(int B, int K, int d, int n,
                      const float* __restrict__ cdf,
                      const float* __restrict__ thetas,
                      const float* __restrict__ chol, Prior pr,
                      const int* __restrict__ dims,
                      const float* __restrict__ model_p,
                      const float* __restrict__ mpk, uint32_t k0, uint32_t k1,
                      uint32_t gen, uint32_t tag, uint32_t model_tag,
                      uint32_t max_rounds, const int* __restrict__ counters,
                      int n_redraws, float* __restrict__ theta_out,
                      float* __restrict__ logpri_out,
                      uint8_t* __restrict__ valid_out,
                      int* __restrict__ m_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint32_t round = (uint32_t)counters[1];
  const pyabc::PhiloxLane rng =
      pyabc::philox_lane(k0, k1, (uint32_t)b, gen, tag, max_rounds, round);
  const pyabc::Words4 mw =
      pyabc::philox_lane(k0, k1, (uint32_t)b, gen, model_tag, max_rounds,
                         round)
          .block(0);
  const int nb = (d + 3) >> 2;
  int m;
  if (cdf == nullptr) {
    m = categorical(K, pyabc::uniform_of(mw.x),
                    [&](int k) { return model_p[k]; });
  } else {
    const int anc = categorical(K, pyabc::uniform_of(mw.x),
                                [&](int k) { return expf(model_p[k]); });
    const float* row = mpk + (size_t)anc * K;
    m = categorical(K, pyabc::uniform_of(mw.y),
                    [&](int k) { return row[k]; });
  }
  const int dim = dims[m];
  const Prior pm{pr.kind + (size_t)m * d, pr.loc + (size_t)m * d,
                 pr.scale + (size_t)m * d, pr.hi + (size_t)m * d,
                 pr.log_scale + (size_t)m * d};
  float th[D];
#pragma unroll
  for (int k = 0; k < D; ++k) th[k] = 0.f;
  float lp = 0.f;
  bool valid = true;

  if (cdf == nullptr) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k >= dim) break;
      const float r = pm.kind[k] == 0
                          ? rng.normal(0, k)
                          : rng.uniform((uint32_t)(nb + (k >> 2)), k & 3);
      th[k] = pm.loc[k] + pm.scale[k] * r;
      const float part = prior_logpdf_dim(pm, k, th[k]);
      lp = (k == 0) ? part : lp + part;
    }
  } else {
    const float* cdf_m = cdf + (size_t)m * n;
    const float* chol_m = chol + (size_t)m * d * d;
    const float total = cdf_m[n - 1];
    const float below = nextafterf(total, 0.f);
    for (int j = 0; j < n_redraws; ++j) {
      const uint32_t base = (uint32_t)(j * (1 + nb));
      float x = rng.uniform(base, 0) * total;
      if (!isnan(x) && !(x <= below)) x = below;  // torch.minimum
      int idx = n - 1;
      if (!isnan(x)) {
        int lo = 0, hi = n;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cdf_m[mid] <= x)
            lo = mid + 1;
          else
            hi = mid;
        }
        idx = min(lo, n - 1);
      }
      float z[D];
#pragma unroll
      for (int k = 0; k < D; ++k)
        z[k] = (k < d) ? rng.normal(base + 1, k) : 0.f;
      const float* anc = thetas + ((size_t)m * n + idx) * d;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (k >= dim) break;
        float acc = 0.f;
#pragma unroll
        for (int l = 0; l < D; ++l)
          if (l < d) acc += chol_m[k * d + l] * z[l];
        th[k] = anc[k] + acc;
        const float part = prior_logpdf_dim(pm, k, th[k]);
        lp = (k == 0) ? part : lp + part;
      }
      if (isfinite(lp)) break;
    }
    valid = isfinite(lp);
  }
#pragma unroll
  for (int k = 0; k < D; ++k)
    if (k < d) theta_out[(size_t)b * d + k] = k < dim ? th[k] : 0.f;
  logpri_out[b] = lp;
  valid_out[b] = valid ? 1 : 0;
  m_out[b] = m;
}

template <int D>
void launch_models(int B, int K, int d, int n, const float* cdf,
                   const float* thetas, const float* chol, Prior pr,
                   const int* dims, const float* model_p, const float* mpk,
                   uint32_t k0, uint32_t k1, uint32_t gen, uint32_t tag,
                   uint32_t model_tag, uint32_t max_rounds,
                   const int* counters, int n_redraws, float* theta,
                   float* logpri, uint8_t* valid, int* m,
                   cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  propose_models_kernel<D><<<grid, kThreads, 0, stream>>>(
      B, K, d, n, cdf, thetas, chol, pr, dims, model_p, mpk, k0, k1, gen, tag,
      model_tag, max_rounds, counters, n_redraws, theta, logpri, valid, m);
}

// Known-answer check of philox.cuh: words, uniforms and the four
// Box-Muller normals of each (N, 4) counter block.
__global__ void philox_blocks_kernel(const uint32_t* __restrict__ ctr, int N,
                                     uint32_t k0, uint32_t k1,
                                     uint32_t* __restrict__ words,
                                     float* __restrict__ uni,
                                     float* __restrict__ nrm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const pyabc::Words4 v = pyabc::philox4x32_10(
      pyabc::Words4{ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2],
                    ctr[4 * i + 3]},
      k0, k1);
  float u[4];
  for (int w = 0; w < 4; ++w) {
    words[4 * i + w] = pyabc::word_of(v, w);
    u[w] = pyabc::uniform_of(pyabc::word_of(v, w));
    uni[4 * i + w] = u[w];
  }
  nrm[4 * i + 0] = pyabc::box_muller(u[0], u[1], false);
  nrm[4 * i + 1] = pyabc::box_muller(u[0], u[1], true);
  nrm[4 * i + 2] = pyabc::box_muller(u[2], u[3], false);
  nrm[4 * i + 3] = pyabc::box_muller(u[2], u[3], true);
}

}  // namespace

// chol_per_row: 0 for the MVN transition's shared (d, d) factor, 1 for
// LocalTransition's (n, d, d) factors (K2's local mode).
extern "C" int pyabc_propose(
    int B, int d, int n, const float* cdf, const float* thetas,
    const float* chol, int chol_per_row, const int* kind, const float* loc,
    const float* scale, const float* hi, const float* log_scale, unsigned k0, unsigned k1,
    unsigned gen, unsigned tag, unsigned max_rounds, const int* counters,
    int n_redraws, float* theta, float* logpri, uint8_t* valid,
    void* stream_ptr) {
  if (B <= 0) return 0;
  if (cdf != nullptr && n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Prior pr{kind, loc, scale, hi, log_scale};
#define PYABC_PROPOSE(DB)                                                    \
  launch<DB>(B, d, n, cdf, thetas, chol, chol_per_row, pr, k0, k1, gen,   \
             tag, max_rounds, counters, n_redraws, theta, logpri, valid,  \
             stream)
  if (d <= 1)
    PYABC_PROPOSE(1);
  else if (d <= 2)
    PYABC_PROPOSE(2);
  else if (d <= 4)
    PYABC_PROPOSE(4);
  else if (d <= 8)
    PYABC_PROPOSE(8);
  else if (d <= 16)
    PYABC_PROPOSE(16);
  else if (d <= 32)
    PYABC_PROPOSE(32);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef PYABC_PROPOSE
  return static_cast<int>(cudaGetLastError());
}

// K > 1 mode: model_p is the model prior (prior mode, cdf null) or the
// log model probabilities (transition mode, with mpk the masked (K, K)
// perturbation matrix); m receives each lane's model index.
extern "C" int pyabc_propose_models(
    int B, int K, int d, int n, const float* cdf, const float* thetas,
    const float* chol, const int* kind, const float* loc, const float* scale,
    const float* hi, const float* log_scale, const int* dims,
    const float* model_p, const float* mpk, unsigned k0, unsigned k1,
    unsigned gen, unsigned tag, unsigned model_tag, unsigned max_rounds,
    const int* counters, int n_redraws, float* theta, float* logpri,
    uint8_t* valid, int* m, void* stream_ptr) {
  if (B <= 0) return 0;
  if (K < 1 || (cdf != nullptr && (n <= 0 || mpk == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Prior pr{kind, loc, scale, hi, log_scale};
#define PYABC_PROPOSE_M(DB)                                                 \
  launch_models<DB>(B, K, d, n, cdf, thetas, chol, pr, dims, model_p, mpk, \
                    k0, k1, gen, tag, model_tag, max_rounds, counters,    \
                    n_redraws, theta, logpri, valid, m, stream)
  if (d <= 1)
    PYABC_PROPOSE_M(1);
  else if (d <= 2)
    PYABC_PROPOSE_M(2);
  else if (d <= 4)
    PYABC_PROPOSE_M(4);
  else if (d <= 8)
    PYABC_PROPOSE_M(8);
  else if (d <= 16)
    PYABC_PROPOSE_M(16);
  else if (d <= 32)
    PYABC_PROPOSE_M(32);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef PYABC_PROPOSE_M
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pyabc_philox_blocks(const uint32_t* ctr, int N, unsigned k0,
                                   unsigned k1, uint32_t* words, float* uni,
                                   float* nrm, void* stream_ptr) {
  if (N <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  philox_blocks_kernel<<<(N + 127) / 128, 128, 0, stream>>>(ctr, N, k0, k1,
                                                            words, uni, nrm);
  return static_cast<int>(cudaGetLastError());
}
