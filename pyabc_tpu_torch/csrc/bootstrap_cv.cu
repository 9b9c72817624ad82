// K16 bootstrap_cv: the in-kernel AdaptivePopulationSize, the bootstrap
// coefficient of variation of the refit KDE and its bisection over n.
//
// Replaces: pyabc_tpu/transition/util.py::device_mean_cv (:150) and
// device_required_nr (:189), MultivariateNormalTransition's statics
// (multivariatenormal.py:222, :236) and their call after the refit
// (inference/util.py:2094-2150).
//
// Four entries; the host launches the draw once a generation and then a
// fixed 1 + ceil(log2(max_n - min_n + 1)) probes of fit, density and
// bisect step. The probe's n and the bisection state live in device memory
// (state = lo, hi, n_probe, done, probes taken); a probe whose state reads
// done returns at once, so nothing is read back to the host.
//
// - draw (one thread per model, bootstrap and slot): a uniform from the
//   BOOT Philox stream (lane = slot, block = (model << 8) | bootstrap,
//   word 0, round 0) searched in the fit's ancestor cdf as K2 does; the
//   int32 ancestors (K, n_boot, n_cap) serve every probe (one key for every
//   probe, as the JAX package's). Thread 0 resets the state to (min_n,
//   max_n, max_n, 0, 0).
// - fit (one block per model and bootstrap): the first n resampled rows,
//   each of weight 1/n, through mvn_fit.cuh (K8's moments, smart_cov guard,
//   bandwidth on the ESS, jitter ladder, precision, logdet); then the
//   centred rows c_i = theta_i - mean and quad_i = c_i' P c_i of those n rows.
// - density (one thread per fitted particle j of model k; a zero-weight
//   particle computes nothing): for each bootstrap, u = x_j - centre,
//   Pu = P u and the log-density -logdet / 2 + logsumexp_i(-maha_i / 2),
//   maha_i = u'Pu - 2 c_i'Pu + quad_i, as an online logsumexp over only the
//   first n components (the JAX package sums all n_cap, but a weight of 0
//   adds nothing to its logsumexp(b=w)); the constants dim log(2 pi) / 2 and
//   log(1/n) are the same for every bootstrap and cancel in the shift by
//   the per-point maximum. Then dens_b = exp(ld_b - max), their mean and
//   std (ddof 0), cv = std / mean where mean > 0, and w_j cv_j and w_j
//   summed by a fixed tree per block into partial (K, blocks, 2).
// - bisect step (one thread): cv_k = sum w cv / max(sum w, 1e-38) over the
//   blocks in order, the aggregate sum_k where(p_k > 0, p_k / sum p cv_k,
//   0) (one model: cv_0), then the JAX rule: the first probe is cv(max_n),
//   which ends the bisection at max_n when it misses the target; then
//   mid = (lo + hi) / 2, hi = mid where cv(mid) <= target, else lo = mid +
//   1, until lo >= hi. The result is hi.
//
// Bound on an H100: operations. The density does K n_live n_boot n terms
// of 2 d + 8 operations (an exp each): at n_cap 16384, 10 bootstraps,
// d 4 and n = 16384 that is 2.7e9 terms, 0.64 ms at 67 TFLOP/s; the draw,
// fit and bisect step are latency bound (a few MB at most). Design: the
// density block loads a tile of 256 centred rows and their quads into
// shared memory, which every thread of the block reads as a broadcast;
// the per-bootstrap log-densities stay in a local array (n_boot <= 32).
// A simple kernel, not a fast one: no tensor cores, one particle a thread.
//
// LocalTransition mode (device_mean_cv over local_transition.py::device_fit
// :329 and device_logpdf :442, as util.py:2094-2150 calls them with a
// LocalTransition): the draw and the bisect step are the ones above; each
// probe's fit and density take two more entries around K12 and K13:
// - local gather (one thread per model, bootstrap and slot): rows[k nb + b,
//   i] = thetas[k, idx[k, b, i]] and the bootstrap weights boot_w[i] = i <
//   n ? 1 / max(n, 1) : 0 (all 0 once done), and go = !done, the flag the
//   probe's K12 and K13 launches read (local_cov.cu, local_factor.cu: a flag
//   of 0 returns at once and, without previous params, writes nothing). The
//   host launches K12 then K13 (the full factorization) for each model and
//   bootstrap on these rows, each fit's params kept in (K nb, n_cap, ...)
//   buffers: a bootstrap's k is K12's own, from the n rows of weight > 0
//   (the float64 k table, as the refit's).
// - local density (a block per tile of 256 fitted particles, bootstrap b
//   and model k, R = 2 particles a thread): the
//   tile's log-densities under bootstrap b's mixture through local_mix.cuh
//   (local_mix_logpdf_ring: the arithmetic of K14's tile loop for each
//   particle, so bit-equal to K14 on the same mixture; its components past
//   n have weight 0), over the first n components only, the components
//   streaming through a ring of shared-memory tiles filled by cp.async.
//   Each block writes its values to ld (K nb, n_cap) and takes a ticket
//   for its tile in device memory; the last of the tile's nb blocks reads
//   each particle's nb values, forms the CV in the order above and sums
//   the tile by the fixed 256-particle tree, so partial has the same bits
//   from run to run. A tile with no live particle returns at once (its
//   bootstrap-0 block writes the tile's zero sums).
//   The JAX package's constants log(1/n) sit inside lconst here and cancel
//   in the shift by the per-point maximum as there.
// Bound of the local density: operations, K n_live n_boot n pairs of
// (2 d^2 + 2 d + 2 fmas and one exp): at the LV adaptive leg (n 16384, 10
// bootstraps, d 4) 2.7e9 pairs, about 2 ms at 67 TFLOP/s, and some 40
// FP32 instructions a pair (3.5-4 ms at the card's issue rate). The grid
// over (tile, bootstrap, model) gives 640 blocks at that leg where one
// block a tile gave 64; R particles a thread read each component once from
// shared memory (16-byte loads) and run R independent chains.
#include "common.cuh"
#include "local_mix.cuh"
#include "mvn_fit.cuh"
#include "philox.cuh"

namespace {

using pyabc::FitShared;
using pyabc::FitThreads;
constexpr int kMaxModels = 8;
constexpr int kMaxBoot = 32;
constexpr int kMaxProbes = 32;
constexpr int kDensityThreads = 256;
// fitted particles a thread of the local density computes (R): 2 ran
// 5.77 ms at the LV leg against 6.28 for 4 (an H100 80GB HBM3 at 700 W)
constexpr int kDensityRows = 2;
// the bisection state
constexpr int kLo = 0, kHi = 1, kProbe = 2, kDone = 3, kStep = 4;

// per-model fit statics, passed by value: model k reads slot k
struct BootModels {
  int dim[kMaxModels];
  float scaling[kMaxModels];
  int selector[kMaxModels];
  float sel_const[kMaxModels];
  float sel_exp[kMaxModels];
};

__global__ void boot_draw_kernel(const float* __restrict__ cdf, int K, int nb,
                                 int n_cap, uint32_t k0, uint32_t k1,
                                 uint32_t gen, uint32_t tag,
                                 uint32_t max_rounds, int min_n, int max_n,
                                 int* __restrict__ idx,
                                 int* __restrict__ state) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) {
    state[kLo] = min_n;
    state[kHi] = max_n;
    state[kProbe] = max_n;
    state[kDone] = 0;
    state[kStep] = 0;
  }
  if (t >= (long long)K * nb * n_cap) return;
  const int slot = (int)(t % n_cap);
  const int kb = (int)(t / n_cap);
  const int b = kb % nb, k = kb / nb;
  const float* c = cdf + (size_t)k * n_cap;
  const pyabc::PhiloxLane rng =
      pyabc::philox_lane(k0, k1, (uint32_t)slot, gen, tag, max_rounds, 0u);
  const float total = c[n_cap - 1];
  const float below = nextafterf(total, 0.f);
  float x = rng.uniform((uint32_t)((k << 8) | b), 0) * total;
  if (!isnan(x) && !(x <= below)) x = below;  // torch.minimum
  int i = n_cap - 1;
  if (!isnan(x)) {
    int lo = 0, hi = n_cap;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (c[mid] <= x)
        lo = mid + 1;
      else
        hi = mid;
    }
    i = min(lo, n_cap - 1);
  }
  idx[t] = i;
}

// K16's row source: the first n resampled rows of one bootstrap, each of
// weight 1/n (raw), normalized by their sum as device_fit does
struct BootRows {
  const float* thetas;
  const int* idx;
  int d;
  float inv_n;
  __device__ __forceinline__ float raw_weight(int) const { return inv_n; }
  __device__ __forceinline__ float theta(int i, int k) const {
    return thetas[(size_t)idx[i] * d + k];
  }
  __device__ __forceinline__ void put_w(int, float) const {}
  __device__ __forceinline__ float w(int, float ws) const {
    return inv_n / ws;
  }
};

template <int D>
__global__ void __launch_bounds__(FitThreads<D>::value)
boot_fit_kernel(const float* __restrict__ thetas, const int* __restrict__ idx,
                const int* __restrict__ state, int nb, int n_cap, int d,
                BootModels bm, float* __restrict__ center,
                float* __restrict__ prec, float* __restrict__ logdet,
                float* __restrict__ thc, float* __restrict__ quad) {
  constexpr int kThreads = FitThreads<D>::value;
  if (state[kDone]) return;
  const int n = max(0, min(state[kProbe], n_cap));
  const int kb = blockIdx.x, k = kb / nb;
  __shared__ FitShared<D, kThreads> sh;
  const int tid = threadIdx.x;
  const BootRows rows{thetas + (size_t)k * n_cap * d,
                      idx + (size_t)kb * n_cap, d,
                      1.f / (float)max(n, 1)};
  pyabc::fit_params<D, kThreads>(rows, n, d, bm.dim[k], bm.scaling[k],
                                 bm.selector[k], bm.sel_const[k],
                                 bm.sel_exp[k], sh);
  if (tid == 0) {
    logdet[kb] = sh.logdet;
    for (int i = 0; i < d; ++i)
      for (int j = 0; j < d; ++j)
        prec[((size_t)kb * d + i) * d + j] = sh.prec[i * D + j];
  }
  if (tid < d) center[(size_t)kb * d + tid] = sh.mean[tid] * sh.vmask[tid];
  for (int i = tid; i < n; i += kThreads) {
    float c[D];
#pragma unroll
    for (int q = 0; q < D; ++q) {
      if (q >= d) break;
      c[q] = rows.theta(i, q) * sh.vmask[q] - sh.mean[q] * sh.vmask[q];
      thc[((size_t)kb * n_cap + i) * d + q] = c[q];
    }
    quad[(size_t)kb * n_cap + i] = pyabc::fit_quad<D>(c, sh.prec, d);
  }
}

// A 256-particle tile's sums of w cv and w by a fixed tree (the same sums
// from run to run), written to partial[k][tile] by TPB threads; s_red
// holds the tile's (w cv, w) at [o] and [256 + o] for particle offset o.
template <int TPB>
__device__ void tile_tree(float* s_red, float* __restrict__ partial, int k,
                          int tile, int tiles) {
  constexpr int T = kDensityThreads;
  __syncthreads();
  for (int stride = T / 2; stride > 0; stride >>= 1) {
    for (int o = threadIdx.x; o < stride; o += TPB) {
      s_red[o] += s_red[o + stride];
      s_red[T + o] += s_red[T + o + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float* out = partial + ((size_t)k * tiles + tile) * 2;
    out[0] = s_red[0];
    out[1] = s_red[T];
  }
}

template <int D>
__global__ void __launch_bounds__(kDensityThreads)
boot_density_kernel(const float* __restrict__ thetas,
                    const float* __restrict__ weights,
                    const int* __restrict__ state, int nb, int n_cap, int d,
                    const float* __restrict__ center,
                    const float* __restrict__ prec,
                    const float* __restrict__ logdet,
                    const float* __restrict__ thc,
                    const float* __restrict__ quad,
                    float* __restrict__ partial) {
  constexpr int T = kDensityThreads;
  if (state[kDone]) return;
  const int n = max(0, min(state[kProbe], n_cap));
  const int k = blockIdx.y, tid = threadIdx.x;
  const int j = blockIdx.x * T + tid;
  const float w = j < n_cap ? weights[(size_t)k * n_cap + j] : 0.f;
  const bool live = w != 0.f;
  __shared__ float s_c[T * D];
  __shared__ float s_q[T];
  __shared__ float s_prec[D * D];
  __shared__ float s_center[D];
  __shared__ float s_red[2 * T];
  float wcv = 0.f;
  if (__syncthreads_or(live)) {
    float x[D];
#pragma unroll
    for (int q = 0; q < D; ++q)
      x[q] = (live && q < d) ? thetas[((size_t)k * n_cap + j) * d + q] : 0.f;
    float ld[kMaxBoot];
    for (int b = 0; b < nb; ++b) {
      const int kb = k * nb + b;
      __syncthreads();
      if (tid < d * d) s_prec[(tid / d) * D + tid % d] =
          prec[(size_t)kb * d * d + tid];
      if (tid < d) s_center[tid] = center[(size_t)kb * d + tid];
      __syncthreads();
      float u[D], Pu[D];
#pragma unroll
      for (int q = 0; q < D; ++q) u[q] = q < d ? x[q] - s_center[q] : 0.f;
      float uPu = 0.f;
#pragma unroll
      for (int l = 0; l < D; ++l) {
        float p = 0.f;
#pragma unroll
        for (int q = 0; q < D; ++q)
          if (l < d && q < d) p += s_prec[l * D + q] * u[q];
        Pu[l] = p;
        uPu += u[l] * p;
      }
      float mx = -INFINITY, s = 0.f;
      for (int t0 = 0; t0 < n; t0 += T) {
        __syncthreads();
        const int r = t0 + tid;
        if (r < n) {
          const size_t row = (size_t)kb * n_cap + r;
#pragma unroll
          for (int q = 0; q < D; ++q)
            if (q < d) s_c[tid * D + q] = thc[row * d + q];
          s_q[tid] = quad[row];
        }
        __syncthreads();
        if (live) {
          const int rows = min(T, n - t0);
          for (int rr = 0; rr < rows; ++rr) {
            float cross = 0.f;
#pragma unroll
            for (int q = 0; q < D; ++q)
              if (q < d) cross += s_c[rr * D + q] * Pu[q];
            const float lc = -0.5f * (uPu - 2.f * cross + s_q[rr]);
            if (lc > mx) {
              s = s * expf(mx - lc) + 1.f;
              mx = lc;
            } else {
              s += expf(lc - mx);
            }
          }
        }
      }
      ld[b] = -0.5f * logdet[kb] + (mx + logf(s));
    }
    if (live) {
      float m = -INFINITY;
      for (int b = 0; b < nb; ++b) m = nan_max(m, ld[b]);
      float mean = 0.f;
      for (int b = 0; b < nb; ++b) mean += expf(ld[b] - m);
      mean = mean / (float)nb;
      float var = 0.f;
      for (int b = 0; b < nb; ++b) {
        const float e = expf(ld[b] - m) - mean;
        var += e * e;
      }
      const float sd = sqrtf(var / (float)nb);
      const float cv = mean > 0.f ? sd / mean : 0.f;
      wcv = w * cv;
    }
  }
  s_red[tid] = wcv;
  s_red[T + tid] = w;
  tile_tree<T>(s_red, partial, k, blockIdx.x, gridDim.x);
}

__global__ void boot_bisect_kernel(const float* __restrict__ partial, int K,
                                   int nblk, const float* __restrict__ model_p,
                                   int* __restrict__ state,
                                   float* __restrict__ cvs, float target) {
  if (state[kDone]) return;
  float psum = 0.f;
  if (model_p != nullptr) {
    for (int k = 0; k < K; ++k) psum += model_p[k];
    psum = pyabc::clamp_min_keep_nan(psum, 1e-38f);
  }
  float tot = 0.f;
  for (int k = 0; k < K; ++k) {
    float a = 0.f, ws = 0.f;
    for (int i = 0; i < nblk; ++i) {
      a += partial[((size_t)k * nblk + i) * 2];
      ws += partial[((size_t)k * nblk + i) * 2 + 1];
    }
    const float cv = a / pyabc::clamp_min_keep_nan(ws, 1e-38f);
    if (model_p == nullptr) {
      tot += cv;
    } else {
      const float p = model_p[k];
      tot += p > 0.f ? p / psum * cv : 0.f;
    }
  }
  const int step = state[kStep];
  if (step < kMaxProbes) cvs[step] = tot;
  int lo = state[kLo], hi = state[kHi], probe = state[kProbe], done = 0;
  if (step == 0) {
    if (tot > target) done = 1;  // unreachable: max_n at once
  } else if (tot <= target) {
    hi = probe;
  } else {
    lo = probe + 1;
  }
  if (!done) {
    if (lo < hi)
      probe = (lo + hi) / 2;
    else
      done = 1;
  }
  state[kLo] = lo;
  state[kHi] = hi;
  state[kProbe] = probe;
  state[kDone] = done;
  state[kStep] = step + 1;
}

// The rows and bootstrap weights of a probe's LocalTransition fits, and
// the flag (go = !done) their K12 and K13 launches read.
__global__ void boot_gather_kernel(const float* __restrict__ thetas,
                                   const int* __restrict__ idx,
                                   const int* __restrict__ state, int K,
                                   int nb, int n_cap, int d,
                                   float* __restrict__ rows,
                                   float* __restrict__ boot_w,
                                   int* __restrict__ go) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool done = state[kDone] != 0;
  if (t == 0) go[0] = done ? 0 : 1;
  const int n = max(0, min(state[kProbe], n_cap));
  if (t < n_cap)
    boot_w[t] = (!done && t < n) ? 1.f / (float)max(n, 1) : 0.f;
  if (done || t >= (long long)K * nb * n_cap) return;
  const int k = (int)(t / n_cap) / nb;
  const float* src = thetas + ((size_t)k * n_cap + idx[t]) * d;
  float* dst = rows + (size_t)t * d;
  for (int q = 0; q < d; ++q) dst[q] = src[q];
}

// One block per (particle tile of 256, bootstrap b, model k), R particles
// a thread: the tile's log-densities under fit k nb + b into ld; the last
// block of the tile to finish (a ticket in device memory) reads the nb
// values of each particle and writes the tile's partial sums.
template <int D, int R>
__global__ void __launch_bounds__(kDensityThreads / R)
boot_local_density_kernel(const float* __restrict__ thetas,
                          const float* __restrict__ weights,
                          const int* __restrict__ state, int nb, int n_cap,
                          int d, const float* __restrict__ fth,
                          const float* __restrict__ fprec,
                          const float* __restrict__ flconst,
                          const float* __restrict__ fw,
                          float* __restrict__ partial,
                          float* __restrict__ ld_out,
                          int* __restrict__ tickets) {
  constexpr int TPB = kDensityThreads / R;
  if (state[kDone]) return;
  const int n = max(0, min(state[kProbe], n_cap));
  const int tile = blockIdx.x, b = blockIdx.y, k = blockIdx.z;
  const int tiles = gridDim.x, tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char ring_raw[];
  __shared__ float s_red[2 * kDensityThreads];
  __shared__ int s_last;
  int j[R];
  float w[R];
  bool live[R], any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    j[r] = tile * kDensityThreads + r * TPB + tid;
    w[r] = j[r] < n_cap ? weights[(size_t)k * n_cap + j[r]] : 0.f;
    live[r] = w[r] != 0.f;
    any = any || live[r];
  }
  if (!__syncthreads_or(any)) {  // no live particle: bootstrap 0 writes
    if (b != 0) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s_red[r * TPB + tid] = 0.f;
      s_red[kDensityThreads + r * TPB + tid] = w[r];
    }
    tile_tree<TPB>(s_red, partial, k, tile, tiles);
    return;
  }
  float x[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < D; ++q)
      x[r][q] = (live[r] && q < d)
                    ? thetas[((size_t)k * n_cap + j[r]) * d + q]
                    : 0.f;
  const size_t c0 = (size_t)(k * nb + b) * n_cap;
  float ld[R];
  pyabc::local_mix_logpdf_ring<D, R>(
      x, fth + c0 * d, fprec + c0 * d * d, flconst + c0, fw + c0, n, d,
      reinterpret_cast<pyabc::MixStage<D>*>(ring_raw), ld);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (live[r]) ld_out[c0 + j[r]] = ld[r];
  __threadfence();  // this block's ld before its ticket
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&tickets[(size_t)k * tiles + tile], 1) == nb - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();  // the other blocks' ld after their tickets
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float wcv = 0.f;
    if (live[r]) {
      float v[kMaxBoot];
      float m = -INFINITY;
      for (int bb = 0; bb < nb; ++bb) {
        v[bb] = __ldcg(ld_out + (size_t)(k * nb + bb) * n_cap + j[r]);
        m = nan_max(m, v[bb]);
      }
      float mean = 0.f;
      for (int bb = 0; bb < nb; ++bb) mean += expf(v[bb] - m);
      mean = mean / (float)nb;
      float var = 0.f;
      for (int bb = 0; bb < nb; ++bb) {
        const float e = expf(v[bb] - m) - mean;
        var += e * e;
      }
      const float sd = sqrtf(var / (float)nb);
      const float cv = mean > 0.f ? sd / mean : 0.f;
      wcv = w[r] * cv;
    }
    s_red[r * TPB + tid] = wcv;
    s_red[kDensityThreads + r * TPB + tid] = w[r];
  }
  tile_tree<TPB>(s_red, partial, k, tile, tiles);
}

template <int D, int R>
int local_density_launch(const float* thetas, const float* weights,
                         const int* state, int K, int nb, int n_cap, int d,
                         const float* fth, const float* fprec,
                         const float* flconst, const float* fw,
                         float* partial, float* ld, int* tickets,
                         cudaStream_t stream) {
  const size_t smem = pyabc::kMixStages * sizeof(pyabc::MixStage<D>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        boot_local_density_kernel<D, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n_cap + kDensityThreads - 1) / kDensityThreads, nb, K);
  boot_local_density_kernel<D, R><<<grid, kDensityThreads / R, smem,
                                     stream>>>(
      thetas, weights, state, nb, n_cap, d, fth, fprec, flconst, fw, partial,
      ld, tickets);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
void fit_launch(const float* thetas, const int* idx, const int* state,
                int blocks, int nb, int n_cap, int d, const BootModels& bm,
                float* center, float* prec, float* logdet, float* thc,
                float* quad, cudaStream_t stream) {
  boot_fit_kernel<D><<<blocks, FitThreads<D>::value, 0, stream>>>(
      thetas, idx, state, nb, n_cap, d, bm, center, prec, logdet, thc, quad);
}

template <int D>
void density_launch(const float* thetas, const float* weights,
                    const int* state, int K, int nb, int n_cap, int d,
                    const float* center, const float* prec,
                    const float* logdet, const float* thc, const float* quad,
                    float* partial, cudaStream_t stream) {
  const dim3 grid((n_cap + kDensityThreads - 1) / kDensityThreads, K);
  boot_density_kernel<D><<<grid, kDensityThreads, 0, stream>>>(
      thetas, weights, state, nb, n_cap, d, center, prec, logdet, thc, quad,
      partial);
}

bool shape_ok(int K, int nb, int n_cap, int d) {
  return K >= 1 && K <= kMaxModels && nb >= 1 && nb <= kMaxBoot &&
         n_cap >= 1 && d >= 1 && d <= 32;
}

}  // namespace

// idx (K, nb, n_cap) int32 from cdf (K, n_cap); state (5,) int32 reset.
extern "C" int pyabc_boot_draw(const float* cdf, int K, int nb, int n_cap,
                               unsigned k0, unsigned k1, unsigned gen,
                               unsigned tag, unsigned max_rounds, int min_n,
                               int max_n, int* idx, int* state,
                               void* stream_ptr) {
  if (!shape_ok(K, nb, n_cap, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)K * nb * n_cap;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  boot_draw_kernel<<<blocks, threads, 0,
                     static_cast<cudaStream_t>(stream_ptr)>>>(
      cdf, K, nb, n_cap, k0, k1, gen, tag, max_rounds, min_n, max_n, idx,
      state);
  return static_cast<int>(cudaGetLastError());
}

// thetas (K, n_cap, d), idx (K, nb, n_cap); the statics are host arrays of
// K entries; outputs center (K, nb, d), prec (K, nb, d, d), logdet (K, nb),
// thc (K, nb, n_cap, d) and quad (K, nb, n_cap), the first n rows written.
extern "C" int pyabc_boot_fit(const float* thetas, const int* idx,
                              const int* state, int K, int nb, int n_cap,
                              int d, const int* dims, const float* scaling,
                              const int* selector, const float* sel_const,
                              const float* sel_exp, float* center,
                              float* prec, float* logdet, float* thc,
                              float* quad, void* stream_ptr) {
  if (!shape_ok(K, nb, n_cap, d))
    return static_cast<int>(cudaErrorInvalidValue);
  BootModels bm{};
  for (int k = 0; k < K; ++k) {
    bm.dim[k] = dims[k];
    bm.scaling[k] = scaling[k];
    bm.selector[k] = selector[k];
    bm.sel_const[k] = sel_const[k];
    bm.sel_exp[k] = sel_exp[k];
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define PYABC_BOOT_FIT(DB)                                                   \
  fit_launch<DB>(thetas, idx, state, K * nb, nb, n_cap, d, bm, center, prec, \
                 logdet, thc, quad, stream)
  if (d <= 1)
    PYABC_BOOT_FIT(1);
  else if (d <= 2)
    PYABC_BOOT_FIT(2);
  else if (d <= 4)
    PYABC_BOOT_FIT(4);
  else if (d <= 8)
    PYABC_BOOT_FIT(8);
  else if (d <= 16)
    PYABC_BOOT_FIT(16);
  else
    PYABC_BOOT_FIT(32);
#undef PYABC_BOOT_FIT
  return static_cast<int>(cudaGetLastError());
}

// thetas (K, n_cap, d) and weights (K, n_cap) of the refit; the fit's
// outputs; partial (K, ceil(n_cap / 256), 2).
extern "C" int pyabc_boot_density(const float* thetas, const float* weights,
                                  const int* state, int K, int nb, int n_cap,
                                  int d, const float* center,
                                  const float* prec, const float* logdet,
                                  const float* thc, const float* quad,
                                  float* partial, void* stream_ptr) {
  if (!shape_ok(K, nb, n_cap, d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define PYABC_BOOT_DENSITY(DB)                                              \
  density_launch<DB>(thetas, weights, state, K, nb, n_cap, d, center, prec, \
                     logdet, thc, quad, partial, stream)
  if (d <= 1)
    PYABC_BOOT_DENSITY(1);
  else if (d <= 2)
    PYABC_BOOT_DENSITY(2);
  else if (d <= 4)
    PYABC_BOOT_DENSITY(4);
  else if (d <= 8)
    PYABC_BOOT_DENSITY(8);
  else if (d <= 16)
    PYABC_BOOT_DENSITY(16);
  else
    PYABC_BOOT_DENSITY(32);
#undef PYABC_BOOT_DENSITY
  return static_cast<int>(cudaGetLastError());
}

// One bisection step over partial (K, nblk, 2); model_p (K,) the new model
// probabilities or null for one model; cvs (32,) logs each probe's CV.
extern "C" int pyabc_boot_bisect(const float* partial, int K, int nblk,
                                 const float* model_p, int* state, float* cvs,
                                 float target, void* stream_ptr) {
  if (K < 1 || K > kMaxModels || nblk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  boot_bisect_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      partial, K, nblk, model_p, state, cvs, target);
  return static_cast<int>(cudaGetLastError());
}

// LocalTransition mode. thetas (K, n_cap, d), idx (K, nb, n_cap) and the
// state -> rows (K nb, n_cap, d), boot_w (n_cap,), go (1 int32).
extern "C" int pyabc_boot_local_gather(const float* thetas, const int* idx,
                                       const int* state, int K, int nb,
                                       int n_cap, int d, float* rows,
                                       float* boot_w, int* go,
                                       void* stream_ptr) {
  if (!shape_ok(K, nb, n_cap, d) || d > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)K * nb * n_cap;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  boot_gather_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream_ptr)>>>(
      thetas, idx, state, K, nb, n_cap, d, rows, boot_w, go);
  return static_cast<int>(cudaGetLastError());
}

// thetas (K, n_cap, d) and weights (K, n_cap) of the refit; the bootstrap
// fits' thetas (K nb, n_cap, d), precs (K nb, n_cap, d, d), lconst and
// weights (K nb, n_cap); partial (K, ceil(n_cap / 256), 2); ld (K nb,
// n_cap): each live particle's log-density under each fit (written, then
// read by the CV); tickets (K, ceil(n_cap / 256)) int32, zero.
extern "C" int pyabc_boot_local_density(
    const float* thetas, const float* weights, const int* state, int K,
    int nb, int n_cap, int d, const float* fth, const float* fprec,
    const float* flconst, const float* fw, float* partial, float* ld,
    int* tickets, void* stream_ptr) {
  if (!shape_ok(K, nb, n_cap, d) || d > 16 || ld == nullptr ||
      tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define PYABC_BOOT_LOCAL(DB)                                               \
  return local_density_launch<DB, kDensityRows>(                          \
      thetas, weights, state, K, nb, n_cap, d, fth, fprec, flconst, fw,    \
      partial, ld, tickets, stream)
  if (d <= 1) PYABC_BOOT_LOCAL(1);
  if (d <= 2) PYABC_BOOT_LOCAL(2);
  if (d <= 4) PYABC_BOOT_LOCAL(4);
  if (d <= 8) PYABC_BOOT_LOCAL(8);
  PYABC_BOOT_LOCAL(16);
#undef PYABC_BOOT_LOCAL
}
