// K2 propose (with K1, philox.cuh): the proposal of one round.
//
// Replaces: pyabc_tpu/inference/util.py::_switch_propose_sim (the fixed
// unroll of N_REDRAWS draws against zero prior mass), _lane_transition and
// _lane_prior, transition/multivariatenormal.py::device_rvs and
// core/random_variables.py::Distribution.rvs_array / logpdf_array with every
// family's sampler and log-density (:139-329) and LowerBoundDecorator.rvs /
// logpdf (:394, :406), with the threefry key tree replaced by in-kernel
// Philox4x32-10.
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
//   prior (cdf == nullptr): theta_k from dimension k's family (below);
//     every lane is valid.
//
// The prior table (core/random_variables.py, per dimension): kind (the
// family code), loc, scale, hi (the support's upper edge), log_scale and
// par[6] = {pa, pb, c0, c1, c2, bound}: the shape parameters, three
// constants of the log-density computed on the host, and the lower bound
// of a LowerBoundDecorator (-inf undecorated). The log-density sums, dim by
// dim in order, each family's JAX formula in float32 (family_logpdf; the
// discrete ones are continuous in x, as JAX's, so the MVN proposal's
// off-integer thetas score without rounding), -inf at or below a bound.
//
// Philox layout of the prior draw (counter (lane, block, generation, tag *
// max_rounds + round)): an undecorated norm or uniform keeps its blocks --
// normal k from blocks [0, nb), uniform k from word k % 4 of block nb + k /
// 4 -- so every norm/uniform prior draws the numbers it always drew. Any
// other dimension k takes draw number q = 1 + 9 k, a decorated one its
// draws q + j, j < 9 (the first above the bound kept, else 2 bound - x of
// the ninth); a draw's uniform i is word i % 4 of block (q << 12) | i / 4,
// and its second sequence (beta's second gamma, t's normal, nbinom's
// Poisson) is draw number q + 512. Blocks of draw numbers start at 4096, the
// first blocks [0, 2 nb) end below 16 for d <= 32, and q + 512 <= 800 <
// 2^20: no two ranges meet. The samplers (family_draw) follow the JAX
// algorithms, their law and not their bits: Marsaglia-Tsang for gamma (the
// boost gamma(a + 1) u^(1/a) in log space for a < 1; attempt t reads block
// 1 + t: a cos normal of words 0-1 and the uniform of word 2; the boost
// uniform is word 0 of block 0; at most 64 attempts, after which V = 1),
// beta from two log-gammas, t as normal sqrt((df/2) / gamma(df/2)),
// truncnorm as sqrt2 erfinv(u) with u between erf(a/sqrt2) and erf(b/sqrt2),
// clipped inside (a, b), expon -log1p(-u), laplace and cauchy by inverse
// CDFs, randint floor(low + u (high - low)) capped at high - 1, binom by
// JAX's inversion / BTRS split (at most 16384 uniforms; at the cap inversion
// gives the count it reached and BTRS -1, as JAX's loops), poisson through
// philox.cuh::poisson and nbinom as that Poisson of a gamma. Every sum,
// product and quotient that decides a rejection is written with an _rn
// intrinsic, so the plain twin (one rounding per operation) takes the same
// branch on the card; logf, log1pf, lgammaf, erfinvf, tanf stay the accurate
// libm (no --use_fast_math). The samplers are __noinline__ and the families'
// log-density past norm and uniform too. Both kernels are templated on FAM:
// a prior of undecorated norm and uniform dims only (the table's host flag
// families = 0) runs the FAM = false instantiations, the code K2 had before
// the other families, with its registers and its time.
//
// The round index is read from counters[1] on the device; the generation
// and stream tag are arguments.
//
// Bound on an H100: operations, and tiny ones. Per lane and redraw one
// binary search over n (log2 n dependent loads), (1 + nb) Philox blocks of
// 10 rounds each and d^2 multiply-adds; the inputs are n (d + 1) floats
// read by every lane from L2. At B = 4096 lanes the kernel is latency
// bound: each thread's Philox rounds and search steps are a dependent
// chain, and B / 128 blocks fill the card once. The prior draw of a family
// with a rejection loop is a dependent chain of its attempts; lanes of one
// warp whose dimensions take other branches wait for each other.
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
  const float* par;  // (d, 6): pa, pb, c0, c1, c2, bound
};

// core/random_variables.py::FAMILIES
enum Family : int {
  kNorm = 0, kUniform, kLognorm, kExpon, kGamma, kBeta, kLaplace, kCauchy,
  kT, kTruncnorm, kRandint, kBinom, kPoisson, kNbinom
};

constexpr int kBoundDraws = 9;
constexpr uint32_t kSecondDraw = 512;
constexpr int kGammaMaxAttempts = 64;
constexpr int kBinomMaxUniforms = pyabc::kPoissonMaxUniforms;
constexpr float kPiF = 3.14159274101257324f;
constexpr float kSqrt2F = 1.41421353816986084f;
constexpr float kOneThird = 0.333333343267440796f;

__device__ __forceinline__ float xlogy0(float a, float y) {
  return a == 0.f ? 0.f : a * logf(y);
}

// The log-density of the families past norm and uniform (the JAX package's
// _*_logpdf, core/random_variables.py:171-329).
__device__ __noinline__ float family_logpdf(const Prior p, int k, float x) {
  const float* q = p.par + 6 * k;
  const float pa = q[0], pb = q[1], c0 = q[2], c1 = q[3], c2 = q[4];
  const float loc = p.loc[k], scale = p.scale[k], ls = p.log_scale[k];
  const float z = (x - loc) / scale;
  switch (p.kind[k]) {
    case kLognorm: {
      if (!(x > 0.f)) return -INFINITY;
      const float zz = logf(x / scale) / pa;
      return -0.5f * (zz * zz + PYABC_LOG_2PI) - logf(x * pa);
    }
    case kExpon:
      return z >= 0.f ? -z - ls : -INFINITY;
    case kGamma:
      return z > 0.f ? ((xlogy0(pa - 1.f, z) - z) - c0) - ls : -INFINITY;
    case kBeta: {
      if (!(z > 0.f && z < 1.f)) return -INFINITY;
      const float bm1 = pb - 1.f;
      const float t2 = bm1 == 0.f ? 0.f : bm1 * log1pf(-z);
      return (-c0 + (xlogy0(pa - 1.f, z) + t2)) - ls;
    }
    case kLaplace:
      return -fabsf(x - loc) / scale - c0;
    case kCauchy:
      return -logf(c0 * (1.f + z * z));
    case kT:
      return -(c0 + c1 * log1pf(z * z / pa)) - ls;
    case kTruncnorm:
      return (z >= pa && z <= pb)
                 ? (-0.5f * (z * z + PYABC_LOG_2PI) - ls) - c0
                 : -INFINITY;
    case kRandint:
      return (x >= loc && x < p.hi[k]) ? -ls : -INFINITY;
    case kBinom: {
      if (!(x >= 0.f && x <= pa)) return -INFINITY;
      const float nx = pa - x;
      const float logc = (c0 - lgammaf(x + 1.f)) - lgammaf(nx + 1.f);
      return (logc + (x == 0.f ? 0.f : x * c1)) + (nx == 0.f ? 0.f : nx * c2);
    }
    case kPoisson:
      return x >= 0.f ? (x * c0 - pa) - lgammaf(x + 1.f) : -INFINITY;
    case kNbinom:
      return x >= 0.f
                 ? (((lgammaf(x + pa) - c0) - lgammaf(x + 1.f)) + pa * c1) +
                       x * c2
                 : -INFINITY;
    default:
      return NAN;
  }
}

// FAM false: the table holds undecorated norm and uniform dims only (the
// families K2 knew first), and the kernel keeps their code as it was.
template <bool FAM>
__device__ __forceinline__ float prior_logpdf_dim(const Prior& p, int k,
                                                  float x) {
  const int kind = p.kind[k];
  const float ls = p.log_scale[k];
  float lp;
  if (kind == kNorm) {
    const float z = (x - p.loc[k]) / p.scale[k];
    lp = -0.5f * (z * z + PYABC_LOG_2PI) - ls;
  } else if (!FAM || kind == kUniform) {
    lp = (x >= p.loc[k] && x <= p.hi[k]) ? -ls : -INFINITY;
  } else {
    lp = family_logpdf(p, k, x);
  }
  if (!FAM) return lp;
  const float bound = p.par[6 * k + 5];
  return (bound != -INFINITY && !(x > bound)) ? -INFINITY : lp;
}

// --------------------------------------------------------------- samplers
// uniform i of draw number q (philox.cuh::poisson's layout)
__device__ __forceinline__ pyabc::Words4 draw_block(
    const pyabc::PhiloxLane& rng, uint32_t q, uint32_t i) {
  return rng.block((q << pyabc::kPoissonBlockBits) | i);
}

__device__ __forceinline__ float draw_uniform(const pyabc::PhiloxLane& rng,
                                              uint32_t q, int i) {
  return pyabc::uniform_of(
      pyabc::word_of(draw_block(rng, q, (uint32_t)(i >> 2)), i & 3));
}

// Marsaglia-Tsang (jax/_src/random.py::_gamma_one) on alpha' = alpha
// (alpha >= 1) or alpha + 1: the gamma(alpha') draw is d V.
__device__ __noinline__ float2 gamma_mt(const pyabc::PhiloxLane rng,
                                        uint32_t q, float alpha) {
  const float ap = alpha >= 1.f ? alpha : __fadd_rn(alpha, 1.f);
  const float d = __fsub_rn(ap, kOneThird);
  const float c = __fdiv_rn(kOneThird, sqrtf(d));
  for (int t = 0; t < kGammaMaxAttempts; ++t) {
    const pyabc::Words4 w = draw_block(rng, q, (uint32_t)(1 + t));
    const float x = pyabc::box_muller(pyabc::uniform_of(w.x),
                                      pyabc::uniform_of(w.y), false);
    const float U = pyabc::uniform_of(w.z);
    const float v = __fadd_rn(1.f, __fmul_rn(x, c));
    if (!(v > 0.f)) continue;
    const float X = __fmul_rn(x, x);
    const float V = __fmul_rn(__fmul_rn(v, v), v);
    const bool cont =
        (U >= __fsub_rn(1.f, __fmul_rn(0.0331f, __fmul_rn(X, X)))) &&
        (logf(U) >= __fadd_rn(__fmul_rn(X, 0.5f),
                              __fmul_rn(d, __fadd_rn(__fsub_rn(1.f, V),
                                                     logf(V)))));
    if (!cont) return make_float2(d, V);
  }
  return make_float2(d, 1.f);
}

// log(d) + log(V) + [alpha < 1] log1p(-u) / alpha (jax.random.loggamma)
__device__ __forceinline__ float log_gamma_draw(const pyabc::PhiloxLane& rng,
                                                uint32_t q, float alpha) {
  const float2 dv = gamma_mt(rng, q, alpha);
  const float base = __fadd_rn(logf(dv.x), logf(dv.y));
  if (alpha >= 1.f) return base;
  const float boost =
      __fmul_rn(log1pf(-draw_uniform(rng, q, 0)), __fdiv_rn(1.f, alpha));
  return __fadd_rn(base, boost);
}

__device__ __forceinline__ float gamma_draw(const pyabc::PhiloxLane& rng,
                                            uint32_t q, float alpha) {
  if (alpha >= 1.f) {
    const float2 dv = gamma_mt(rng, q, alpha);
    return __fmul_rn(dv.x, dv.y);
  }
  return expf(log_gamma_draw(rng, q, alpha));
}

__device__ __forceinline__ float stirling_tail(float k) {
  const float table[10] = {0.0810614667953272f, 0.0413406959554092f,
                           0.0276779256849983f, 0.02079067210376509f,
                           0.0166446911898211f, 0.0138761288230707f,
                           0.0118967099458917f, 0.0104112652619720f,
                           0.00925546218271273f, 0.00833056343336287f};
  const float kc = fminf(fmaxf(k, 0.f), 9.f);
  if (k <= 9.f) return table[(int)floorf(kc)];
  const float k1 = __fadd_rn(kc, 1.f);
  const float kp1sq = __fmul_rn(k1, k1);
  const float inner = __fsub_rn((float)(1.0 / 360.0),
                                __fdiv_rn((float)(1.0 / 1260.0), kp1sq));
  return __fdiv_rn(__fsub_rn((float)(1.0 / 12.0), __fdiv_rn(inner, kp1sq)),
                   k1);
}

// jax.random.binomial's inversion / BTRS split (jax/_src/random.py::
// _binomial) for n trials of probability p.
__device__ __noinline__ float binom_draw(const pyabc::PhiloxLane rng,
                                         uint32_t q, float n, float p) {
  const bool p_lt = p < 0.5f;
  float qq = p_lt ? p : __fsub_rn(1.f, p);
  const bool bad = isnan(qq) || qq < 0.f || n < 0.f;
  if (bad) return NAN;
  float k;
  if (__fmul_rn(n, qq) <= 10.f) {
    if (qq == 0.f) {
      k = 0.f;
    } else {
      const float lm = log1pf(-qq);
      float num = 0.f, gsum = 0.f;
      pyabc::Words4 w{};
      for (int i = 0; i < kBinomMaxUniforms && gsum <= n; ++i) {
        if ((i & 3) == 0) w = draw_block(rng, q, (uint32_t)(i >> 2));
        num = __fadd_rn(num, 1.f);
        const float u = pyabc::uniform_of(pyabc::word_of(w, i & 3));
        gsum = __fadd_rn(gsum, ceilf(__fdiv_rn(logf(u), lm)));
      }
      k = __fsub_rn(num, 1.f);
    }
  } else {
    const float stddev = sqrtf(__fmul_rn(__fmul_rn(n, qq), __fsub_rn(1.f, qq)));
    const float b = __fadd_rn(1.15f, __fmul_rn(2.53f, stddev));
    const float a = __fadd_rn(__fadd_rn(-0.0873f, __fmul_rn(0.0248f, b)),
                              __fmul_rn(0.01f, qq));
    const float c = __fadd_rn(__fmul_rn(n, qq), 0.5f);
    const float v_r = __fsub_rn(0.92f, __fdiv_rn(4.2f, b));
    const float r = __fdiv_rn(qq, __fsub_rn(1.f, qq));
    const float alpha =
        __fmul_rn(__fadd_rn(2.83f, __fdiv_rn(5.1f, b)), stddev);
    const float m = floorf(__fmul_rn(__fadd_rn(n, 1.f), qq));
    const float nm1 = __fadd_rn(__fsub_rn(n, m), 1.f);
    const float t1 = __fmul_rn(
        __fadd_rn(m, 0.5f),
        logf(__fdiv_rn(__fadd_rn(m, 1.f), __fmul_rn(r, nm1))));
    const float st_m = stirling_tail(m);
    const float st_nm = stirling_tail(__fsub_rn(n, m));
    k = -1.f;
    pyabc::Words4 w{};
    for (int j = 0; j < kBinomMaxUniforms / 2; ++j) {
      if ((j & 1) == 0) w = draw_block(rng, q, (uint32_t)(j >> 1));
      const int o = (j & 1) * 2;
      const float u = __fsub_rn(pyabc::uniform_of(pyabc::word_of(w, o)), 0.5f);
      const float v = pyabc::uniform_of(pyabc::word_of(w, o + 1));
      const float us = __fsub_rn(0.5f, fabsf(u));
      const bool accept1 = (us >= 0.07f) && (v <= v_r);
      const float kk = floorf(__fadd_rn(
          __fmul_rn(__fadd_rn(__fdiv_rn(__fmul_rn(2.f, a), us), b), u), c));
      const bool reject = (kk < 0.f) || (kk > n);
      const float v2 = logf(__fdiv_rn(
          __fmul_rn(v, alpha), __fadd_rn(__fdiv_rn(a, __fmul_rn(us, us)), b)));
      const float nk1 = __fadd_rn(__fsub_rn(n, kk), 1.f);
      float ub = __fadd_rn(t1, __fmul_rn(__fadd_rn(n, 1.f),
                                         logf(__fdiv_rn(nm1, nk1))));
      ub = __fadd_rn(ub, __fmul_rn(__fadd_rn(kk, 0.5f),
                                   logf(__fdiv_rn(__fmul_rn(r, nk1),
                                                  __fadd_rn(kk, 1.f)))));
      ub = __fadd_rn(__fadd_rn(ub, st_m), st_nm);
      ub = __fsub_rn(__fsub_rn(ub, stirling_tail(kk)),
                     stirling_tail(__fsub_rn(n, kk)));
      if (accept1 || (!reject && v2 <= ub)) {
        k = kk;
        break;
      }
    }
  }
  return p_lt ? k : __fsub_rn(n, k);
}

// loc + scale y rounded twice, as the plain twin computes it
__device__ __forceinline__ float affine(float loc, float scale, float y) {
  return __fadd_rn(loc, __fmul_rn(scale, y));
}

// One draw of draw number q from dimension k's family.
__device__ __noinline__ float family_draw(const pyabc::PhiloxLane rng,
                                          const Prior p, int k, uint32_t q) {
  const float* par = p.par + 6 * k;
  const float pa = par[0], pb = par[1], c1 = par[3], c2 = par[4];
  const float loc = p.loc[k], scale = p.scale[k];
  const int kind = p.kind[k];
  switch (kind) {
    case kGamma:
      return affine(loc, scale, gamma_draw(rng, q, pa));
    case kBeta: {
      const float la = log_gamma_draw(rng, q, pa);
      const float lb = log_gamma_draw(rng, q + kSecondDraw, pb);
      const float top = fmaxf(la, lb);
      const float ga = expf(la - top), gb = expf(lb - top);
      return affine(loc, scale, __fdiv_rn(ga, __fadd_rn(ga, gb)));
    }
    case kT: {
      const float half = __fmul_rn(pa, 0.5f);
      const float g = gamma_draw(rng, q, half);
      const pyabc::Words4 w = draw_block(rng, q + kSecondDraw, 0);
      const float nz = pyabc::box_muller(pyabc::uniform_of(w.x),
                                         pyabc::uniform_of(w.y), false);
      return affine(loc, scale, __fmul_rn(nz, sqrtf(__fdiv_rn(half, g))));
    }
    case kBinom:
      return binom_draw(rng, q, pa, pb);
    case kPoisson:
      return pyabc::poisson(rng, q, pa);
    case kNbinom: {
      const float lam =
          __fdiv_rn(__fmul_rn(gamma_draw(rng, q, pa), __fsub_rn(1.f, pb)), pb);
      return pyabc::poisson(rng, q + kSecondDraw, lam);
    }
    default:
      break;
  }
  const pyabc::Words4 w = draw_block(rng, q, 0);
  const float u0 = pyabc::uniform_of(w.x);
  switch (kind) {
    case kNorm:
      return affine(loc, scale,
                    pyabc::box_muller(u0, pyabc::uniform_of(w.y), false));
    case kUniform:
      return affine(loc, scale, u0);
    case kLognorm:
      return __fmul_rn(scale, expf(__fmul_rn(
                                 pa, pyabc::box_muller(
                                         u0, pyabc::uniform_of(w.y), false))));
    case kExpon:
      return affine(loc, scale, -log1pf(-u0));
    case kLaplace: {
      const float u = __fsub_rn(__fmul_rn(2.f, u0), 1.f);
      return affine(loc, scale, copysignf(1.f, u) * log1pf(-fabsf(u)));
    }
    case kCauchy:
      return affine(loc, scale, tanf(__fmul_rn(kPiF, __fsub_rn(u0, 0.5f))));
    case kTruncnorm: {
      const float u =
          fmaxf(c1, __fadd_rn(__fmul_rn(u0, __fsub_rn(c2, c1)), c1));
      float y = __fmul_rn(kSqrt2F, erfinvf(u));
      y = fminf(fmaxf(y, nextafterf(pa, INFINITY)), nextafterf(pb, -INFINITY));
      return affine(loc, scale, y);
    }
    case kRandint:
      return fminf(floorf(affine(loc, scale, u0)), __fsub_rn(p.hi[k], 1.f));
    default:
      return NAN;
  }
}

// Dimension k of the prior draw: an undecorated norm or uniform from its
// first blocks, anything else from its draw numbers (the layout above).
template <bool FAM>
__device__ __forceinline__ float prior_draw_dim(const pyabc::PhiloxLane& rng,
                                                const Prior& p, int k,
                                                int nb) {
  const int kind = p.kind[k];
  if (!FAM) {
    const float r = kind == kNorm
                        ? rng.normal(0, k)
                        : rng.uniform((uint32_t)(nb + (k >> 2)), k & 3);
    return p.loc[k] + p.scale[k] * r;
  }
  const float bound = p.par[6 * k + 5];
  if (bound == -INFINITY && kind == kNorm)
    return p.loc[k] + p.scale[k] * rng.normal(0, k);
  if (bound == -INFINITY && kind == kUniform)
    return p.loc[k] +
           p.scale[k] * rng.uniform((uint32_t)(nb + (k >> 2)), k & 3);
  const uint32_t q = (uint32_t)(1 + kBoundDraws * k);
  float x = family_draw(rng, p, k, q);
  if (bound == -INFINITY) return x;
  for (int j = 1; j < kBoundDraws && !(x > bound); ++j)
    x = family_draw(rng, p, k, q + (uint32_t)j);
  return x > bound ? x : __fsub_rn(__fmul_rn(2.f, bound), x);
}

template <int D, bool FAM>
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
      th[k] = prior_draw_dim<FAM>(rng, pr, k, nb);
      const float part = prior_logpdf_dim<FAM>(pr, k, th[k]);
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
        const float part = prior_logpdf_dim<FAM>(pr, k, th[k]);
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

template <int D, bool FAM>
void launch(int B, int d, int n, const float* cdf, const float* thetas,
            const float* chol, int chol_per_row, Prior pr, uint32_t k0,
            uint32_t k1,
            uint32_t gen, uint32_t tag, uint32_t max_rounds,
            const int* counters, int n_redraws, float* theta, float* logpri,
            uint8_t* valid, cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  propose_kernel<D, FAM><<<grid, kThreads, 0, stream>>>(
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
// (cdf (K, n), thetas (K, n, d), chol (K, d, d)). With chol_per_row (K2's
// K > 1 local mode, each model a LocalTransition fit: local_transition.py::
// device_rvs :432 through _switch_propose_sim :415), chol is (K, n, d, d)
// and the ancestor's own factor chol[m, idx] perturbs it.
template <int D, bool FAM>
__global__ void __launch_bounds__(kThreads)
propose_models_kernel(int B, int K, int d, int n,
                      const float* __restrict__ cdf,
                      const float* __restrict__ thetas,
                      const float* __restrict__ chol, int chol_per_row,
                      Prior pr, const int* __restrict__ dims,
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
  const Prior pm{pr.kind + (size_t)m * d,      pr.loc + (size_t)m * d,
                 pr.scale + (size_t)m * d,     pr.hi + (size_t)m * d,
                 pr.log_scale + (size_t)m * d, pr.par + (size_t)m * d * 6};
  float th[D];
#pragma unroll
  for (int k = 0; k < D; ++k) th[k] = 0.f;
  float lp = 0.f;
  bool valid = true;

  if (cdf == nullptr) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k >= dim) break;
      th[k] = prior_draw_dim<FAM>(rng, pm, k, nb);
      const float part = prior_logpdf_dim<FAM>(pm, k, th[k]);
      lp = (k == 0) ? part : lp + part;
    }
  } else {
    const float* cdf_m = cdf + (size_t)m * n;
    const float* chol_m = chol + (chol_per_row ? 0 : (size_t)m * d * d);
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
      const float* L =
          chol_per_row ? chol + ((size_t)m * n + idx) * d * d : chol_m;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (k >= dim) break;
        float acc = 0.f;
#pragma unroll
        for (int l = 0; l < D; ++l)
          if (l < d) acc += L[k * d + l] * z[l];
        th[k] = anc[k] + acc;
        const float part = prior_logpdf_dim<FAM>(pm, k, th[k]);
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

template <int D, bool FAM>
void launch_models(int B, int K, int d, int n, const float* cdf,
                   const float* thetas, const float* chol, int chol_per_row,
                   Prior pr,
                   const int* dims, const float* model_p, const float* mpk,
                   uint32_t k0, uint32_t k1, uint32_t gen, uint32_t tag,
                   uint32_t model_tag, uint32_t max_rounds,
                   const int* counters, int n_redraws, float* theta,
                   float* logpri, uint8_t* valid, int* m,
                   cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  propose_models_kernel<D, FAM><<<grid, kThreads, 0, stream>>>(
      B, K, d, n, cdf, thetas, chol, chol_per_row, pr, dims, model_p, mpk, k0,
      k1, gen, tag, model_tag, max_rounds, counters, n_redraws, theta, logpri,
      valid, m);
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
// LocalTransition's (n, d, d) factors (K2's local mode). families: 0 when
// every dimension is an undecorated norm or uniform (the kernel then runs
// their code alone), else 1.
extern "C" int pyabc_propose(
    int B, int d, int n, const float* cdf, const float* thetas,
    const float* chol, int chol_per_row, const int* kind, const float* loc,
    const float* scale, const float* hi, const float* log_scale,
    const float* par, int families, unsigned k0, unsigned k1, unsigned gen,
    unsigned tag, unsigned max_rounds, const int* counters, int n_redraws,
    float* theta, float* logpri, uint8_t* valid, void* stream_ptr) {
  if (B <= 0) return 0;
  if (cdf != nullptr && n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Prior pr{kind, loc, scale, hi, log_scale, par};
#define PYABC_PROPOSE(DB)                                                    \
  (families ? launch<DB, true> : launch<DB, false>)(                        \
      B, d, n, cdf, thetas, chol, chol_per_row, pr, k0, k1, gen, tag,       \
      max_rounds, counters, n_redraws, theta, logpri, valid, stream)
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
// perturbation matrix); m receives each lane's model index. chol_per_row:
// 0 for the models' MVN factors (K, d, d), 1 for LocalTransition's (K, n,
// d, d) (K2's K > 1 local mode).
extern "C" int pyabc_propose_models(
    int B, int K, int d, int n, const float* cdf, const float* thetas,
    const float* chol, int chol_per_row, const int* kind, const float* loc,
    const float* scale, const float* hi, const float* log_scale,
    const float* par, int families, const int* dims, const float* model_p,
    const float* mpk, unsigned k0, unsigned k1, unsigned gen, unsigned tag,
    unsigned model_tag,
    unsigned max_rounds, const int* counters, int n_redraws, float* theta,
    float* logpri, uint8_t* valid, int* m, void* stream_ptr) {
  if (B <= 0) return 0;
  if (K < 1 || (cdf != nullptr && (n <= 0 || mpk == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Prior pr{kind, loc, scale, hi, log_scale, par};
#define PYABC_PROPOSE_M(DB)                                                 \
  (families ? launch_models<DB, true> : launch_models<DB, false>)(         \
      B, K, d, n, cdf, thetas, chol, chol_per_row, pr, dims, model_p, mpk, \
      k0, k1, gen, tag, model_tag, max_rounds, counters, n_redraws, theta, \
      logpri, valid, m, stream)
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
