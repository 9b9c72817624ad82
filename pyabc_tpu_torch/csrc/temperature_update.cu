// K21b temperature_update: the per-generation pdf-norm and temperature
// update of noisy ABC, and the initial temperature from the calibration.
//
// Replaces: pyabc_tpu/inference/util.py::DeviceContext.
// _stochastic_gen_update (the device twin of the host pair
// StochasticAcceptor._update_norm and Temperature._set), and the host
// initial temperature of pyabc_tpu/epsilon/temperature.py::Temperature._set
// at t = 0.
//
// One block of kThreads threads; every input is a device tensor (the
// previous temperature, the norm, the running maximum, Daly's k and the
// acceptance rate are pointers), so the update adds no host read:
//   1. logv = log(max(v, 1e-30)) (SCALE_LIN) or v of the reservoir rows;
//      max_found' = max(max_found, max over k_mask of logv) (NaN kept);
//      pdf_norm' = pdf_max where the kernel has one, else max(pdf_norm,
//      max_found'); ScaledPDFNorm: min(pdf_norm', quant + log(factor)),
//      quant the alpha-quantile of the accepted logv with numpy's linear
//      interpolation (rows outside k_mask count as +inf, NaN sorts last).
//      The two order statistics are found by rank counting, each thread
//      ranking its rows against all (n^2 / kThreads compares: simple, and
//      only ScaledPDFNorm runs it);
//   2. each scheme proposes, in the order given:
//      acceptance rate: record weights w (uniform over valid records, or
//        exp(clip(logq_new - logq, +-60)) normalized; uniform if they sum
//        to 0), diff = logv_rec - pdf_norm'; rate(T) = sum w min(1,
//        exp(diff / T)); T = 1 if rate(1) >= target, else 10^hi after 60
//        bisection steps of log10 T on [0, 12];
//      ESS: the same bisection of the relative ESS of the tempering
//        factors (1/T - 1/T_prev) logv over the accepted set;
//      exp/poly decay over a fixed horizon, the fixed ratio, Friel-Pettitt
//        and Daly (its k carried) in closed form; a constant (calibration);
//   3. T' = the least finite proposal (else the fallback: the previous T,
//      or 1e4 for the initial one), clamped to [1, T], and 1 at the last
//      generation of a known horizon.
// Scratch (global, 2 rec_n + 2 n floats): the record weights and diffs and
// the accepted logv and weights, written once and re-read by every
// bisection step (they stay in L1/L2).
//
// Bound on an H100: neither bytes nor operations. The update reads the
// ring (12 bytes a record, 8192 records) and the reservoir once, then runs
// 61 dependent block reductions per bisection scheme; each waits on the
// one before, so the kernel is latency bound (one SM, barrier chains).
//
// Numerics: float32 throughout, sums in a block tree (JAX's in another
// order), so a bisection step may flip where rate(T) lies within rounding
// of the target; the quantile's interpolation is kept unfused (__fmul_rn,
// __fadd_rn) to match the plain version's two roundings.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 60;

enum Scheme {
  kAcceptanceRate = 0,
  kExpDecayFixedIter = 1,
  kPolyDecayFixedIter = 2,
  kExpDecayFixedRatio = 3,
  kFrielPettitt = 4,
  kDaly = 5,
  kEss = 6,
  kConstant = 7,
};

// min that propagates NaN like jnp.minimum (fminf drops it)
__device__ __forceinline__ float nan_min(float a, float b) {
  if (isnan(a) || isnan(b)) return a + b;
  return fminf(a, b);
}

// order-preserving key; NaN above +inf, as sorts place it
__device__ __forceinline__ uint32_t order_key(float x) {
  if (isnan(x)) return 0xFFFFFFFFu;
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Block-wide reductions; every thread gets the result. `sh` holds kWarps
// + 1 floats; the trailing barrier lets the next call reuse it.
__device__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < kWarps ? sh[lane] : 0.f;
    x = warp_sum(x);
    if (lane == 0) sh[kWarps] = x;
  }
  __syncthreads();
  const float r = sh[kWarps];
  __syncthreads();
  return r;
}

__device__ float block_nan_max(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_nan_max(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < kWarps ? sh[lane] : -INFINITY;
    x = warp_nan_max(x);
    if (lane == 0) sh[kWarps] = x;
  }
  __syncthreads();
  const float r = sh[kWarps];
  __syncthreads();
  return r;
}

struct Inputs {
  int rec_n;
  const float* rec_dist;
  const uint8_t* rec_valid;
  const float* rec_logq;  // null: uniform record weights
  const float* logq_new;
  int n;
  const float* res_dist;
  const uint8_t* k_mask;
  const float* w_norm;
  int lin;
  float* w_rec;     // scratch (rec_n)
  float* diff_rec;  // scratch (rec_n)
  float* logv_acc;  // scratch (n)
  float* w_acc;     // scratch (n)
};

__device__ __forceinline__ float log_value(float v, int lin) {
  return lin ? logf(nan_max(v, 1e-30f)) : v;
}

// sum_i w_i min(1, exp(diff_i / T)) over the records
__device__ float rate_at(const Inputs& in, float T, float* sh) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < in.rec_n; i += kThreads)
    acc += in.w_rec[i] * nan_min(1.f, expf(in.diff_rec[i] / T));
  return block_sum(acc, sh);
}

// the relative ESS of the tempering factors (1/T - beta_old) logv
__device__ float rel_ess(const Inputs& in, float T, float beta_old,
                         float n_accd, float* sh) {
  const float db = 1.f / T - beta_old;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < in.n; i += kThreads)
    if (in.k_mask[i]) m = nan_max(m, __fmul_rn(db, in.logv_acc[i]));
  m = block_nan_max(m, sh);
  float s = 0.f;
  for (int i = threadIdx.x; i < in.n; i += kThreads)
    s += in.w_acc[i] *
         (in.k_mask[i] ? expf(__fmul_rn(db, in.logv_acc[i]) - m) : 0.f);
  s = block_sum(s, sh);
  const float s_safe = nan_max(s, 1e-38f);
  float q = 0.f;
  for (int i = threadIdx.x; i < in.n; i += kThreads) {
    const float ww =
        in.w_acc[i] *
        (in.k_mask[i] ? expf(__fmul_rn(db, in.logv_acc[i]) - m) : 0.f);
    const float wn = ww / s_safe;
    q += wn * wn;
  }
  q = block_sum(q, sh);
  const float ess = 1.f / nan_max(q, 1e-38f) / n_accd;
  return s > 0.f ? ess : 0.f;
}

// records' weights and diffs into scratch (once per launch)
__device__ void prepare_records(const Inputs& in, float pdf_norm_next,
                                float* sh) {
  float cnt = 0.f;
  for (int i = threadIdx.x; i < in.rec_n; i += kThreads)
    cnt += in.rec_valid[i] ? 1.f : 0.f;
  const float n_valid = block_sum(cnt, sh);
  const float unif = 1.f / fmaxf(n_valid, 1.f);
  float wsum = 0.f;
  for (int i = threadIdx.x; i < in.rec_n; i += kThreads) {
    const bool v = in.rec_valid[i] != 0;
    float w = v ? unif : 0.f;
    if (in.rec_logq != nullptr) {
      const float lw =
          clip_keep_nan(in.logq_new[i] - in.rec_logq[i], -60.f, 60.f);
      w = v ? expf(lw) : 0.f;
      wsum += w;
    }
    in.w_rec[i] = w;
    in.diff_rec[i] = log_value(in.rec_dist[i], in.lin) - pdf_norm_next;
  }
  if (in.rec_logq != nullptr) {
    wsum = block_sum(wsum, sh);  // also the barrier for w_rec
    const float norm = nan_max(wsum, 1e-38f);
    for (int i = threadIdx.x; i < in.rec_n; i += kThreads) {
      const bool v = in.rec_valid[i] != 0;
      in.w_rec[i] = wsum > 0.f ? in.w_rec[i] / norm : (v ? unif : 0.f);
    }
  }
  __syncthreads();
}

// float image of an order-statistic search: the value of rank `r`
__device__ float select_rank(const Inputs& in, int r, float* slot) {
  for (int i = threadIdx.x; i < in.n; i += kThreads) {
    const float xi = in.k_mask[i] ? in.logv_acc[i] : INFINITY;
    const uint32_t ki = order_key(xi);
    int rank = 0;
    for (int j = 0; j < in.n; ++j) {
      const float xj = in.k_mask[j] ? in.logv_acc[j] : INFINITY;
      const uint32_t kj = order_key(xj);
      rank += (kj < ki || (kj == ki && j < i)) ? 1 : 0;
    }
    if (rank == r) *slot = xi;
  }
  __syncthreads();
  const float out = *slot;
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
temperature_update_kernel(Inputs in, const float* __restrict__ pdf_norm_in,
                          const float* __restrict__ max_found_in,
                          const float* __restrict__ daly_k_in,
                          const float* __restrict__ temp_in,
                          const float* __restrict__ acc_rate_in,
                          int n_schemes, const int* __restrict__ codes,
                          const float* __restrict__ params, float t_next,
                          int max_np, int has_pdf_max, float pdf_max,
                          int scaled, float factor, float q_alpha,
                          int calibration, float* __restrict__ out) {
  __shared__ float sh[kWarps + 1];
  __shared__ float s_slot;
  const float pdf_norm = calibration ? -INFINITY : pdf_norm_in[0];
  const float max_found = calibration ? -INFINITY : max_found_in[0];
  const float temp = calibration ? INFINITY : temp_in[0];
  const float daly_k = calibration ? INFINITY : daly_k_in[0];
  const float acc_rate = calibration ? 0.f : acc_rate_in[0];

  // 1. the norm recursion
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < in.n; i += kThreads) {
    const float lv = log_value(in.res_dist[i], in.lin);
    in.logv_acc[i] = lv;
    if (in.k_mask[i]) mx = nan_max(mx, lv);
  }
  mx = block_nan_max(mx, sh);  // also the barrier for logv_acc
  const float max_found_next = nan_max(max_found, mx);
  float pdf_norm_next =
      has_pdf_max ? pdf_max : nan_max(pdf_norm, max_found_next);
  float cnt = 0.f;
  for (int i = threadIdx.x; i < in.n; i += kThreads)
    cnt += in.k_mask[i] ? 1.f : 0.f;
  const int n_acc = (int)block_sum(cnt, sh);
  const int n_accd = n_acc > 1 ? n_acc : 1;
  if (scaled) {
    const float pos = q_alpha * (float)(n_accd - 1);
    const float flo = floorf(pos);
    const int lo = (int)flo, hi = (int)ceilf(pos);
    const float frac = __fsub_rn(pos, flo);
    const float s_lo = select_rank(in, lo, &s_slot);
    const float s_hi = select_rank(in, hi, &s_slot);
    const float quant = __fadd_rn(__fmul_rn(s_lo, __fsub_rn(1.f, frac)),
                                  __fmul_rn(s_hi, frac));
    pdf_norm_next = nan_min(pdf_norm_next, quant + logf(factor));
  }

  // 2. the schemes' proposals
  float temp_next = temp;
  float daly_next = daly_k;
  if (n_schemes > 0) {
    bool records_ready = false, accepted_ready = false;
    float props = INFINITY;
    for (int s = 0; s < n_schemes; ++s) {
      const int code = codes[s];
      const float* p = params + 4 * s;
      float prop = INFINITY;
      if (code == kAcceptanceRate || code == kEss) {
        const bool ar = code == kAcceptanceRate;
        float beta_old = 0.f;
        if (ar && !records_ready) {
          prepare_records(in, pdf_norm_next, sh);
          records_ready = true;
        }
        if (!ar) {
          beta_old = 1.f / temp;
          if (!accepted_ready) {
            float ws = 0.f;
            for (int i = threadIdx.x; i < in.n; i += kThreads)
              ws += in.k_mask[i] ? in.w_norm[i] : 0.f;
            ws = block_sum(ws, sh);
            const float norm = nan_max(ws, 1e-38f);
            for (int i = threadIdx.x; i < in.n; i += kThreads)
              in.w_acc[i] = (in.k_mask[i] ? in.w_norm[i] : 0.f) / norm;
            __syncthreads();
            accepted_ready = true;
          }
        }
        const float target = p[0];
        const float n_f = (float)n_accd;
        float lo = 0.f, hi = 12.f;
        for (int step = 0; step < kSteps; ++step) {
          const float mid = 0.5f * (lo + hi);
          const float T = powf(10.f, mid);
          const float val =
              ar ? rate_at(in, T, sh) : rel_ess(in, T, beta_old, n_f, sh);
          if (val >= target)
            hi = mid;
          else
            lo = mid;
        }
        const float at1 =
            ar ? rate_at(in, 1.f, sh) : rel_ess(in, 1.f, beta_old, n_f, sh);
        prop = at1 >= target ? 1.f : powf(10.f, hi);
      } else if (code == kExpDecayFixedIter || code == kPolyDecayFixedIter) {
        const float t_to_go = (float)max_np - t_next;
        const float frac = (t_to_go - 1.f) / fmaxf(t_to_go, 1.f);
        if (t_to_go <= 1.f)
          prop = 1.f;
        else if (code == kExpDecayFixedIter)
          prop = powf(temp, frac);
        else
          prop = 1.f + (temp - 1.f) * powf(frac, p[0]);
      } else if (code == kExpDecayFixedRatio) {
        const float a0 = p[0], min_r = p[1], max_r = p[2];
        const float a_eff =
            acc_rate < min_r ? sqrtf(a0) : (acc_rate > max_r ? a0 * a0 : a0);
        prop = nan_max(1.f, a_eff * temp);
      } else if (code == kFrielPettitt) {
        const float b = (t_next + 1.f) / (float)max_np;
        prop = 1.f / nan_max(b * b, 1e-12f);
      } else if (code == kDaly) {
        const float alpha = p[0], min_r = p[1];
        daly_next = acc_rate < min_r ? alpha * daly_k
                                     : alpha * nan_min(daly_k, temp);
        prop = nan_max(1.f, temp - daly_next);
      } else if (code == kConstant) {
        prop = p[0];
      }
      if (!isfinite(prop)) prop = INFINITY;
      props = fminf(props, prop);
    }
    const float fallback = calibration ? 1e4f : temp;
    temp_next = isfinite(props) ? props : fallback;
    temp_next = nan_max(nan_min(temp_next, temp), 1.f);
    if (max_np > 0 && t_next >= (float)(max_np - 1)) temp_next = 1.f;
  }
  if (threadIdx.x == 0) {
    out[0] = temp_next;
    out[1] = pdf_norm_next;
    out[2] = max_found_next;
    out[3] = daly_next;
  }
}

}  // namespace

extern "C" int pyabc_temperature_update(
    int rec_n, const float* rec_dist, const uint8_t* rec_valid,
    const float* rec_logq, const float* logq_new, int n,
    const float* res_dist, const uint8_t* k_mask, const float* w_norm,
    const float* pdf_norm, const float* max_found, const float* daly_k,
    const float* temp, const float* acc_rate, int n_schemes,
    const int* codes, const float* params, float t_next, int max_np,
    int has_pdf_max, float pdf_max, int lin, int scaled, float factor,
    float q_alpha, int calibration, float* scratch, float* out,
    void* stream_ptr) {
  if ((rec_logq == nullptr) != (logq_new == nullptr) ||
      (!calibration && (pdf_norm == nullptr || max_found == nullptr ||
                        daly_k == nullptr || temp == nullptr ||
                        acc_rate == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Inputs in{rec_n,     rec_dist, rec_valid, rec_logq,
            logq_new,  n,        res_dist,  k_mask,
            w_norm,    lin,      scratch,   scratch + rec_n,
            scratch + 2 * rec_n, scratch + 2 * rec_n + n};
  temperature_update_kernel<<<1, kThreads, 0, stream>>>(
      in, pdf_norm, max_found, daly_k, temp, acc_rate, n_schemes, codes,
      params, t_next, max_np, has_pdf_max, pdf_max, scaled, factor, q_alpha,
      calibration, out);
  return static_cast<int>(cudaGetLastError());
}
