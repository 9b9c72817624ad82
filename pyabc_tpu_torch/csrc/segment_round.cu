// K18 segment_round: the simulator call of one proposal round under
// segmented early reject.
//
// Replaces: pyabc_tpu/inference/util.py::DeviceContext._generation_while_seg
// (:787) with ops/segment.py::{select_lanes (:174), gather_lanes (:194)}
// and distance/pnorm.py::PNormDistance.device_bound_fn (:231), for the
// built-in segmented simulators (K19 birth-death, K19 stochastic LV, K20b
// network SIR, K20b's segmented ODE family: the template parameter Step),
// with the model switch of util.py:774-785 when K > 1.
//
// K2 and K3 propose the round's B slots as in a classic round; this kernel
// takes the simulator's place. T threads (T <= B) share the slots through
// a device counter: a thread takes the next slots (warp-aggregated
// atomicAdd), steps its slot one segment at a time, writes each emitted
// value to ss[slot, index_map[seg, k]] and folds it into the slot's prefix
// bound in emission order: per segment the p-th-power sum of
// (w |v - x0|)^p over k in order (p = inf: the running max, NaN kept),
// then acc += that sum. After a segment that is not the last, the slot
// retires when its proposal is invalid or when acc exceeds the threshold
// with the relative slack 1e-4, compared in the p-th-power domain
// (acc > (thr (1 + 1e-4))^p with thr = eps, or min(eps, hist_min) under
// use_complete_history); a retiring thread takes the next slot, so the
// work a retirement frees goes to another candidate. A slot that runs all
// segments is complete: keep[slot] = valid[slot]. K5 then tests
// complete slots exactly on their full statistics (keep is its valid
// mask) and K6 counts every valid slot as evaluated, so a round resolves
// all B slots as a classic round does, and the accepted rows, the rounds
// and n_valid equal the classic path's.
//
// Modes. K > 1: m (B,) holds each slot's model (K2's K > 1 mode) and the
// slot steps with descriptor models[m[slot]] of the K given, all of one
// kind (the uniform protocol fixes n_seg, seg_size and the layout); K = 1
// passes m = nullptr. Adaptive: nseg (B,), when given, receives the
// segments each slot simulated (n_seg for a completed slot, the retiring
// segment + 1 for a retired one), which K22's fold (moments.cu) reads to
// take a retired slot's prefix columns; the fold runs after this kernel
// in the same stream, so the sums do not depend on which thread ran which
// slot.
//
// seg_ctr (int64, accumulated over a generation's rounds): [0] slots
// retired, [1] segments stepped, [2] slots resolved, [3] lane-segment
// slots the warps executed (32 x the segments of each warp's busiest
// thread), so segment_occupancy = [1] / [3]. The retired rows' unstepped
// statistics are left as they were: nothing reads them.
//
// Noisy mode (a StochasticAcceptor, K = 1; util.py:1115-1134): the Bound
// template parameter is NoiseBound, an UPPER bound on the noise kernel's
// log-density (noise.cuh: the independent normal and Laplace start at
// their pdf_max and subtract each entry's deficit, log-scale binomial and
// Poisson start at 0 and add their log-pmfs). Slot s's threshold is
// thr_s = pdf_norm + T log(u_s), u_s the very uniform K21a draws for that
// row (word 0 of block 0 of philox_lane(accept key, s, gen, ACCEPT,
// max_rounds, round)); the slot retires when acc < thr_s - (1e-3 + 1e-4
// |acc|) (_upper_exceeds), so only a slot whose already-drawn accept test
// cannot pass retires. T = +inf (the calibration) or u_s = 0 never
// retires: an explicit branch, not inf * 0 arithmetic. T and pdf_norm are
// device scalars. The p-norm's lower bound is the other Bound, PNormBound.
//
// Aggregate mode (an AggregatedDistance of n <= 8 plain p-norms, K25's
// params [W (n), w_1 (S), ..., w_n (S)]; aggregate.py:85): the Bound is
// AggBound, whose accumulator holds n per-sub prefix bounds, each folded
// as PNormBound folds its one (per segment the p_k-th-power sum in
// emission order, then added; p_k = inf the running max). The slot retires
// when sum_k W_k acc_k^(1/p_k) (k in order, each step _rn; sqrt at p = 2)
// exceeds thr (1 + 1e-4): sound while every W_k and w_k is >= 0, which
// the host gate checks.
//
// Transformed mode (a fitted linear learned statistic under a plain
// PNormDistance(p = 2); pyabc_tpu/ops/fit.py::linear_bound_fns :240 via
// distance/pnorm.py::_transformed_bound_fn :279): the Bound is LinBound,
// whose accumulator is the C' (<= 8) partial transformed difference v and
// the segments folded. Each segment adds (v_k - x0[c_k]) At[c_k, :] over
// its values in emission order (a segment's sum first, then added, each
// step _rn), At the (S, C') coefficient rows linear_bound.cu prepares once
// a generation; the slot retires when v^T P_j v (P_j the suffix Gram's
// null-space projector after j segments, j clamped to n_seg; the inner
// sums in order) exceeds (thr (1 + 1e-4))^2. Exact as a bound: while the
// remaining rows of At span the C' space P_j = 0 and nothing retires.
//
// Bound on an H100: operations (the steps' Philox and log work), as K19;
// the point of the kernel is to do fewer of them. A slot's noise is keyed
// by the slot, so which thread runs a slot changes no number; only [3]
// depends on the schedule.
#include <cooperative_groups.h>

#include "network_sir.cuh"
#include "noise.cuh"
#include "ode_family.cuh"
#include "tau_leap.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
using pyabc::kMaxModels;
using pyabc::SegModels;

// the p-norm's lower bound: (w |v - x0|)^p summed per segment (p = inf:
// the running max), retired above lim = (thr (1 + rtol))^p
struct PNormBound {
  using Acc = float;
  const float* x0;
  const float* w;
  float p;
  float lim;  // (thr (1 + rtol))^p, or thr (1 + rtol) at p = inf

  __device__ float init() const { return 0.f; }
  __device__ float threshold(uint32_t /*slot*/, uint32_t /*round*/) const {
    return lim;
  }
  __device__ bool exceeds(float acc, float thr) const { return acc > thr; }

  // fold one segment's values (emission order) into acc
  __device__ float fold(float acc, const float* vals, const int* cols,
                        int n) const {
    if (isinf(p)) {
      for (int k = 0; k < n; ++k) {
        const int c = cols[k];
        acc = nan_max(acc, __fmul_rn(w[c], fabsf(__fsub_rn(vals[k], x0[c]))));
      }
      return acc;
    }
    float s = 0.f;
    for (int k = 0; k < n; ++k) {
      const int c = cols[k];
      const float d = __fmul_rn(w[c], fabsf(__fsub_rn(vals[k], x0[c])));
      const float t = p == 1.f ? d : p == 2.f ? __fmul_rn(d, d) : powf(d, p);
      s = __fadd_rn(s, t);
    }
    return __fadd_rn(acc, s);
  }
};

// the accept stream K21a draws each row's uniform from
struct AcceptStream {
  uint32_t k0, k1, gen, tag, max_rounds;
};

// the noise kernel's upper bound on the log-density (noise.cuh), retired
// against each slot's pre-committed threshold
struct NoiseBound {
  using Acc = float;
  const float* x0;
  const float* par;  // the column's variance, Laplace b or binomial p
  int family;
  float init_value;  // pdf_max (normal, Laplace) or 0 (binomial, Poisson)
  float temp, pdf_norm;
  AcceptStream acc_stream;

  __device__ float init() const { return init_value; }
  __device__ float threshold(uint32_t slot, uint32_t round) const {
    if (!isfinite(temp)) return -INFINITY;  // T = +inf: never retires
    const float u = pyabc::philox_lane(acc_stream.k0, acc_stream.k1, slot,
                                       acc_stream.gen, acc_stream.tag,
                                       acc_stream.max_rounds, round)
                        .uniform(0, 0);
    if (u == 0.f) return -INFINITY;  // certainly accepted: never retires
    return __fadd_rn(pdf_norm, __fmul_rn(temp, logf(u)));
  }
  __device__ bool exceeds(float acc, float thr) const {
    return pyabc::upper_exceeds(acc, thr);
  }
  __device__ float fold(float acc, const float* vals, const int* cols,
                        int n) const {
    float s = 0.f;
    for (int k = 0; k < n; ++k) {
      const int c = cols[k];
      s = __fadd_rn(s, pyabc::bound_entry(family, vals[k], x0[c], par[c]));
    }
    return pyabc::bound_update(family, acc, s);
  }
};

// the aggregated distance's lower bound: n per-sub accumulators
constexpr int kMaxSub = 8;
enum AggP { kAggP1 = 0, kAggP2 = 1, kAggPInf = 2, kAggPGen = 3 };

struct AggAcc {
  float a[kMaxSub];
};

struct AggBound {
  using Acc = AggAcc;
  const float* x0;
  const float* subw;  // w_1 (S), ..., w_n (S)
  int S, n;
  int code[kMaxSub];
  float p[kMaxSub];
  float W[kMaxSub];
  float lim;  // thr (1 + rtol)

  __device__ AggAcc init() const {
    AggAcc acc;
#pragma unroll
    for (int j = 0; j < kMaxSub; ++j) acc.a[j] = 0.f;
    return acc;
  }
  __device__ float threshold(uint32_t /*slot*/, uint32_t /*round*/) const {
    return lim;
  }
  __device__ bool exceeds(const AggAcc& acc, float thr) const {
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSub; ++j) {
      if (j >= n) break;
      const float a = acc.a[j];
      const float r = code[j] == kAggP2     ? __fsqrt_rn(a)
                      : code[j] == kAggPGen ? powf(a, 1.f / p[j])
                                            : a;
      total = __fadd_rn(total, __fmul_rn(W[j], r));
    }
    return total > thr;
  }
  __device__ AggAcc fold(AggAcc acc, const float* vals, const int* cols,
                         int m) const {
#pragma unroll
    for (int j = 0; j < kMaxSub; ++j) {
      if (j >= n) break;
      const float* w = subw + (size_t)j * S;
      if (code[j] == kAggPInf) {
        for (int k = 0; k < m; ++k) {
          const int c = cols[k];
          acc.a[j] = nan_max(acc.a[j],
                             __fmul_rn(w[c], fabsf(__fsub_rn(vals[k], x0[c]))));
        }
        continue;
      }
      float s = 0.f;
      for (int k = 0; k < m; ++k) {
        const int c = cols[k];
        const float d = __fmul_rn(w[c], fabsf(__fsub_rn(vals[k], x0[c])));
        const float t = code[j] == kAggP1   ? d
                        : code[j] == kAggP2 ? __fmul_rn(d, d)
                                            : powf(d, p[j]);
        s = __fadd_rn(s, t);
      }
      acc.a[j] = __fadd_rn(acc.a[j], s);
    }
    return acc;
  }
};

// the transformed-space bound of a fitted linear learned statistic (p = 2)
constexpr int kMaxLin = 8;

struct LinAcc {
  float v[kMaxLin];
  int n;  // segments folded
};

struct LinBound {
  using Acc = LinAcc;
  const float* x0;
  const float* At;    // (S, C)
  const float* proj;  // (n_proj, C, C)
  int C, n_proj;
  float lim;  // (thr (1 + rtol))^2

  __device__ LinAcc init() const {
    LinAcc acc;
#pragma unroll
    for (int a = 0; a < kMaxLin; ++a) acc.v[a] = 0.f;
    acc.n = 0;
    return acc;
  }
  __device__ float threshold(uint32_t /*slot*/, uint32_t /*round*/) const {
    return lim;
  }
  __device__ bool exceeds(const LinAcc& acc, float thr) const {
    const int j = min(max(acc.n, 0), n_proj - 1);
    const float* P = proj + (size_t)j * C * C;
    float q = 0.f;
#pragma unroll
    for (int a = 0; a < kMaxLin; ++a) {
      if (a >= C) break;
      float pv = 0.f;
#pragma unroll
      for (int b = 0; b < kMaxLin; ++b) {
        if (b >= C) break;
        pv = __fadd_rn(pv, __fmul_rn(P[a * C + b], acc.v[b]));
      }
      q = __fadd_rn(q, __fmul_rn(acc.v[a], pv));
    }
    return q > thr;
  }
  __device__ LinAcc fold(LinAcc acc, const float* vals, const int* cols,
                         int m) const {
    float contrib[kMaxLin];
#pragma unroll
    for (int a = 0; a < kMaxLin; ++a) contrib[a] = 0.f;
    for (int k = 0; k < m; ++k) {
      const int c = cols[k];
      const float diff = __fsub_rn(vals[k], x0[c]);
#pragma unroll
      for (int a = 0; a < kMaxLin; ++a) {
        if (a >= C) break;
        contrib[a] = __fadd_rn(contrib[a], __fmul_rn(diff, At[c * C + a]));
      }
    }
#pragma unroll
    for (int a = 0; a < kMaxLin; ++a) {
      if (a >= C) break;
      acc.v[a] = __fadd_rn(acc.v[a], contrib[a]);
    }
    acc.n += 1;
    return acc;
  }
};

// what either bound reads, passed by value; each Bound builds itself from
// it on the device (the thresholds are device scalars)
struct BoundArgs {
  const float* x0;
  const float* w;         // p-norm weights, or the noise columns' params
  float p;
  const float* eps;       // p-norm threshold, or the temperature T
  const float* hist_min;  // use_complete_history's minimum (p-norm)
  int noise_family;       // -1: the p-norm bound
  float noise_init;
  const float* pdf_norm;
  AcceptStream acc_stream;
  int width;        // S (the aggregate's sub weights' stride)
  int agg_n;        // > 0: the aggregate bound over agg_n sub-distances
  int agg_code[kMaxSub];
  float agg_p[kMaxSub];
  int lin_c;              // > 0: the transformed bound (w is At (S, lin_c))
  const float* lin_proj;  // (n_seg + 1, lin_c, lin_c)
  int lin_nproj;
};

__device__ __forceinline__ float bound_limit(float thr, float p) {
  const float t = __fmul_rn(thr, 1.0001f);
  if (isinf(p) || p == 1.f) return t;
  if (p == 2.f) return __fmul_rn(t, t);
  return powf(t, p);
}

__device__ __forceinline__ PNormBound make_bound(const BoundArgs& a,
                                                 PNormBound*) {
  float thr = a.eps[0];
  if (a.hist_min != nullptr) thr = fminf(thr, a.hist_min[0]);
  return PNormBound{a.x0, a.w, a.p, bound_limit(thr, a.p)};
}

__device__ __forceinline__ AggBound make_bound(const BoundArgs& a,
                                               AggBound*) {
  float thr = a.eps[0];
  if (a.hist_min != nullptr) thr = fminf(thr, a.hist_min[0]);
  AggBound b{};
  b.x0 = a.x0;
  b.subw = a.w + a.agg_n;
  b.S = a.width;
  b.n = a.agg_n;
#pragma unroll
  for (int j = 0; j < kMaxSub; ++j) {
    b.code[j] = a.agg_code[j];
    b.p[j] = a.agg_p[j];
    b.W[j] = j < a.agg_n ? a.w[j] : 0.f;
  }
  b.lim = __fmul_rn(thr, 1.0001f);
  return b;
}

__device__ __forceinline__ LinBound make_bound(const BoundArgs& a,
                                               LinBound*) {
  float thr = a.eps[0];
  if (a.hist_min != nullptr) thr = fminf(thr, a.hist_min[0]);
  return LinBound{a.x0,    a.w,           a.lin_proj,
                  a.lin_c, a.lin_nproj,   bound_limit(thr, 2.f)};
}

__device__ __forceinline__ NoiseBound make_bound(const BoundArgs& a,
                                                 NoiseBound*) {
  return NoiseBound{a.x0,     a.w,           a.noise_family, a.noise_init,
                    a.eps[0], a.pdf_norm[0], a.acc_stream};
}

template <class Step, class Bound>
__global__ void __launch_bounds__(kThreads)
segment_round_kernel(SegModels models, int K,
                     const int* __restrict__ m_lane,
                     const float* __restrict__ theta,
                     int stride, const uint8_t* __restrict__ valid, int B,
                     const int* __restrict__ imap, BoundArgs bargs, int S,
                     float* __restrict__ ss, uint8_t* __restrict__ keep,
                     int* __restrict__ nseg, int* __restrict__ next_slot,
                     unsigned long long* __restrict__ seg_ctr, uint32_t k0,
                     uint32_t k1, uint32_t gen, uint32_t tag,
                     uint32_t max_rounds, const int* __restrict__ counters) {
  const Bound bound = make_bound(bargs, static_cast<Bound*>(nullptr));
  const uint32_t round = (uint32_t)counters[1];
  const int n_seg = models.m[0].n_seg, seg_size = models.m[0].seg_size;
  float vals[Step::kMaxSeg];
  typename Step::State st;
  pyabc::PhiloxLane rng{};
  pyabc::SegModel m = models.m[0];
  int slot = -1, seg = 0;
  bool ok = false;
  typename Bound::Acc acc = bound.init();
  float thr = 0.f;
  unsigned steps = 0, retired = 0, resolved = 0;
  while (true) {
    if (slot < 0) {
      // the threads that need a slot take the next ones in lane order
      cg::coalesced_group g = cg::coalesced_threads();
      int base = 0;
      if (g.thread_rank() == 0) base = atomicAdd(next_slot, (int)g.size());
      slot = g.shfl(base, 0) + (int)g.thread_rank();
      if (slot >= B) break;
      if (m_lane != nullptr)
        m = models.m[min(max(m_lane[slot], 0), K - 1)];
      Step::init(m, theta + (size_t)slot * stride, nullptr, st);
      rng = pyabc::philox_lane(k0, k1, (uint32_t)slot, gen, tag, max_rounds,
                               round);
      ok = valid[slot] != 0;
      seg = 0;
      acc = bound.init();
      thr = bound.threshold((uint32_t)slot, round);
    }
    float* row = ss + (size_t)slot * S;
    const int* cols = imap + (size_t)seg * seg_size;
    Step::step(m, rng, st, seg, [&](int k, float v) {
      vals[k] = v;
      row[cols[k]] = v;
    });
    acc = bound.fold(acc, vals, cols, seg_size);
    ++seg;
    ++steps;
    if (seg >= n_seg) {
      keep[slot] = ok ? 1 : 0;
      if (nseg != nullptr) nseg[slot] = seg;
      ++resolved;
      slot = -1;
    } else if (!ok || bound.exceeds(acc, thr)) {
      keep[slot] = 0;
      if (nseg != nullptr) nseg[slot] = seg;
      ++retired;
      ++resolved;
      slot = -1;
    }
  }
  __syncwarp();
  const unsigned s_sum = __reduce_add_sync(0xffffffffu, steps);
  const unsigned s_max = __reduce_max_sync(0xffffffffu, steps);
  const unsigned r_sum = __reduce_add_sync(0xffffffffu, retired);
  const unsigned v_sum = __reduce_add_sync(0xffffffffu, resolved);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(seg_ctr + 0, (unsigned long long)r_sum);
    atomicAdd(seg_ctr + 1, (unsigned long long)s_sum);
    atomicAdd(seg_ctr + 2, (unsigned long long)v_sum);
    atomicAdd(seg_ctr + 3, 32ull * s_max);
  }
}

template <class Step, class Bound>
int launch(const SegModels& ms, int K, const int* m_lane, int threads,
           const float* theta, int stride, const uint8_t* valid, int B,
           const int* imap, const BoundArgs& bargs, int S, float* ss,
           uint8_t* keep, int* nseg, int* next_slot,
           unsigned long long* seg_ctr, unsigned k0, unsigned k1,
           unsigned gen, unsigned tag, unsigned max_rounds,
           const int* counters, cudaStream_t stream) {
  if (ms.m[0].seg_size > Step::kMaxSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(next_slot, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (threads + kThreads - 1) / kThreads;
  segment_round_kernel<Step, Bound><<<grid, kThreads, 0, stream>>>(
      ms, K, m_lane, theta, stride, valid, B, imap, bargs, S, ss, keep, nseg,
      next_slot, seg_ctr, k0, k1, gen, tag, max_rounds, counters);
  return static_cast<int>(cudaGetLastError());
}

template <class Step>
int launch_bound(const SegModels& ms, int K, const int* m_lane, int threads,
                 const float* theta, int stride, const uint8_t* valid, int B,
                 const int* imap, const BoundArgs& bargs, int S, float* ss,
                 uint8_t* keep, int* nseg, int* next_slot,
                 unsigned long long* seg_ctr, unsigned k0, unsigned k1,
                 unsigned gen, unsigned tag, unsigned max_rounds,
                 const int* counters, cudaStream_t stream) {
  if (bargs.lin_c > 0)
    return launch<Step, LinBound>(ms, K, m_lane, threads, theta, stride,
                                  valid, B, imap, bargs, S, ss, keep, nseg,
                                  next_slot, seg_ctr, k0, k1, gen, tag,
                                  max_rounds, counters, stream);
  if (bargs.agg_n > 0)
    return launch<Step, AggBound>(ms, K, m_lane, threads, theta, stride,
                                  valid, B, imap, bargs, S, ss, keep, nseg,
                                  next_slot, seg_ctr, k0, k1, gen, tag,
                                  max_rounds, counters, stream);
  if (bargs.noise_family < 0)
    return launch<Step, PNormBound>(ms, K, m_lane, threads, theta, stride,
                                    valid, B, imap, bargs, S, ss, keep, nseg,
                                    next_slot, seg_ctr, k0, k1, gen, tag,
                                    max_rounds, counters, stream);
  return launch<Step, NoiseBound>(ms, K, m_lane, threads, theta, stride,
                                  valid, B, imap, bargs, S, ss, keep, nseg,
                                  next_slot, seg_ctr, k0, k1, gen, tag,
                                  max_rounds, counters, stream);
}

}  // namespace

// models: K descriptors of one kind; m: the slots' models (nullptr: K = 1);
// nseg: nullptr, or (B,) for the segments each slot simulated.
// noise_family < 0: the p-norm bound (w the weights, eps the threshold);
// else the noisy mode (K = 1): w the noise columns' params, eps the
// temperature, pdf_norm the norm and a* the accept stream. agg_n > 0: the
// aggregate bound (noise_family < 0; w K25's params, agg_codes and agg_ps
// host arrays of agg_n). lin_c > 0: the transformed bound (noise_family <
// 0, agg_n 0, p 2; w the (S, lin_c) rows At, lin_proj the (n_seg + 1,
// lin_c, lin_c) projectors).
extern "C" int pyabc_segment_round(
    const pyabc::SegModel* models, int K, const int* m, int threads,
    const float* theta, int stride, const uint8_t* valid, int B,
    const int* imap, const float* x0, const float* w, float p,
    const float* eps, const float* hist_min, int S, float* ss,
    uint8_t* keep, int* nseg, int* next_slot, unsigned long long* seg_ctr,
    unsigned k0, unsigned k1, unsigned gen, unsigned tag,
    unsigned max_rounds, const int* counters, int noise_family,
    float noise_init, const float* pdf_norm, unsigned ak0, unsigned ak1,
    unsigned agen, unsigned atag, int agg_n, const int* agg_codes,
    const float* agg_ps, int lin_c, const float* lin_proj,
    void* stream_ptr) {
  if (B <= 0) return 0;
  if (models == nullptr || counters == nullptr || threads <= 0 || K < 1 ||
      K > kMaxModels || (K > 1 && m == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (noise_family >= 0 &&
      (K != 1 || pdf_norm == nullptr ||
       noise_family > pyabc::kNoisePoisson))
    return static_cast<int>(cudaErrorInvalidValue);
  if (agg_n < 0 || agg_n > kMaxSub ||
      (agg_n > 0 && (noise_family >= 0 || agg_codes == nullptr ||
                     agg_ps == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lin_c < 0 || lin_c > kMaxLin ||
      (lin_c > 0 && (noise_family >= 0 || agg_n > 0 || lin_proj == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  SegModels ms{};
  for (int k = 0; k < K; ++k) {
    ms.m[k] = models[k];
    if (ms.m[k].kind != ms.m[0].kind || ms.m[k].n_seg != ms.m[0].n_seg ||
        ms.m[k].seg_size != ms.m[0].seg_size || ms.m[k].n_seg < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  BoundArgs bargs{x0,           w,          p,
                  eps,          hist_min,   noise_family,
                  noise_init,   pdf_norm,
                  AcceptStream{ak0, ak1, agen, atag, max_rounds},
                  S,            agg_n,      {},
                  {},           lin_c,      lin_proj,
                  ms.m[0].n_seg + 1};
  for (int j = 0; j < agg_n; ++j) {
    if (agg_codes[j] < kAggP1 || agg_codes[j] > kAggPGen)
      return static_cast<int>(cudaErrorInvalidValue);
    bargs.agg_code[j] = agg_codes[j];
    bargs.agg_p[j] = agg_ps[j];
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define PYABC_SEG_LAUNCH(STEP)                                              \
  launch_bound<STEP>(ms, K, m, threads, theta, stride, valid, B, imap,      \
                     bargs, S, ss, keep, nseg, next_slot, seg_ctr, k0, k1,  \
                     gen, tag, max_rounds, counters, stream)
  const int kind = ms.m[0].kind;
  if (kind == pyabc::kTauLeapBirthDeath)
    return PYABC_SEG_LAUNCH(pyabc::TauLeapStep<pyabc::BirthDeath>);
  if (kind == pyabc::kTauLeapLV)
    return PYABC_SEG_LAUNCH(pyabc::TauLeapStep<pyabc::StochasticLV>);
  if (kind == pyabc::kNetworkSir)
    return PYABC_SEG_LAUNCH(pyabc::NetworkSirStep);
  if (kind == pyabc::kOdeFamily)
    return PYABC_SEG_LAUNCH(pyabc::OdeFamilyStep);
#undef PYABC_SEG_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
