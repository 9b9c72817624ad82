// K18 segment_round: the simulator call of one proposal round under
// segmented early reject.
//
// Replaces: pyabc_tpu/inference/util.py::DeviceContext._generation_while_seg
// (:787) with ops/segment.py::{select_lanes (:174), gather_lanes (:194)}
// and distance/pnorm.py::PNormDistance.device_bound_fn (:231), for the
// built-in segmented simulators (K19 birth-death, K19 stochastic LV, K20b
// network SIR: the template parameter Step).
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
// seg_ctr (int64, accumulated over a generation's rounds): [0] slots
// retired, [1] segments stepped, [2] slots resolved, [3] lane-segment
// slots the warps executed (32 x the segments of each warp's busiest
// thread), so segment_occupancy = [1] / [3]. The retired rows' unstepped
// statistics are left as they were: nothing reads them.
//
// Bound on an H100: operations (the steps' Philox and log work), as K19;
// the point of the kernel is to do fewer of them. A slot's noise is keyed
// by the slot, so which thread runs a slot changes no number; only [3]
// depends on the schedule.
#include <cooperative_groups.h>

#include "network_sir.cuh"
#include "tau_leap.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;

struct Bound {
  const float* x0;
  const float* w;
  float p;
  float lim;  // (thr (1 + rtol))^p, or thr (1 + rtol) at p = inf

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

__device__ __forceinline__ float bound_limit(float thr, float p) {
  const float t = __fmul_rn(thr, 1.0001f);
  if (isinf(p) || p == 1.f) return t;
  if (p == 2.f) return __fmul_rn(t, t);
  return powf(t, p);
}

template <class Step>
__global__ void __launch_bounds__(kThreads)
segment_round_kernel(pyabc::SegModel m, const float* __restrict__ theta,
                     int stride, const uint8_t* __restrict__ valid, int B,
                     const int* __restrict__ imap,
                     const float* __restrict__ x0,
                     const float* __restrict__ w, float p,
                     const float* __restrict__ eps,
                     const float* __restrict__ hist_min, int S,
                     float* __restrict__ ss, uint8_t* __restrict__ keep,
                     int* __restrict__ next_slot,
                     unsigned long long* __restrict__ seg_ctr, uint32_t k0,
                     uint32_t k1, uint32_t gen, uint32_t tag,
                     uint32_t max_rounds, const int* __restrict__ counters) {
  float thr = eps[0];
  if (hist_min != nullptr) thr = fminf(thr, hist_min[0]);
  const Bound bound{x0, w, p, bound_limit(thr, p)};
  const uint32_t round = (uint32_t)counters[1];
  const int n_seg = m.n_seg, seg_size = m.seg_size;
  float vals[Step::kMaxSeg];
  typename Step::State st;
  pyabc::PhiloxLane rng{};
  int slot = -1, seg = 0;
  bool ok = false;
  float acc = 0.f;
  unsigned steps = 0, retired = 0, resolved = 0;
  while (true) {
    if (slot < 0) {
      // the threads that need a slot take the next ones in lane order
      cg::coalesced_group g = cg::coalesced_threads();
      int base = 0;
      if (g.thread_rank() == 0) base = atomicAdd(next_slot, (int)g.size());
      slot = g.shfl(base, 0) + (int)g.thread_rank();
      if (slot >= B) break;
      Step::init(m, theta + (size_t)slot * stride, nullptr, st);
      rng = pyabc::philox_lane(k0, k1, (uint32_t)slot, gen, tag, max_rounds,
                               round);
      ok = valid[slot] != 0;
      seg = 0;
      acc = 0.f;
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
      ++resolved;
      slot = -1;
    } else if (!ok || acc > bound.lim) {
      keep[slot] = 0;
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

template <class Step>
int launch(const pyabc::SegModel& m, int threads, const float* theta,
           int stride, const uint8_t* valid, int B, const int* imap,
           const float* x0, const float* w, float p, const float* eps,
           const float* hist_min, int S, float* ss, uint8_t* keep,
           int* next_slot, unsigned long long* seg_ctr, unsigned k0,
           unsigned k1, unsigned gen, unsigned tag, unsigned max_rounds,
           const int* counters, cudaStream_t stream) {
  if (m.seg_size > Step::kMaxSeg) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(next_slot, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (threads + kThreads - 1) / kThreads;
  segment_round_kernel<Step><<<grid, kThreads, 0, stream>>>(
      m, theta, stride, valid, B, imap, x0, w, p, eps, hist_min, S, ss, keep,
      next_slot, seg_ctr, k0, k1, gen, tag, max_rounds, counters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pyabc_segment_round(
    const pyabc::SegModel* model, int threads, const float* theta,
    int stride, const uint8_t* valid, int B, const int* imap,
    const float* x0, const float* w, float p, const float* eps,
    const float* hist_min, int S, float* ss, uint8_t* keep, int* next_slot,
    unsigned long long* seg_ctr, unsigned k0, unsigned k1, unsigned gen,
    unsigned tag, unsigned max_rounds, const int* counters,
    void* stream_ptr) {
  if (B <= 0) return 0;
  if (model == nullptr || counters == nullptr || threads <= 0 ||
      model->n_seg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const pyabc::SegModel m = *model;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define PYABC_SEG_LAUNCH(STEP)                                              \
  launch<STEP>(m, threads, theta, stride, valid, B, imap, x0, w, p, eps,    \
               hist_min, S, ss, keep, next_slot, seg_ctr, k0, k1, gen, tag, \
               max_rounds, counters, stream)
  if (m.kind == pyabc::kTauLeapBirthDeath)
    return PYABC_SEG_LAUNCH(pyabc::TauLeapStep<pyabc::BirthDeath>);
  if (m.kind == pyabc::kTauLeapLV)
    return PYABC_SEG_LAUNCH(pyabc::TauLeapStep<pyabc::StochasticLV>);
  if (m.kind == pyabc::kNetworkSir)
    return PYABC_SEG_LAUNCH(pyabc::NetworkSirStep);
#undef PYABC_SEG_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
