// K19 tau_leap: Poisson tau leaping of one proposal round, over a range of
// segments.
//
// Replaces: pyabc_tpu/models/gillespie.py::tau_leap (:35) and
// tau_leap_segmented (:102) under vmap (make_birth_death_model,
// make_stochastic_lv_model), with jax.random.poisson (the sampler in
// philox.cuh).
//
// Entry: (carry, theta, seg_from, seg_to) -> the statistics of those
// segments. Lane b starts from x_in[b] (a carried state) or from x0, steps
// segments seg_from .. seg_to - 1 with TauLeapStep::step (tau_leap.cuh),
// writes emitted value k of segment j to out[b, colmap[(j - seg_from) *
// seg_size + k]] (the classic path passes the whole range and the spec's
// index map, so the row lands in flat sum-stat order) and, if x_out is
// given, its final state. K18 calls the same step one segment at a time.
//
// Lane base: lane0 is the global number of the launch's first lane, and
// lane b draws on Philox lane lane0 + b, so a device mesh rank's launch over
// the lanes [lane0, lane0 + B) gives exactly those rows of the whole round.
//
// Bound on an H100: operations, and latency before that. A lane is a chain
// of n_leaps dependent leaps (200 birth-death, 300 stochastic LV), each
// with one Philox block (ten rounds of 32-bit multiplies) per four
// uniforms, a log per Knuth iteration and a log and an lgamma per PTRS
// attempt; the bytes (theta in, S floats out) are tiny. One thread per
// lane, the state and rates in registers.
#include "tau_leap.cuh"

namespace {

constexpr int kThreads = 128;

template <class M>
__global__ void __launch_bounds__(kThreads)
tau_leap_kernel(pyabc::SegModel m, const float* __restrict__ theta, int B,
                int stride, const float* __restrict__ x_in,
                float* __restrict__ x_out, int seg_from, int seg_to,
                const int* __restrict__ colmap, int width,
                float* __restrict__ out, uint32_t k0, uint32_t k1,
                uint32_t gen, uint32_t tag, uint32_t max_rounds,
                uint32_t lane0, const int* __restrict__ counters) {
  using Step = pyabc::TauLeapStep<M>;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  typename Step::State st;
  Step::init(m, theta + (size_t)b * stride,
             x_in != nullptr ? x_in + (size_t)b * M::NS : nullptr, st);
  const pyabc::PhiloxLane rng = pyabc::philox_lane(
      k0, k1, lane0 + (uint32_t)b, gen, tag, max_rounds,
      (uint32_t)counters[1]);
  float* row = out + (size_t)b * width;
  for (int seg = seg_from; seg < seg_to; ++seg) {
    const int* cols = colmap + (size_t)(seg - seg_from) * m.seg_size;
    Step::step(m, rng, st, seg, [&](int k, float v) { row[cols[k]] = v; });
  }
  if (x_out != nullptr) Step::store(st, x_out + (size_t)b * M::NS);
}

}  // namespace

extern "C" int pyabc_tau_leap(const pyabc::SegModel* model,
                              const float* theta, int B, int stride,
                              const float* x_in, float* x_out, int seg_from,
                              int seg_to, const int* colmap, int width,
                              float* out, unsigned k0, unsigned k1,
                              unsigned gen, unsigned tag, unsigned max_rounds,
                              unsigned lane0, const int* counters,
                              void* stream_ptr) {
  if (B <= 0 || seg_to <= seg_from) return 0;
  if (model == nullptr || counters == nullptr || colmap == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const pyabc::SegModel m = *model;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = (B + kThreads - 1) / kThreads;
  if (m.kind == pyabc::kTauLeapBirthDeath)
    tau_leap_kernel<pyabc::BirthDeath><<<grid, kThreads, 0, stream>>>(
        m, theta, B, stride, x_in, x_out, seg_from, seg_to, colmap, width,
        out, k0, k1, gen, tag, max_rounds, lane0, counters);
  else if (m.kind == pyabc::kTauLeapLV)
    tau_leap_kernel<pyabc::StochasticLV><<<grid, kThreads, 0, stream>>>(
        m, theta, B, stride, x_in, x_out, seg_from, seg_to, colmap, width,
        out, k0, k1, gen, tag, max_rounds, lane0, counters);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
