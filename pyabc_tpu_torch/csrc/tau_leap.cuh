// K19's step: one segment of Poisson tau leaping for one lane.
//
// Replaces the per-lane body of pyabc_tpu/models/gillespie.py::tau_leap
// (:35) and tau_leap_segmented (:102). Per leap: propensities a =
// max(prop(x, rates), 0) (NaN kept); in the midpoint variant x_mid =
// max(x + (0.5 tau a) . stoich, 0) and a = max(prop(x_mid), 0); then one
// Poisson count per channel of rate a * tau (philox.cuh::poisson, draw
// number leap * n_channels + channel on the simulator-noise stream: keyed
// by the slot, the leap and the channel, never by the segment), and
// x = max(x + n . stoich, 0). Every save_every-th state is emitted: per
// segment, for each emitted channel in layout order, its obs_per_seg saved
// values (emission index channel * obs_per_seg + o). The sums over the
// channels run in channel order from 0, zero stoichiometry included (so
// 0 * inf is NaN as in JAX's matrix product). A lane whose state or rate
// overflows float32 ends with non-finite statistics, and each draw stops at
// the sampler's cap, so no lane loops without end.
#pragma once

#include "seg_model.cuh"

namespace pyabc {

// Birth-death: 0 ->(b) X, X ->(d) 0; theta = (log10 b, log10 d).
struct BirthDeath {
  static constexpr int NS = 1, NC = 2, NE = 1, NT = 2;
  __device__ static float stoich(int c, int) { return c == 0 ? 1.f : -1.f; }
  __device__ static int emitted(int) { return 0; }
  __device__ static void prop(const float* x, const float* r, float* a) {
    a[0] = r[0];
    a[1] = __fmul_rn(r[1], x[0]);
  }
};

// Stochastic Lotka-Volterra: prey birth, predation, predator death;
// x = (prey, pred), theta = log10 of the three rates; emits (pred, prey).
struct StochasticLV {
  static constexpr int NS = 2, NC = 3, NE = 2, NT = 3;
  __device__ static float stoich(int c, int s) {
    // ((1, 0), (-1, 1), (0, -1))
    return c == 0 ? (s == 0 ? 1.f : 0.f)
                  : c == 1 ? (s == 0 ? -1.f : 1.f) : (s == 0 ? 0.f : -1.f);
  }
  __device__ static int emitted(int e) { return e == 0 ? 1 : 0; }
  __device__ static void prop(const float* x, const float* r, float* a) {
    a[0] = __fmul_rn(r[0], x[0]);
    a[1] = __fmul_rn(__fmul_rn(r[1], x[0]), x[1]);
    a[2] = __fmul_rn(r[2], x[1]);
  }
};

template <class M>
struct TauLeapStep {
  static constexpr int kMaxSeg = 64;
  struct State {
    float x[M::NS];
    float r[M::NC];
  };

  // rates = 10 ** theta[:NT]; x from x_in (a carried state) or x0
  __device__ static void init(const SegModel& m, const float* th,
                              const float* x_in, State& st) {
#pragma unroll
    for (int c = 0; c < M::NC; ++c) st.r[c] = powf(10.f, th[c]);
    if (x_in != nullptr) {
#pragma unroll
      for (int s = 0; s < M::NS; ++s) st.x[s] = x_in[s];
    } else {
      st.x[0] = m.x0_0;
      if (M::NS > 1) st.x[M::NS - 1] = m.x0_1;
    }
  }

  __device__ static void store(const State& st, float* x_out) {
#pragma unroll
    for (int s = 0; s < M::NS; ++s) x_out[s] = st.x[s];
  }

  __device__ static void propensities(const float* x, const float* r,
                                      float* a) {
    M::prop(x, r, a);
#pragma unroll
    for (int c = 0; c < M::NC; ++c) a[c] = relu_keep_nan(a[c]);
  }

  template <class Emit>
  __device__ static void step(const SegModel& m, const PhiloxLane& rng,
                              State& st, int seg, Emit&& emit) {
    for (int i = 0; i < m.leaps_per_seg; ++i) {
      const uint32_t leap = (uint32_t)(seg * m.leaps_per_seg + i);
      float a[M::NC];
      propensities(st.x, st.r, a);
      if (m.midpoint) {
        float xm[M::NS];
#pragma unroll
        for (int s = 0; s < M::NS; ++s) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < M::NC; ++c)
            acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(m.half_tau, a[c]),
                                           M::stoich(c, s)));
          xm[s] = relu_keep_nan(__fadd_rn(st.x[s], acc));
        }
        propensities(xm, st.r, a);
      }
      float n[M::NC];
#pragma unroll
      for (int c = 0; c < M::NC; ++c)
        n[c] = poisson(rng, leap * M::NC + (uint32_t)c, __fmul_rn(a[c], m.tau));
#pragma unroll
      for (int s = 0; s < M::NS; ++s) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < M::NC; ++c)
          acc = __fadd_rn(acc, __fmul_rn(n[c], M::stoich(c, s)));
        st.x[s] = relu_keep_nan(__fadd_rn(st.x[s], acc));
      }
      if ((i + 1) % m.save_every == 0) {
        const int o = (i + 1) / m.save_every - 1;
#pragma unroll
        for (int e = 0; e < M::NE; ++e)
          emit(e * m.obs_per_seg + o, st.x[M::emitted(e)]);
      }
    }
  }
};

}  // namespace pyabc
