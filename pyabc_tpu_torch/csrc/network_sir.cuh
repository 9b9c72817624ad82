// K20b network's step: one segment of the ring-coupled metapopulation SIR
// for one lane.
//
// Replaces the per-lane body of pyabc_tpu/models/sir.py::
// make_network_sir_model (:79): the state y = (S, I, R) of NP = 8 patches
// in registers, the ring roll done by index (left = I[p - 1], right =
// I[p + 1], wrapping); pressure = (1 - c) I + (c / 2)(left + right), inf =
// beta S pressure / N, rec = gamma I, dy = (-inf, inf - rec, rec), in the
// JAX package's float32 order (sir.py:108-115); obs_per_seg observations a
// segment, each after n_sub classic RK4 steps of dt; emits the infected of
// every patch, time-major (emission index o * NP + p), plus noise_sd times
// normal number seg * seg_size + k of the lane on the simulator-noise
// stream when noise_sd > 0 (keyed by the slot and the segment).
#pragma once

#include "seg_model.cuh"

namespace pyabc {

struct NetworkSirStep {
  static constexpr int NP = 8;
  static constexpr int kMaxSeg = 64;
  struct State {
    float s[NP], i[NP], r[NP];
    float beta, gamma;
  };

  __device__ static void init(const SegModel& m, const float* th,
                              const float* y_in, State& st) {
    st.beta = th[0];
    st.gamma = th[1];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (y_in != nullptr) {
        st.s[p] = y_in[p];
        st.i[p] = y_in[NP + p];
        st.r[p] = y_in[2 * NP + p];
      } else {
        st.s[p] = p == 0 ? __fsub_rn(m.n_pop, m.seed_i) : m.n_pop;
        st.i[p] = p == 0 ? m.seed_i : 0.f;
        st.r[p] = 0.f;
      }
    }
  }

  __device__ static void store(const State& st, float* y_out) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      y_out[p] = st.s[p];
      y_out[NP + p] = st.i[p];
      y_out[2 * NP + p] = st.r[p];
    }
  }

  // dy of state (s, i) -> (ds, di, dr)
  __device__ static void rhs(const SegModel& m, const State& st,
                             const float* s, const float* i, float* ds,
                             float* di, float* dr) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float left = i[(p + NP - 1) % NP];
      const float right = i[(p + 1) % NP];
      const float pressure = __fadd_rn(__fmul_rn(m.c_self, i[p]),
                                       __fmul_rn(m.c_half,
                                                 __fadd_rn(left, right)));
      const float inf = __fdiv_rn(
          __fmul_rn(__fmul_rn(st.beta, s[p]), pressure), m.n_pop);
      const float rec = __fmul_rn(st.gamma, i[p]);
      ds[p] = -inf;
      di[p] = __fsub_rn(inf, rec);
      dr[p] = rec;
    }
  }

  __device__ static void rk4(const SegModel& m, State& st) {
    float k1s[NP], k1i[NP], k1r[NP], k2s[NP], k2i[NP], k2r[NP];
    float k3s[NP], k3i[NP], k3r[NP], k4s[NP], k4i[NP], k4r[NP];
    float ts[NP], ti[NP];
    rhs(m, st, st.s, st.i, k1s, k1i, k1r);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      ts[p] = __fadd_rn(st.s[p], __fmul_rn(m.h2, k1s[p]));
      ti[p] = __fadd_rn(st.i[p], __fmul_rn(m.h2, k1i[p]));
    }
    rhs(m, st, ts, ti, k2s, k2i, k2r);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      ts[p] = __fadd_rn(st.s[p], __fmul_rn(m.h2, k2s[p]));
      ti[p] = __fadd_rn(st.i[p], __fmul_rn(m.h2, k2i[p]));
    }
    rhs(m, st, ts, ti, k3s, k3i, k3r);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      ts[p] = __fadd_rn(st.s[p], __fmul_rn(m.dt, k3s[p]));
      ti[p] = __fadd_rn(st.i[p], __fmul_rn(m.dt, k3i[p]));
    }
    rhs(m, st, ts, ti, k4s, k4i, k4r);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      // y + (dt / 6) * (((k1 + 2 k2) + 2 k3) + k4)
#define PYABC_RK4_SUM(a, b, c, d)                                          \
  __fadd_rn(__fadd_rn(__fadd_rn(a, __fmul_rn(2.f, b)), __fmul_rn(2.f, c)), d)
      st.s[p] = __fadd_rn(st.s[p],
                          __fmul_rn(m.h6, PYABC_RK4_SUM(k1s[p], k2s[p],
                                                        k3s[p], k4s[p])));
      st.i[p] = __fadd_rn(st.i[p],
                          __fmul_rn(m.h6, PYABC_RK4_SUM(k1i[p], k2i[p],
                                                        k3i[p], k4i[p])));
      st.r[p] = __fadd_rn(st.r[p],
                          __fmul_rn(m.h6, PYABC_RK4_SUM(k1r[p], k2r[p],
                                                        k3r[p], k4r[p])));
#undef PYABC_RK4_SUM
    }
  }

  template <class Emit>
  __device__ static void step(const SegModel& m, const PhiloxLane& rng,
                              State& st, int seg, Emit&& emit) {
    for (int o = 0; o < m.obs_per_seg; ++o) {
      for (int q = 0; q < m.n_sub; ++q) rk4(m, st);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int k = o * NP + p;
        float v = st.i[p];
        if (m.noise_sd > 0.f)
          v = __fadd_rn(v, __fmul_rn(m.noise_sd,
                                     rng.normal(0, seg * m.seg_size + k)));
        emit(k, v);
      }
    }
  }
};

}  // namespace pyabc
