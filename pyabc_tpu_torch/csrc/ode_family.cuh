// K20b's segmented ODE family step: one segment of one model of the K = 3
// family for one lane.
//
// Replaces the segment step of pyabc_tpu/models/model_selection.py::
// ode_family(segments=...) (:83-138): the state y and the rates (a, b),
// padded to 2 (m0, pure decay, integrates with b = 0); obs_per_seg
// observations a segment at the n_obs times after t = 0, each after n_sub
// classic RK4 steps of dt = (t1 / n_obs) / n_sub (computed in double and
// rounded once to float32, as JAX does, and so are dt / 2 and dt / 6):
//   variant 0: dy = (-a) y          (decay)
//   variant 1: dy = (-a) y + b      (decay + constant production)
//   variant 2: dy = (a y) (1 - y / b)  (logistic, b = k)
// and y + (dt / 6) (((k1 + 2 k2) + 2 k3) + k4), in the JAX package's
// float32 order, every operation written with an _rn intrinsic (nvcc
// contracts nothing into an FMA, the plain PyTorch twin rounds the same).
// Observation j of segment seg adds noise_sd times normal number
// seg * obs_per_seg + j of the lane's simulator-noise stream when noise_sd
// > 0 (the unsegmented family keys observation t to normal number t the
// same way). K18 and the range kernel (ode_family_rk4.cu) share this step,
// so a candidate that runs to completion gets the same bits on either.
#pragma once

#include "seg_model.cuh"

namespace pyabc {

struct OdeFamilyStep {
  static constexpr int kMaxSeg = 64;
  struct State {
    float y, a, b;
  };

  __device__ static void init(const SegModel& m, const float* th,
                              const float* y_in, State& st) {
    st.a = th[0];
    st.b = m.variant == 0 ? 0.f : th[1];
    st.y = y_in != nullptr ? y_in[0] : m.x0_0;
  }

  __device__ static void store(const State& st, float* y_out) {
    y_out[0] = st.y;
  }

  __device__ static float rhs(int variant, float y, float a, float b) {
    if (variant == 0) return __fmul_rn(-a, y);
    if (variant == 1) return __fadd_rn(__fmul_rn(-a, y), b);
    return __fmul_rn(__fmul_rn(a, y), __fsub_rn(1.f, __fdiv_rn(y, b)));
  }

  __device__ static void rk4(const SegModel& m, State& st) {
    const int v = m.variant;
    const float y = st.y;
    const float k1 = rhs(v, y, st.a, st.b);
    const float k2 = rhs(v, __fadd_rn(y, __fmul_rn(m.h2, k1)), st.a, st.b);
    const float k3 = rhs(v, __fadd_rn(y, __fmul_rn(m.h2, k2)), st.a, st.b);
    const float k4 = rhs(v, __fadd_rn(y, __fmul_rn(m.dt, k3)), st.a, st.b);
    const float sum = __fadd_rn(
        __fadd_rn(__fadd_rn(k1, __fmul_rn(2.f, k2)), __fmul_rn(2.f, k3)),
        k4);
    st.y = __fadd_rn(y, __fmul_rn(m.h6, sum));
  }

  template <class Emit>
  __device__ static void step(const SegModel& m, const PhiloxLane& rng,
                              State& st, int seg, Emit&& emit) {
    for (int j = 0; j < m.obs_per_seg; ++j) {
      for (int q = 0; q < m.n_sub; ++q) rk4(m, st);
      float v = st.y;
      if (m.noise_sd > 0.f)
        v = __fadd_rn(v, __fmul_rn(m.noise_sd,
                                   rng.normal(0, seg * m.obs_per_seg + j)));
      emit(j, v);
    }
  }
};

}  // namespace pyabc
