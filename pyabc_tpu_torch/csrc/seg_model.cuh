// The segmented simulators' shared descriptor and helpers: K19 (tau
// leaping), K20b network (the network SIR), K20b's segmented ODE family
// and K18 (the segmented round, which steps any of them one segment at a
// time, each slot with its own model's descriptor when K > 1).
//
// A segmented simulator advances one lane by one fixed-length segment and
// emits that segment's block of seg_size statistics (ops/segment.py's
// protocol, pyabc_tpu/ops/segment.py::SegmentedSim). Each step here is one
// __device__ function that both the classic kernel (the whole segment range
// in one launch) and K18 (one segment between two bound checks) call, so a
// candidate that runs to completion gets the same statistics on either path.
// Every step writes its arithmetic with the _rn intrinsics: nvcc contracts
// nothing into an FMA, the two inlined copies compute the same bits, and the
// plain PyTorch twins (one rounding per operation) agree with them on the
// card.
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace pyabc {

enum SegKind : int {
  kTauLeapBirthDeath = 0,
  kTauLeapLV = 1,
  kNetworkSir = 2,
  kOdeFamily = 3
};

// Mirrors kernels/tau_leap.py::SegModelC field for field.
struct SegModel {
  int kind;
  int midpoint;       // tau leap: the midpoint (second-order) variant
  int n_seg;          // segments of the whole trajectory
  int seg_size;       // statistics a segment emits
  int leaps_per_seg;  // tau leap
  int save_every;     // tau leap: leaps between saved states
  int obs_per_seg;    // saved states (tau leap) / observations (network)
  int n_sub;          // network SIR, ODE family: RK4 steps per observation
  int variant;        // ODE family: the model (0 decay, 1 + production,
                      // 2 logistic)
  float tau;          // tau leap: t1 / n_leaps, rounded to float32
  float half_tau;     // 0.5 * tau (rounded once from double, as JAX does)
  float x0_0, x0_1;   // tau leap: initial counts; ODE family: y0 in x0_0
  float dt, h2, h6;   // RK4 step, dt / 2, dt / 6 (network SIR, family)
  float n_pop;        // network SIR: patch population
  float c_self;       // 1 - coupling
  float c_half;       // 0.5 * coupling
  float seed_i;       // infected in patch 0 at t = 0
  float noise_sd;     // network SIR, family: measurement noise (0: none)
};

// at most this many models share a segmented launch (K > 1); kernels/
// tau_leap.py's MAX_MODELS
constexpr int kMaxModels = 8;

// the K models' descriptors, passed to a kernel by value
struct SegModels {
  SegModel m[kMaxModels];
};

// jnp.maximum(v, 0): NaN stays NaN (fmaxf would drop it).
__device__ __forceinline__ float relu_keep_nan(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

}  // namespace pyabc
