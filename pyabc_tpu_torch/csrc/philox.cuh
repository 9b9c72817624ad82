// K1: Philox4x32-10, the counter-based generator every in-kernel draw uses.
//
// Replaces: pyabc_tpu/core/random.py::{generation_key, round_key} and the
// jax.random calls of inference/util.py::_lane_prior / _lane_transition and
// of the models' simulators (threefry2x32 key splitting). The port does not
// reproduce jax.random's bits: it is a declared difference, and the tests
// compare distributions or feed both packages the same numbers.
//
// Written out by hand (Random123's round function and constants, no
// curand_kernel.h) so that the plain PyTorch twin in kernels/philox.py
// mirrors it word for word. Build without --use_fast_math: logf, sinf and
// cosf must stay the accurate versions for the normals to agree with the
// plain twin within 2e-6.
//
// Layout of a draw: key = the run's seed (low and high 32-bit words);
// counter = (lane, draw block, generation, stream tag * max_rounds + round).
// The tags (kernels/philox.py): 0 calibration, 1 generation-0 prior,
// 2 transition proposal, 3 simulator noise, 4 the stochastic accept, 5 the
// model index of a run over several models (never drawn with one model),
// 6 the bootstrap ancestors of the adaptive population size (K16).
// K19's Poisson draws (below) sit on the simulator-noise stream.
// One block gives four 32-bit words. A draw's position therefore depends
// only on (seed, stream, generation, round, lane, block, word): never on
// the number of lanes, on which redraw was taken, or on the device.
#pragma once

#include <math.h>
#include <stdint.h>

namespace pyabc {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
// 2 pi rounded to float32, the constant the plain twin uses
constexpr float kTwoPi = 6.28318548202514648f;

struct Words4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Words4 philox4x32_10(Words4 c, uint32_t k0,
                                                uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c.x, hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo1 = kPhiloxM1 * c.z, hi1 = __umulhi(kPhiloxM1, c.z);
    c = Words4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

__device__ __forceinline__ uint32_t word_of(const Words4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ((x >> 9) + 0.5) * 2^-23: exact in float32, in (0, 1), never 0 or 1.
__device__ __forceinline__ float uniform_of(uint32_t x) {
  return ((float)(x >> 9) + 0.5f) * 1.1920928955078125e-07f;
}

// Box-Muller on one pair of uniforms: cos branch (first) or sin branch.
__device__ __forceinline__ float box_muller(float a, float b, bool second) {
  const float r = sqrtf(-2.0f * logf(a));
  const float t = kTwoPi * b;
  return r * (second ? sinf(t) : cosf(t));
}

// One lane's place in a stream: the draw blocks vary, the rest is fixed.
struct PhiloxLane {
  uint32_t k0, k1, lane, gen, c3;

  __device__ __forceinline__ Words4 block(uint32_t b) const {
    return philox4x32_10(Words4{lane, b, gen, c3}, k0, k1);
  }
  // uniform from word `word` of block `b`
  __device__ __forceinline__ float uniform(uint32_t b, int word) const {
    return uniform_of(word_of(block(b), word));
  }
  // normal number j of a run of normals starting at block `base`: block
  // base + j / 4, Box-Muller pair (j % 4) / 2, cos for even j, sin for odd
  __device__ __forceinline__ float normal(uint32_t base, int j) const {
    const Words4 v = block(base + (uint32_t)(j >> 2));
    const int pair = (j & 3) >> 1;
    const float a = uniform_of(pair ? v.z : v.x);
    const float b = uniform_of(pair ? v.w : v.y);
    return box_muller(a, b, (j & 1) != 0);
  }
};

__device__ __forceinline__ PhiloxLane philox_lane(uint32_t k0, uint32_t k1,
                                                  uint32_t lane, uint32_t gen,
                                                  uint32_t tag,
                                                  uint32_t max_rounds,
                                                  uint32_t round) {
  return PhiloxLane{k0, k1, lane, gen, tag * max_rounds + round};
}

// ---------------------------------------------------------------- Poisson
// K19's draw: the algorithm of jax.random.poisson (jax/_src/random.py::
// _poisson): 0 at lambda = 0; Knuth's product of uniforms below lambda = 10
// (and for NaN, which returns -1 as in JAX); Hoermann's transformed
// rejection (PTRS) from 10 up (inf included). Its law is JAX's, its bits
// are not (the uniforms come from Philox, a declared difference).
//
// Uniforms of one draw: draw number `draw` of a lane (a tau leap's channel,
// leap * n_channels + channel) owns the blocks (draw << 12) | j, j < 4096;
// uniform i of the draw is word i % 4 of block i / 4. Knuth takes
// uniform i at its iteration i; PTRS takes uniforms 2j and 2j + 1 at its
// attempt j. So a draw may use at most kPoissonMaxUniforms = 16384 uniforms
// (8192 PTRS attempts); at that cap Knuth returns the count it reached and
// PTRS -1, as JAX's loops do at their (2^31 - 1) cap. Neither cap is
// reached with any probability a float32 run could see, and the cap keeps a
// lane from looping without end. The draw number must stay below 2^20.
//
// Every product, sum and quotient is written with the _rn intrinsics so
// nvcc contracts none of them into an FMA: the plain PyTorch twin
// (kernels/philox.py::poisson_plain) computes each operation on its own, and
// on the card the two agree on every count. logf and lgammaf are the
// accurate versions (no --use_fast_math).
constexpr int kPoissonBlockBits = 12;
constexpr int kPoissonMaxUniforms = 4 << kPoissonBlockBits;

__device__ __forceinline__ float poisson_knuth(const PhiloxLane& rng,
                                               uint32_t base, float lam) {
  float k = 0.f, log_prod = 0.f;
  Words4 w{};
  for (int i = 0; i < kPoissonMaxUniforms && log_prod > -lam; ++i) {
    if ((i & 3) == 0) w = rng.block(base | (uint32_t)(i >> 2));
    k = __fadd_rn(k, 1.f);
    log_prod = __fadd_rn(log_prod, logf(uniform_of(word_of(w, i & 3))));
  }
  return __fsub_rn(k, 1.f);
}

__device__ __forceinline__ float poisson_ptrs(const PhiloxLane& rng,
                                              uint32_t base, float lam) {
  const float log_lam = logf(lam);
  const float b = __fadd_rn(0.931f, __fmul_rn(2.53f, sqrtf(lam)));
  const float a = __fadd_rn(-0.059f, __fmul_rn(0.02483f, b));
  const float inv_alpha =
      __fadd_rn(1.1239f, __fdiv_rn(1.1328f, __fsub_rn(b, 3.4f)));
  const float v_r = __fsub_rn(0.9277f, __fdiv_rn(3.6224f, __fsub_rn(b, 2.f)));
  const float two_a = __fmul_rn(2.f, a);
  Words4 w{};
  for (int j = 0; j < kPoissonMaxUniforms / 2; ++j) {
    if ((j & 1) == 0) w = rng.block(base | (uint32_t)(j >> 1));
    const int o = (j & 1) * 2;
    const float u = __fsub_rn(uniform_of(word_of(w, o)), 0.5f);
    const float v = uniform_of(word_of(w, o + 1));
    const float us = __fsub_rn(0.5f, fabsf(u));
    const float k = floorf(__fadd_rn(
        __fadd_rn(__fmul_rn(__fadd_rn(__fdiv_rn(two_a, us), b), u), lam),
        0.43f));
    const float s = logf(__fdiv_rn(
        __fmul_rn(v, inv_alpha),
        __fadd_rn(__fdiv_rn(a, __fmul_rn(us, us)), b)));
    const float t = __fsub_rn(__fadd_rn(-lam, __fmul_rn(k, log_lam)),
                              lgammaf(__fadd_rn(k, 1.f)));
    const bool accept1 = (us >= 0.07f) && (v <= v_r);
    const bool reject = (k < 0.f) || ((us < 0.013f) && (v > us));
    const bool accept2 = s <= t;
    if (accept1 || (!reject && accept2)) return k;
  }
  return -1.f;
}

// One Poisson count (as a float) of rate lam for draw number `draw`.
__device__ __forceinline__ float poisson(const PhiloxLane& rng, uint32_t draw,
                                         float lam) {
  if (lam == 0.f) return 0.f;
  const uint32_t base = draw << kPoissonBlockBits;
  if (isnan(lam) || lam < 10.f) return poisson_knuth(rng, base, lam);
  return poisson_ptrs(rng, base, lam);
}

}  // namespace pyabc
