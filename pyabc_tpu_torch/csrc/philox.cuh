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
// model index of a run over several models (never drawn with one model).
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

}  // namespace pyabc
