// K20 sir_simulate: the SIR epidemic simulator of one proposal round.
//
// Replaces: pyabc_tpu/models/ode.py::rk4_at_times with
// pyabc_tpu/models/sir.py::_sir_rhs / make_sir_model (vmapped over the
// round's lanes).
//
// Per lane: theta = (beta, gamma), y0 = (N - 1, 1, 0) with N = n_pop;
// n_obs - 1 observation intervals of n_substeps classic RK4 steps with the
// float32 step dt = (ts[1] - ts[0]) / n_substeps; the right-hand side keeps
// the JAX package's float32 order, inf = beta * s * i / N, rec = gamma * i,
// dy = (-inf, inf - rec, rec). Row 0 is y0 itself. The output is the
// infected compartment at the n_obs times, plus noise_sd times normal
// number i of the lane on the simulator-noise stream (philox.cuh) when
// noise_sd > 0; a deterministic model (noise_sd = 0, BASELINE config 4)
// draws nothing. No clip: the JAX simulator has none.
//
// Lane base: lane0 is the global number of the launch's first lane, and
// lane b draws on Philox lane lane0 + b, so a device mesh rank's launch over
// the lanes [lane0, lane0 + B) gives exactly those rows of the whole round.
//
// Bound on an H100: latency. Each lane is a chain of (n_obs - 1) *
// n_substeps dependent RK4 steps (112 at config 4) and reads 8 bytes and
// writes 60; with B = 4096 lanes (about one warp per SM) neither memory
// nor the float32 peak is near. The design keeps the state in registers
// and writes each output once.
//
// Numerics: nvcc contracts a*b+c into FMA, so each step differs from the
// unfused PyTorch version in its last bits; chip_smoke.py's stated
// tolerance covers the accumulated difference.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 128;

struct Sir {
  float s, i, r;
};

__device__ __forceinline__ Sir sir_rhs(const Sir& y, float beta, float gamma,
                                       float n_pop) {
  const float inf = beta * y.s * y.i / n_pop;
  const float rec = gamma * y.i;
  return Sir{-inf, inf - rec, rec};
}

__device__ __forceinline__ Sir axpy(const Sir& y, float h, const Sir& k) {
  return Sir{y.s + h * k.s, y.i + h * k.i, y.r + h * k.r};
}

__global__ void __launch_bounds__(kThreads)
sir_simulate_kernel(const float* __restrict__ theta, int B, int stride,
                    int n_obs, int n_sub, float dt, float n_pop,
                    float noise_sd, uint32_t k0, uint32_t k1, uint32_t gen,
                    uint32_t tag, uint32_t max_rounds, uint32_t lane0,
                    const int* __restrict__ counters,
                    float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float beta = theta[(size_t)b * stride];
  const float gamma = theta[(size_t)b * stride + 1];
  const bool noisy = noise_sd > 0.f;
  pyabc::PhiloxLane rng{};
  if (noisy)
    rng = pyabc::philox_lane(k0, k1, lane0 + (uint32_t)b, gen, tag,
                             max_rounds, (uint32_t)counters[1]);
  float* row = out + (size_t)b * n_obs;
  const float h2 = 0.5f * dt;
  const float h6 = dt / 6.0f;

  Sir y{n_pop - 1.f, 1.f, 0.f};
  row[0] = noisy ? y.i + noise_sd * rng.normal(0, 0) : y.i;
  for (int t = 1; t < n_obs; ++t) {
    for (int s = 0; s < n_sub; ++s) {
      const Sir k1 = sir_rhs(y, beta, gamma, n_pop);
      const Sir k2 = sir_rhs(axpy(y, h2, k1), beta, gamma, n_pop);
      const Sir k3 = sir_rhs(axpy(y, h2, k2), beta, gamma, n_pop);
      const Sir k4 = sir_rhs(axpy(y, dt, k3), beta, gamma, n_pop);
      y.s = y.s + h6 * (k1.s + 2.f * k2.s + 2.f * k3.s + k4.s);
      y.i = y.i + h6 * (k1.i + 2.f * k2.i + 2.f * k3.i + k4.i);
      y.r = y.r + h6 * (k1.r + 2.f * k2.r + 2.f * k3.r + k4.r);
    }
    row[t] = noisy ? y.i + noise_sd * rng.normal(0, t) : y.i;
  }
}

}  // namespace

extern "C" int pyabc_sir_simulate(const float* theta, int B, int stride,
                                   int n_obs, int n_sub, float dt,
                                   float n_pop, float noise_sd, unsigned k0,
                                   unsigned k1, unsigned gen, unsigned tag,
                                   unsigned max_rounds, unsigned lane0,
                                   const int* counters, float* out,
                                   void* stream_ptr) {
  if (B <= 0) return 0;
  if (noise_sd > 0.f && counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = (B + kThreads - 1) / kThreads;
  sir_simulate_kernel<<<grid, kThreads, 0, stream>>>(
      theta, B, stride, n_obs, n_sub, dt, n_pop, noise_sd, k0, k1, gen, tag,
      max_rounds, lane0, counters, out);
  return static_cast<int>(cudaGetLastError());
}
