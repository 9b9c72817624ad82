// K20b ode_family_simulate: the K = 3 ODE family of model selection
// (BASELINE config 5) over one proposal round.
//
// Replaces: pyabc_tpu/models/model_selection.py::ode_family (the
// unsegmented simulators, rhs0/rhs1/rhs2 through models/ode.py::
// rk4_at_times), switched per lane over the model index as lax.switch
// does under vmap.
//
// Per lane b with model m = m[b] and theta row (a, b_or_k) (padded to
// stride entries; model 0 reads only a and integrates with b = 0):
//   m0: dy = (-a) y              (pure decay)
//   m1: dy = (-a) y + b          (decay + constant production)
//   m2: dy = (a y) (1 - y / k)   (logistic)
// in the JAX float32 order, y0 = 2, n_obs - 1 intervals of n_substeps
// classic RK4 steps of the float32 step dt = (ts[1] - ts[0]) / n_substeps
// (models/ode.py::rk4_dt). Row 0 is y0 itself. With noise_sd > 0 entry t
// adds noise_sd times normal number t of the lane on the simulator-noise
// stream (philox.cuh), as the JAX simulator adds noise at all n_obs times.
//
// Bound on an H100: latency. 66 RK4 steps of 4 right-hand sides (about
// 1e3 flops) form one dependent chain per lane, with 8 bytes read and 48
// written; 4096 lanes are about one warp per SM, so neither the memory
// rate nor the float32 peak is near. The state stays in a register; the
// model switch is taken once per lane, outside the step loop.
//
// Numerics: nvcc contracts a*b+c into FMA, so each step differs from the
// unfused PyTorch version in its last bits; the stated tolerance covers it.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 128;

template <int M>
__device__ __forceinline__ float rhs(float y, float a, float c) {
  if (M == 0) return -a * y;
  if (M == 1) return -a * y + c;
  return a * y * (1.f - y / c);
}

template <int M>
__device__ void integrate(float a, float c, float* row, int n_obs, int n_sub,
                          float dt, float y0, float noise_sd,
                          const pyabc::PhiloxLane& rng) {
  const bool noisy = noise_sd > 0.f;
  const float h2 = 0.5f * dt;
  const float h6 = dt / 6.0f;
  float y = y0;
  row[0] = noisy ? y + noise_sd * rng.normal(0, 0) : y;
  for (int t = 1; t < n_obs; ++t) {
    for (int s = 0; s < n_sub; ++s) {
      const float k1 = rhs<M>(y, a, c);
      const float k2 = rhs<M>(y + h2 * k1, a, c);
      const float k3 = rhs<M>(y + h2 * k2, a, c);
      const float k4 = rhs<M>(y + dt * k3, a, c);
      y = y + h6 * (k1 + 2.f * k2 + 2.f * k3 + k4);
    }
    row[t] = noisy ? y + noise_sd * rng.normal(0, t) : y;
  }
}

__global__ void __launch_bounds__(kThreads)
ode_family_kernel(const float* __restrict__ theta,
                  const int* __restrict__ m, int B, int stride, int n_obs,
                  int n_sub, float dt, float y0, float noise_sd, uint32_t k0,
                  uint32_t k1, uint32_t gen, uint32_t tag,
                  uint32_t max_rounds, const int* __restrict__ counters,
                  float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float a = theta[(size_t)b * stride];
  const float c = stride > 1 ? theta[(size_t)b * stride + 1] : 0.f;
  pyabc::PhiloxLane rng{};
  if (noise_sd > 0.f)
    rng = pyabc::philox_lane(k0, k1, (uint32_t)b, gen, tag, max_rounds,
                             (uint32_t)counters[1]);
  float* row = out + (size_t)b * n_obs;
  switch (m[b]) {
    case 0:
      integrate<0>(a, 0.f, row, n_obs, n_sub, dt, y0, noise_sd, rng);
      break;
    case 1:
      integrate<1>(a, c, row, n_obs, n_sub, dt, y0, noise_sd, rng);
      break;
    default:
      integrate<2>(a, c, row, n_obs, n_sub, dt, y0, noise_sd, rng);
      break;
  }
}

}  // namespace

extern "C" int pyabc_ode_family_simulate(
    const float* theta, const int* m, int B, int stride, int n_obs, int n_sub,
    float dt, float y0, float noise_sd, unsigned k0, unsigned k1,
    unsigned gen, unsigned tag, unsigned max_rounds, const int* counters,
    float* out, void* stream_ptr) {
  if (B <= 0) return 0;
  if (stride < 1 || n_obs < 1 || (noise_sd > 0.f && counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = (B + kThreads - 1) / kThreads;
  ode_family_kernel<<<grid, kThreads, 0, stream>>>(
      theta, m, B, stride, n_obs, n_sub, dt, y0, noise_sd, k0, k1, gen, tag,
      max_rounds, counters, out);
  return static_cast<int>(cudaGetLastError());
}
