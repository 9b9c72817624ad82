// K4 lv_simulate: the Lotka-Volterra simulator of one proposal round.
//
// Replaces: pyabc_tpu/models/ode.py::rk4_at_times with
// pyabc_tpu/models/lotka_volterra.py::_lv_rhs / make_lv_model (vmapped over
// the round's lanes).
//
// Per lane: theta = (alpha, beta, gamma, delta) (10**theta when the model
// uses log parameters), y0 = (prey, pred); n_obs - 1 observation intervals
// of n_substeps classic RK4 steps with the float32 step dt; every saved
// state (row 0 is y0 itself) is clipped to [0, 1e6] with NaN kept (jnp.clip
// semantics: a blown-up lane must stay NaN for the distance and the health
// word), and noise_sd * noise is added. The noise is drawn in the kernel
// from Philox4x32-10 (philox.cuh) on the simulator-noise stream: normal
// number s n_obs + i of the lane (s = 0 prey, 1 pred), the round read from
// counters[1]. The output row is SumStatSpec's sorted layout: out[b] =
// pred[0:n_obs] | prey[0:n_obs].
//
// Lane base: lane0 is the global number of the launch's first lane, and
// lane b draws on Philox lane lane0 + b, so a device mesh rank's launch over
// the lanes [lane0, lane0 + B) gives exactly those rows of the whole round.
//
// Bound on an H100: neither memory nor peak flops at the main-path shape;
// each lane is a chain of 190 dependent RK4 steps, so with B=4096 lanes
// (about one warp per SM) the kernel is latency bound. The design keeps
// the whole state in registers and writes each output once.
//
// Numerics: nvcc contracts a*b+c into FMA by default, so results differ
// from the unfused PyTorch version in the last bits of each step; the
// accumulated difference is what chip_smoke.py's stated tolerance covers.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 128;

struct Rates {
  float alpha, beta, gamma, delta;
};

__device__ __forceinline__ void lv_rhs(const Rates& r, float prey, float pred,
                                       float* dprey, float* dpred) {
  *dprey = r.alpha * prey - r.beta * prey * pred;
  *dpred = r.delta * prey * pred - r.gamma * pred;
}

__global__ void __launch_bounds__(kThreads)
lv_simulate_kernel(const float* __restrict__ theta, int B, int stride,
                   int n_obs, int n_sub,
                   float dt, float y0_prey, float y0_pred, float noise_sd,
                   int log_params, uint32_t k0, uint32_t k1, uint32_t gen,
                   uint32_t tag, uint32_t max_rounds, uint32_t lane0,
                   const int* __restrict__ counters, float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const pyabc::PhiloxLane rng = pyabc::philox_lane(
      k0, k1, lane0 + (uint32_t)b, gen, tag, max_rounds,
      (uint32_t)counters[1]);
  const float* th = theta + (size_t)b * stride;
  Rates r{th[0], th[1], th[2], th[3]};
  if (log_params) {
    r.alpha = powf(10.f, r.alpha);
    r.beta = powf(10.f, r.beta);
    r.gamma = powf(10.f, r.gamma);
    r.delta = powf(10.f, r.delta);
  }
  auto prey_noise = [&](int i) { return rng.normal(0, i); };
  auto pred_noise = [&](int i) { return rng.normal(0, n_obs + i); };
  float* row = out + (size_t)b * 2 * n_obs;
  const float h2 = 0.5f * dt;
  const float h6 = dt / 6.0f;

  float x = y0_prey, y = y0_pred;
  row[0] = clip_keep_nan(y, 0.f, 1e6f) + noise_sd * pred_noise(0);
  row[n_obs] = clip_keep_nan(x, 0.f, 1e6f) + noise_sd * prey_noise(0);
  for (int i = 1; i < n_obs; ++i) {
    for (int s = 0; s < n_sub; ++s) {
      float k1x, k1y, k2x, k2y, k3x, k3y, k4x, k4y;
      lv_rhs(r, x, y, &k1x, &k1y);
      lv_rhs(r, x + h2 * k1x, y + h2 * k1y, &k2x, &k2y);
      lv_rhs(r, x + h2 * k2x, y + h2 * k2y, &k3x, &k3y);
      lv_rhs(r, x + dt * k3x, y + dt * k3y, &k4x, &k4y);
      x = x + h6 * (k1x + 2.f * k2x + 2.f * k3x + k4x);
      y = y + h6 * (k1y + 2.f * k2y + 2.f * k3y + k4y);
    }
    row[i] = clip_keep_nan(y, 0.f, 1e6f) + noise_sd * pred_noise(i);
    row[n_obs + i] = clip_keep_nan(x, 0.f, 1e6f) + noise_sd * prey_noise(i);
  }
}

}  // namespace

extern "C" int pyabc_lv_simulate(const float* theta, int B, int stride,
                                  int n_obs, int n_sub,
                                  float dt, float y0_prey, float y0_pred,
                                  float noise_sd, int log_params, unsigned k0,
                                  unsigned k1, unsigned gen, unsigned tag,
                                  unsigned max_rounds, unsigned lane0,
                                  const int* counters,
                                  float* out, void* stream_ptr) {
  if (B <= 0) return 0;
  if (counters == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = (B + kThreads - 1) / kThreads;
  lv_simulate_kernel<<<grid, kThreads, 0, stream>>>(
      theta, B, stride, n_obs, n_sub, dt, y0_prey, y0_pred, noise_sd,
      log_params, k0, k1, gen, tag, max_rounds, lane0, counters, out);
  return static_cast<int>(cudaGetLastError());
}
