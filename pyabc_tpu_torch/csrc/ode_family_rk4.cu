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
// Lane base: lane0 is the global number of the launch's first lane, and
// lane b draws on Philox lane lane0 + b, so a device mesh rank's launch over
// the lanes [lane0, lane0 + B) gives exactly those rows of the whole round.
//
// Bound on an H100: latency. 66 RK4 steps of 4 right-hand sides (about
// 1e3 flops) form one dependent chain per lane, with 8 bytes read and 48
// written; 4096 lanes are about one warp per SM, so neither the memory
// rate nor the float32 peak is near. The state stays in a register; the
// model switch is taken once per lane, outside the step loop.
//
// Numerics: the step is OdeFamilyStep::rk4 (ode_family.cuh), every
// operation an _rn intrinsic, so nvcc contracts nothing into an FMA and the
// card rounds each operation once, as the plain PyTorch version does.
//
// The segmented family (pyabc_tpu/models/model_selection.py:83-138,
// ode_family(segments=...)): pyabc_ode_family_segments is its range entry,
// K19's form (carry, theta, seg_from, seg_to) -> the statistics of those
// segments, each lane stepping OdeFamilyStep (ode_family.cuh) with its own
// model's descriptor (models[m[b]], or models[0] when m is nullptr) and
// writing emitted value k of segment j to out[b, colmap[(j - seg_from) *
// seg_size + k]]. The classic path and a plain simulate chain every
// segment in one launch of it; K18 calls the same step one segment at a
// time, so a candidate that runs to completion gets the same bits on
// either path. Bound: latency, as above (72 RK4 steps a lane, one
// dependent chain); the y state and the rates stay in registers.
#include "common.cuh"
#include "ode_family.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 128;

// entry t: the state, plus noise_sd times normal number t when noisy
__device__ __forceinline__ float observe(float y, float noise_sd, int t,
                                         const pyabc::PhiloxLane& rng) {
  return noise_sd > 0.f
             ? __fadd_rn(y, __fmul_rn(noise_sd, rng.normal(0, t)))
             : y;
}

// one lane: n_obs - 1 intervals of n_sub steps of the family's RK4
// (OdeFamilyStep::rk4, the step of the segmented family too)
__device__ void integrate(int variant, float a, float c, float* row,
                          int n_obs, int n_sub, float dt, float y0,
                          float noise_sd, const pyabc::PhiloxLane& rng) {
  pyabc::SegModel md{};
  md.variant = variant;
  md.dt = dt;
  md.h2 = __fmul_rn(0.5f, dt);
  md.h6 = __fdiv_rn(dt, 6.0f);
  pyabc::OdeFamilyStep::State st{y0, a, variant == 0 ? 0.f : c};
  row[0] = observe(st.y, noise_sd, 0, rng);
  for (int t = 1; t < n_obs; ++t) {
    for (int s = 0; s < n_sub; ++s) pyabc::OdeFamilyStep::rk4(md, st);
    row[t] = observe(st.y, noise_sd, t, rng);
  }
}

__global__ void __launch_bounds__(kThreads)
ode_family_kernel(const float* __restrict__ theta,
                  const int* __restrict__ m, int B, int stride, int n_obs,
                  int n_sub, float dt, float y0, float noise_sd, uint32_t k0,
                  uint32_t k1, uint32_t gen, uint32_t tag,
                  uint32_t max_rounds, uint32_t lane0,
                  const int* __restrict__ counters,
                  float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float a = theta[(size_t)b * stride];
  const float c = stride > 1 ? theta[(size_t)b * stride + 1] : 0.f;
  pyabc::PhiloxLane rng{};
  if (noise_sd > 0.f)
    rng = pyabc::philox_lane(k0, k1, lane0 + (uint32_t)b, gen, tag,
                             max_rounds, (uint32_t)counters[1]);
  const int variant = m[b] == 0 ? 0 : m[b] == 1 ? 1 : 2;
  integrate(variant, a, c, out + (size_t)b * n_obs, n_obs, n_sub, dt, y0,
            noise_sd, rng);
}

__global__ void __launch_bounds__(kThreads)
ode_family_segments_kernel(pyabc::SegModels models, int K,
                           const int* __restrict__ m_lane,
                           const float* __restrict__ theta, int B,
                           int stride, const float* __restrict__ y_in,
                           float* __restrict__ y_out, int seg_from,
                           int seg_to, const int* __restrict__ colmap,
                           int width, float* __restrict__ out, uint32_t k0,
                           uint32_t k1, uint32_t gen, uint32_t tag,
                           uint32_t max_rounds, uint32_t lane0,
                           const int* __restrict__ counters) {
  using Step = pyabc::OdeFamilyStep;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const pyabc::SegModel m =
      models.m[m_lane != nullptr ? min(max(m_lane[b], 0), K - 1) : 0];
  Step::State st;
  Step::init(m, theta + (size_t)b * stride,
             y_in != nullptr ? y_in + b : nullptr, st);
  pyabc::PhiloxLane rng{};
  if (m.noise_sd > 0.f)
    rng = pyabc::philox_lane(k0, k1, lane0 + (uint32_t)b, gen, tag,
                             max_rounds, (uint32_t)counters[1]);
  float* row = out + (size_t)b * width;
  for (int seg = seg_from; seg < seg_to; ++seg) {
    const int* cols = colmap + (size_t)(seg - seg_from) * m.seg_size;
    Step::step(m, rng, st, seg, [&](int k, float v) { row[cols[k]] = v; });
  }
  if (y_out != nullptr) Step::store(st, y_out + b);
}

}  // namespace

// models: K family descriptors (kind kOdeFamily); m: the lanes' models or
// nullptr (every lane models[0]).
extern "C" int pyabc_ode_family_segments(
    const pyabc::SegModel* models, int K, const int* m, const float* theta,
    int B, int stride, const float* y_in, float* y_out, int seg_from,
    int seg_to, const int* colmap, int width, float* out, unsigned k0,
    unsigned k1, unsigned gen, unsigned tag, unsigned max_rounds,
    unsigned lane0, const int* counters, void* stream_ptr) {
  if (B <= 0 || seg_to <= seg_from) return 0;
  if (models == nullptr || colmap == nullptr || K < 1 || K > pyabc::kMaxModels ||
      stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  pyabc::SegModels ms{};
  for (int k = 0; k < K; ++k) {
    ms.m[k] = models[k];
    if (ms.m[k].kind != pyabc::kOdeFamily ||
        ms.m[k].seg_size != ms.m[0].seg_size ||
        (ms.m[k].variant != 0 && stride < 2) ||
        (ms.m[k].noise_sd > 0.f && counters == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = (B + kThreads - 1) / kThreads;
  ode_family_segments_kernel<<<grid, kThreads, 0, stream>>>(
      ms, K, m, theta, B, stride, y_in, y_out, seg_from, seg_to, colmap,
      width, out, k0, k1, gen, tag, max_rounds, lane0, counters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pyabc_ode_family_simulate(
    const float* theta, const int* m, int B, int stride, int n_obs, int n_sub,
    float dt, float y0, float noise_sd, unsigned k0, unsigned k1,
    unsigned gen, unsigned tag, unsigned max_rounds, unsigned lane0,
    const int* counters, float* out, void* stream_ptr) {
  if (B <= 0) return 0;
  if (stride < 1 || n_obs < 1 || (noise_sd > 0.f && counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = (B + kThreads - 1) / kThreads;
  ode_family_kernel<<<grid, kThreads, 0, stream>>>(
      theta, m, B, stride, n_obs, n_sub, dt, y0, noise_sd, k0, k1, gen, tag,
      max_rounds, lane0, counters, out);
  return static_cast<int>(cudaGetLastError());
}
