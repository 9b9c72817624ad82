// K20b network_sir: the ring-coupled metapopulation SIR of one proposal
// round, over a range of segments.
//
// Replaces: pyabc_tpu/models/sir.py::make_network_sir_model (:79), its
// segment step under vmap (8 patches, 16 observations in 4 segments, 4
// RK4 steps an observation -> (B, 128)).
//
// Entry: (carry, theta, seg_from, seg_to) -> the statistics of those
// segments, as K19's: lane b starts from y_in[b] ((3, 8) floats) or from
// the seeded state, steps NetworkSirStep::step (network_sir.cuh) over the
// range, writes emitted value k of segment j to out[b, colmap[(j -
// seg_from) * seg_size + k]] and, if y_out is given, its final state. K18
// calls the same step one segment at a time.
//
// Lane base: lane0 is the global number of the launch's first lane, and
// lane b draws on Philox lane lane0 + b, so a device mesh rank's launch over
// the lanes [lane0, lane0 + B) gives exactly those rows of the whole round.
//
// Bound on an H100: operations. Each lane runs 64 dependent RK4 steps of
// 24 states (about 60 float operations a patch a stage); it reads 8 bytes
// and writes 128 floats. The state stays in registers (the ring roll is an
// index), each statistic goes to global memory as it is made.
#include "network_sir.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
network_sir_kernel(pyabc::SegModel m, const float* __restrict__ theta, int B,
                   int stride, const float* __restrict__ y_in,
                   float* __restrict__ y_out, int seg_from, int seg_to,
                   const int* __restrict__ colmap, int width,
                   float* __restrict__ out, uint32_t k0, uint32_t k1,
                   uint32_t gen, uint32_t tag, uint32_t max_rounds,
                   uint32_t lane0, const int* __restrict__ counters) {
  using Step = pyabc::NetworkSirStep;
  constexpr int kState = 3 * Step::NP;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Step::State st;
  Step::init(m, theta + (size_t)b * stride,
             y_in != nullptr ? y_in + (size_t)b * kState : nullptr, st);
  pyabc::PhiloxLane rng{};
  if (m.noise_sd > 0.f)
    rng = pyabc::philox_lane(k0, k1, lane0 + (uint32_t)b, gen, tag,
                             max_rounds, (uint32_t)counters[1]);
  float* row = out + (size_t)b * width;
  for (int seg = seg_from; seg < seg_to; ++seg) {
    const int* cols = colmap + (size_t)(seg - seg_from) * m.seg_size;
    Step::step(m, rng, st, seg, [&](int k, float v) { row[cols[k]] = v; });
  }
  if (y_out != nullptr) Step::store(st, y_out + (size_t)b * kState);
}

}  // namespace

extern "C" int pyabc_network_sir(const pyabc::SegModel* model,
                                 const float* theta, int B, int stride,
                                 const float* y_in, float* y_out,
                                 int seg_from, int seg_to, const int* colmap,
                                 int width, float* out, unsigned k0,
                                 unsigned k1, unsigned gen, unsigned tag,
                                 unsigned max_rounds, unsigned lane0,
                                 const int* counters, void* stream_ptr) {
  if (B <= 0 || seg_to <= seg_from) return 0;
  if (model == nullptr || colmap == nullptr ||
      model->kind != pyabc::kNetworkSir ||
      (model->noise_sd > 0.f && counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = (B + kThreads - 1) / kThreads;
  network_sir_kernel<<<grid, kThreads, 0, stream>>>(
      *model, theta, B, stride, y_in, y_out, seg_from, seg_to, colmap, width,
      out, k0, k1, gen, tag, max_rounds, lane0, counters);
  return static_cast<int>(cudaGetLastError());
}
