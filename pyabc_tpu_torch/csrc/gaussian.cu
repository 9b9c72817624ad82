// K4 gaussian_simulate: the Gaussian toy's simulator of one proposal round
// (BASELINE config 1).
//
// Replaces: pyabc_tpu/models/gaussian.py::make_gaussian_model (vmapped over
// the round's lanes).
//
// Per lane: theta = (mu, sigma); n normals z_j drawn from Philox4x32-10
// (philox.cuh) on the simulator-noise stream, normal number j of the lane
// (block j / 4, the round read from counters[1]); x_j = mu + |sigma| z_j;
// mean = sum x_j / n and the population std sqrt(sum (x_j - mean)^2 / n)
// (jnp.std), two passes over the same draws. The row out[b] has S columns
// in SumStatSpec's sorted layout: the mean goes to column col_mean and the
// std to col_std, a negative column being one the observation leaves out
// ((mean, std) is S = 2, columns 0 and 1; an observed mean alone S = 1).
//
// Lane base: lane0 is the global number of the launch's first lane, and
// lane b draws on Philox lane lane0 + b, so a device mesh rank's launch over
// the lanes [lane0, lane0 + B) gives exactly those rows of the whole round.
//
// Design: one thread a lane, the x_j recomputed from the Philox blocks in
// the second pass rather than held (any n fits in registers that way); one
// block of four normals costs one Philox call. Every product, sum and
// quotient that the plain PyTorch version rounds on its own is written with
// the _rn intrinsics, so nvcc contracts none of them into an FMA.
//
// Bound on an H100: at B = 65536 lanes and n = 10 the work is 3 Philox
// blocks and 10 Box-Muller pairs a lane and a pass, a few hundred thousand
// operations in all, and 12 bytes a lane moved: latency bound.
//
// K4 mean_only_simulate: the conjugate toy's simulator of one proposal
// round (examples/01_gaussian_toy.py) and each model of the tractable pair.
//
// Replaces: pyabc_tpu/models/gaussian.py::make_mean_only_model (:38, lane
// body :44) and the same body in pyabc_tpu/models/model_selection.py::
// tractable_pair (:35), vmapped over the round's lanes.
//
// Per lane: x = theta[b * stride] + noise_sd * z, with z normal number 0 of
// Philox lane lane0 + b on the simulator-noise stream (the cosine of block
// 0's first Box-Muller pair); noise_sd is the float32 the plain version
// multiplies by, and the product and the sum are _rn intrinsics, so nvcc
// contracts nothing into an FMA and the row is the plain version's bit for
// bit. The output is the (B, 1) rows of the toy's one statistic.
//
// Bound on an H100: one Philox block (about 100 integer operations) and one
// Box-Muller normal a lane against 4 bytes read and 4 written: at B =
// 65536 both bounds are well under a microsecond, so the launch's latency
// bounds it. One thread a lane, nothing held.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 128;

// the four normals of one Philox block, in the order of normal number j
__device__ __forceinline__ void block_normals(const pyabc::PhiloxLane& rng,
                                              uint32_t b, float z[4]) {
  const pyabc::Words4 v = rng.block(b);
  const float a0 = pyabc::uniform_of(v.x), b0 = pyabc::uniform_of(v.y);
  const float a1 = pyabc::uniform_of(v.z), b1 = pyabc::uniform_of(v.w);
  z[0] = pyabc::box_muller(a0, b0, false);
  z[1] = pyabc::box_muller(a0, b0, true);
  z[2] = pyabc::box_muller(a1, b1, false);
  z[3] = pyabc::box_muller(a1, b1, true);
}

__global__ void __launch_bounds__(kThreads)
gaussian_simulate_kernel(const float* __restrict__ theta, int B, int stride,
                         int n, uint32_t k0, uint32_t k1, uint32_t gen,
                         uint32_t tag, uint32_t max_rounds, uint32_t lane0,
                         const int* __restrict__ counters, int S,
                         int col_mean, int col_std, float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const pyabc::PhiloxLane rng = pyabc::philox_lane(
      k0, k1, lane0 + (uint32_t)b, gen, tag, max_rounds,
      (uint32_t)counters[1]);
  const float mu = theta[(size_t)b * stride];
  const float sigma = fabsf(theta[(size_t)b * stride + 1]);
  const float fn = (float)n;
  float z[4];
  float sum = 0.f;
  for (int j0 = 0; j0 < n; j0 += 4) {
    block_normals(rng, (uint32_t)(j0 >> 2), z);
    for (int i = 0; i < 4 && j0 + i < n; ++i)
      sum = __fadd_rn(sum, __fadd_rn(mu, __fmul_rn(sigma, z[i])));
  }
  const float mean = __fdiv_rn(sum, fn);
  float ss = 0.f;
  for (int j0 = 0; j0 < n; j0 += 4) {
    block_normals(rng, (uint32_t)(j0 >> 2), z);
    for (int i = 0; i < 4 && j0 + i < n; ++i) {
      const float dv = __fsub_rn(__fadd_rn(mu, __fmul_rn(sigma, z[i])), mean);
      ss = __fadd_rn(ss, __fmul_rn(dv, dv));
    }
  }
  if (col_mean >= 0) out[(size_t)b * S + col_mean] = mean;
  if (col_std >= 0) out[(size_t)b * S + col_std] = sqrtf(__fdiv_rn(ss, fn));
}

__global__ void __launch_bounds__(kThreads)
mean_only_simulate_kernel(const float* __restrict__ theta, int B, int stride,
                          float noise_sd, uint32_t k0, uint32_t k1,
                          uint32_t gen, uint32_t tag, uint32_t max_rounds,
                          uint32_t lane0, const int* __restrict__ counters,
                          float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const pyabc::PhiloxLane rng = pyabc::philox_lane(
      k0, k1, lane0 + (uint32_t)b, gen, tag, max_rounds,
      (uint32_t)counters[1]);
  out[b] = __fadd_rn(theta[(size_t)b * stride],
                     __fmul_rn(noise_sd, rng.normal(0, 0)));
}

}  // namespace

extern "C" int pyabc_mean_only_simulate(const float* theta, int B,
                                         int stride, float noise_sd,
                                         unsigned k0, unsigned k1,
                                         unsigned gen, unsigned tag,
                                         unsigned max_rounds, unsigned lane0,
                                         const int* counters, float* out,
                                         void* stream_ptr) {
  if (B <= 0) return 0;
  if (counters == nullptr || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = (B + kThreads - 1) / kThreads;
  mean_only_simulate_kernel<<<grid, kThreads, 0, stream>>>(
      theta, B, stride, noise_sd, k0, k1, gen, tag, max_rounds, lane0,
      counters, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pyabc_gaussian_simulate(const float* theta, int B, int stride,
                                        int n, unsigned k0, unsigned k1,
                                        unsigned gen, unsigned tag,
                                        unsigned max_rounds, unsigned lane0,
                                        const int* counters, int S,
                                        int col_mean, int col_std, float* out,
                                        void* stream_ptr) {
  if (B <= 0) return 0;
  if (counters == nullptr || n <= 0 || stride < 2 || col_mean >= S ||
      col_std >= S || (col_mean < 0 && col_std < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int grid = (B + kThreads - 1) / kThreads;
  gaussian_simulate_kernel<<<grid, kThreads, 0, stream>>>(
      theta, B, stride, n, k0, k1, gen, tag, max_rounds, lane0, counters, S,
      col_mean, col_std, out);
  return static_cast<int>(cudaGetLastError());
}
