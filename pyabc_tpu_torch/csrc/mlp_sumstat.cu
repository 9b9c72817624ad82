// K23 MLP transform: learned summary statistics s(x) = f((x - mu) / sd) *
// ysd + ymu through a tanh MLP, and the p-norm accept of a round through
// them.
//
// Replaces: pyabc_tpu/ops/fit.py::_mlp_forward (:102) as
// pyabc_tpu/predictor/predictor.py::MLPPredictor.device_predict (:272)
// runs it inside pyabc_tpu/distance/pnorm.py::PNormDistance.device_fn
// (:204-219: x and x0 both through the transform) composed with
// UniformAcceptor.device_fn and the log weight of util.py:400-406; and the
// places the multigen kernel transforms rows: the record ring under an
// adaptive distance (util.py:1818-1828), the reservoir's recompute after a
// boundary refit (:1850-1862) and the packed fetch (:2051-2066).
//
// One device function (mlp_row: one warp a row) serves three entries, so
// a row transforms to the same bits wherever it is transformed:
//   pyabc_mlp_transform  (n, S) -> (n, C'): the fetch, the ring, x0;
//   pyabc_mlp_accept     x0 through the MLP once (a one-warp launch into
//       s0), then per lane the transform, the weighted p-norm against s0
//       (feature_pnorm.cuh) and K5's epilogue (accept_epilogue.cuh):
//       accept, log weight, hist_min;
//   values mode (terms null): the distances only, for the reservoir's
//       recompute after a refit; bit-equal to the accept's distances under
//       the same parameters.
// mlp_row: the warp stages the row's standardized values in its shared
// buffer; lane l computes the outputs l, l + 32, ... of each layer (at
// most 4 of a hidden layer of width <= 128), each a k-sum in order over
// the previous layer's values (read from the buffer, all lanes the same
// address) and the layer's weights (neighbouring lanes, neighbouring
// columns); tanh, then the next layer from the other buffer. The C' <= 8
// outputs of the head come from lanes 0..C'-1 and are shuffled to every
// lane. The blocks hold the packed layers and mu, sd, ymu, ysd in shared
// memory and walk the rows (a grid of at most two blocks an SM, so the
// layers are read from device memory once a block).
//
// Bound on an H100: at B 65536, S 128, hidden (64, 64), C' 2 about 2 B
// (S 64 + 64 64 + 64 C') = 1.6 GFLOP against 33.5 MB of rows: operations,
// in FP32 FMA (no tensor cores in this design). The simple layout reads
// shared memory for every multiply-add.
#include "accept_epilogue.cuh"
#include "common.cuh"
#include "feature_pnorm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDepth = 4;      // at most three hidden layers
constexpr int kMaxIn = 160;       // S
constexpr int kMaxHidden = 128;   // a hidden layer's width
constexpr int kPerLane = kMaxHidden / 32;
constexpr int kMaxC = kMaxFeatures;
constexpr int kBuf = kMaxIn > kMaxHidden ? kMaxIn : kMaxHidden;

struct Net {
  int depth;                 // layers (hidden + 1)
  int width[kMaxDepth + 1];  // S, H_1, ..., C'
};

// the packed parameters (P floats), then mu, sd (S), ymu, ysd (C') from
// device memory into shared memory
__device__ __forceinline__ void load_params(const Net& net, int P,
                                            const float* params,
                                            const float* mu, const float* sd,
                                            const float* ymu,
                                            const float* ysd, float* sm) {
  const int S = net.width[0], C = net.width[net.depth];
  for (int e = threadIdx.x; e < P; e += blockDim.x) sm[e] = params[e];
  for (int e = threadIdx.x; e < S; e += blockDim.x) {
    sm[P + e] = mu[e];
    sm[P + S + e] = sd[e];
  }
  for (int e = threadIdx.x; e < C; e += blockDim.x) {
    sm[P + 2 * S + e] = ymu[e];
    sm[P + 2 * S + C + e] = ysd[e];
  }
}

// the transform of one row by one warp (pm: the packed layers, then mu,
// sd, ymu, ysd; buf: the warp's 2 kBuf floats); every lane returns all C'
// values
__device__ __forceinline__ void mlp_row(const float* __restrict__ row,
                                        const Net& net, int P,
                                        const float* pm, float* buf,
                                        float (&s)[kMaxC]) {
  const int lane = threadIdx.x & 31;
  const int L = net.depth, S = net.width[0], C = net.width[L];
  const float* mu = pm + P;
  const float* sd = mu + S;
  const float* ymu = sd + S;
  const float* ysd = ymu + C;
  float* a = buf;
  float* b = buf + kBuf;
  for (int k = lane; k < S; k += 32)
    a[k] = __fdiv_rn(__fsub_rn(row[k], mu[k]), sd[k]);
  __syncwarp();
  int off = 0;
  for (int l = 0; l + 1 < L; ++l) {
    const int fi = net.width[l], fo = net.width[l + 1];
    const float* W = pm + off;
    float acc[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) acc[u] = 0.f;
    for (int k = 0; k < fi; ++k) {
      const float v = a[k];
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int j = lane + 32 * u;
        if (j < fo) acc[u] = __fmaf_rn(v, W[k * fo + j], acc[u]);
      }
    }
    const float* bias = W + fi * fo;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int j = lane + 32 * u;
      if (j < fo) b[j] = tanhf(__fadd_rn(acc[u], bias[j]));
    }
    __syncwarp();
    float* t = a;
    a = b;
    b = t;
    off += fi * fo + fo;
  }
  const int fi = net.width[L - 1];
  const float* W = pm + off;
  float out = 0.f;
  if (lane < C) {
    for (int k = 0; k < fi; ++k) out = __fmaf_rn(a[k], W[k * C + lane], out);
    out = __fadd_rn(out, W[fi * C + lane]);
    out = __fadd_rn(__fmul_rn(out, ysd[lane]), ymu[lane]);
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) s[c] = __shfl_sync(0xffffffffu, out, c);
  __syncwarp();  // the buffers are free for the warp's next row
}

__host__ __device__ __forceinline__ size_t smem_floats(const Net& net,
                                                       int P) {
  return (size_t)P + 2 * net.width[0] + 2 * net.width[net.depth] +
         kMaxC + (size_t)kWarps * 2 * kBuf;
}

__global__ void __launch_bounds__(kThreads)
mlp_transform_kernel(const float* __restrict__ x, int n, Net net, int P,
                     const float* __restrict__ params,
                     const float* __restrict__ mu,
                     const float* __restrict__ sd,
                     const float* __restrict__ ymu,
                     const float* __restrict__ ysd, float* __restrict__ out) {
  extern __shared__ float sm[];
  load_params(net, P, params, mu, sd, ymu, ysd, sm);
  __syncthreads();
  const int S = net.width[0], C = net.width[net.depth];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* buf = sm + smem_floats(net, P) - (size_t)(kWarps - warp) * 2 * kBuf;
  for (int r = blockIdx.x * kWarps + warp; r < n; r += gridDim.x * kWarps) {
    float s[kMaxC];
    mlp_row(x + (size_t)r * S, net, P, sm, buf, s);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C && lane == c) out[(size_t)r * C + c] = s[c];
  }
}

__global__ void __launch_bounds__(kThreads)
mlp_accept_kernel(const float* __restrict__ ss, int B, Net net, int P,
                  const float* __restrict__ params,
                  const float* __restrict__ mu, const float* __restrict__ sd,
                  const float* __restrict__ ymu,
                  const float* __restrict__ ysd,
                  const float* __restrict__ s0g, const float* __restrict__ w,
                  float p, bool values, const pyabc::AcceptTerms terms) {
  extern __shared__ float sm[];
  load_params(net, P, params, mu, sd, ymu, ysd, sm);
  const int S = net.width[0], C = net.width[net.depth];
  float* s0 = sm + P + 2 * S + 2 * C;
  if (threadIdx.x < C) s0[threadIdx.x] = s0g[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* buf = sm + smem_floats(net, P) - (size_t)(kWarps - warp) * 2 * kBuf;
  for (int r = blockIdx.x * kWarps + warp; r < B; r += gridDim.x * kWarps) {
    float s[kMaxC];
    mlp_row(ss + (size_t)r * S, net, P, sm, buf, s);
    if (lane != 0) continue;
    const float d = feature_pnorm(s, s0, w, C, p);
    if (values)
      terms.d_out[r] = d;
    else
      pyabc::accept_epilogue(terms, r, d);
  }
}

// the network from the host's widths; 0 or the CUDA error
int make_net(const int* widths, int depth, Net* net, int* P) {
  if (depth < 1 || depth > kMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  net->depth = depth;
  *P = 0;
  for (int l = 0; l <= depth; ++l) net->width[l] = widths[l];
  if (net->width[0] < 1 || net->width[0] > kMaxIn ||
      net->width[depth] < 1 || net->width[depth] > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 1; l < depth; ++l)
    if (net->width[l] < 1 || net->width[l] > kMaxHidden)
      return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < depth; ++l)
    *P += net->width[l] * net->width[l + 1] + net->width[l + 1];
  return 0;
}

// dynamic shared memory above 48 KB for both kernels, raised once; the
// grid: at most two blocks an SM, each walking rows. The first call is
// never inside a graph capture (each wrapper's first call runs eagerly).
int prepare(size_t smem, int rows, int* grid) {
  static int smem_max = -1, sms = 0;
  if (smem_max < 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mlp_transform_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mlp_accept_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    smem_max = optin;
  }
  if ((long long)smem * sizeof(float) > smem_max)
    return static_cast<int>(cudaErrorInvalidValue);
  const int want = (rows + kWarps - 1) / kWarps;
  *grid = want < 2 * sms ? want : 2 * sms;
  return 0;
}

int transform(const float* x, int n, const Net& net, int P,
              const float* params, const float* mu, const float* sd,
              const float* ymu, const float* ysd, float* out,
              cudaStream_t stream) {
  const size_t smem = smem_floats(net, P);
  int grid = 0;
  const int err = prepare(smem, n, &grid);
  if (err) return err;
  mlp_transform_kernel<<<grid, kThreads, smem * sizeof(float), stream>>>(
      x, n, net, P, params, mu, sd, ymu, ysd, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, S) -> out (n, C'); widths a HOST array of depth + 1 ints (S, H_1,
// ..., C'), params the packed layers (each w row-major, then its b), mu,
// sd (S), ymu, ysd (C')
extern "C" int pyabc_mlp_transform(const float* x, int n, const int* widths,
                                   int depth, const float* params,
                                   const float* mu, const float* sd,
                                   const float* ymu, const float* ysd,
                                   float* out, void* stream_ptr) {
  if (n <= 0) return 0;
  Net net;
  int P = 0;
  const int err = make_net(widths, depth, &net, &P);
  if (err) return err;
  return transform(x, n, net, P, params, mu, sd, ymu, ysd, out,
                   static_cast<cudaStream_t>(stream_ptr));
}

// ss (B, S) raw statistics, x0 (S,) raw, the MLP as above, w (C') the
// feature weights, s0 (C') scratch for x0's transform; values != 0: d_out
// only (valid, eps and the other terms unread); else K5's epilogue
// (accept_epilogue.cuh).
extern "C" int pyabc_mlp_accept(
    const float* ss, int B, const int* widths, int depth, const float* x0,
    const float* params, const float* mu, const float* sd, const float* ymu,
    const float* ysd, const float* w, float* s0, float p, int values,
    const uint8_t* valid, const float* eps, const float* hist_min,
    const float* logpri, const float* logq, float log_offset, float* d_out,
    uint8_t* acc_out, float* logw_out, void* stream_ptr) {
  if (B <= 0) return 0;
  if (!values && (valid == nullptr || eps == nullptr || acc_out == nullptr ||
                  logw_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  int P = 0;
  int err = make_net(widths, depth, &net, &P);
  if (err) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  err = transform(x0, 1, net, P, params, mu, sd, ymu, ysd, s0, stream);
  if (err) return err;
  const size_t smem = smem_floats(net, P);
  int grid = 0;
  err = prepare(smem, B, &grid);
  if (err) return err;
  const pyabc::AcceptTerms terms{valid,   eps,     hist_min,
                                 logpri,  logq,    log_offset,
                                 nullptr, nullptr, nullptr,
                                 d_out,   acc_out, logw_out};
  mlp_accept_kernel<<<grid, kThreads, smem * sizeof(float), stream>>>(
      ss, B, net, P, params, mu, sd, ymu, ysd, s0, w, p, values != 0, terms);
  return static_cast<int>(cudaGetLastError());
}
