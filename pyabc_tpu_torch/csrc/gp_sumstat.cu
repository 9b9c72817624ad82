// The GP transform of learned summary statistics (the host-refit mode's
// GPPredictor): s(x) = k(xs, X) @ a + ymu with xs = (x - mu) / sd and
// k_j = exp(-sum_s (xs_s - X_js)^2 / (2 ls^2)), and the p-norm accept of a
// round through it.
//
// Replaces: pyabc_tpu/predictor/predictor.py::GPPredictor.device_predict
// (:354) as pyabc_tpu/distance/pnorm.py::PNormDistance.device_fn
// (:204-219: x and x0 both through the transform) runs it, composed with
// UniformAcceptor.device_fn and the log weight of util.py:400-406; and the
// record ring's transform under an adaptive distance (util.py:1818-1828).
//
// One tile routine serves three entries, so a row transforms to the same
// bits wherever it is transformed:
//   pyabc_gp_transform  (n, S) -> (n, C'): the record ring, x0;
//   pyabc_gp_accept     x0 through the GP once (a one-row launch into s0),
//       then per row the transform, the weighted p-norm against s0
//       (feature_pnorm.cuh) and K5's epilogue (accept_epilogue.cuh);
//   values mode (terms null): the distances only, bit-equal to the
//       accept's under the same parameters.
//
// Bound on an H100: at B 65536, S 128, cap 512, C' 2 the work is
// B cap (2 S + ~10) = 9e9 float32 operations against 33.5 MB of rows:
// operations (about 0.13 ms at 67 TFLOP/s, no tensor cores here).
//
// Design: a block takes a tile of 64 rows, standardizes them into shared
// memory once (the division as the JAX package's, correctly rounded), and
// walks the training points in tiles of 64 staged in shared memory
// (X is cap x S, 256 KB at the leg's shape: more than a block holds). A
// row is shared by 8 threads; each thread owns 2 rows (r, r + 32) and 8
// points of the tile (g, g + 8, ...), so it keeps 16 squared distances in
// registers and reads 16-byte vectors of both tiles (row stride padded to
// 4 mod 32 floats: the 8 threads of a quarter warp hit distinct banks).
// Each squared distance is a sum of direct differences in s order (fmaf of
// the difference with itself; never |x|^2 + |X|^2 - 2 x.X, which loses
// digits for close points; zero padding of s adds exact zeros). Then
// expf of -d2 / (2 ls^2) and k a accumulated per row in point order; the
// 8 threads of a row combine their sums by an xor butterfly of shuffles,
// which gives every one of them the same bits. Training points from the
// last one with a nonzero alpha on are padding (alpha 0 exactly: they add
// nothing) and are skipped.
#include "accept_epilogue.cuh"
#include "common.cuh"
#include "feature_pnorm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 8;                    // threads that share a row
constexpr int kRowSlots = kThreads / kGroups;  // 32
constexpr int kRowTile = 2 * kRowSlots;       // rows a block tile: 64
constexpr int kPointTile = 64;                // training points a tile
constexpr int kPerThread = kPointTile / kGroups;  // 8
constexpr int kMaxS = 256;
constexpr int kMaxC = kMaxFeatures;

struct Gp {
  const float* X;    // (cap, S), standardized training points
  const float* a;    // (cap, C)
  const float* ls;   // () length scale
  const float* mu;   // (S,)
  const float* sd;   // (S,)
  const float* ymu;  // (C,)
  int S, C, cap;
};

// the padded width of a staged row (a multiple of 4) and its stride (4 mod
// 32 floats)
__host__ __device__ __forceinline__ int width4(int S) {
  return (S + 3) / 4 * 4;
}
__host__ __device__ __forceinline__ int stride_of(int S) {
  return (S + 31) / 32 * 32 + 4;
}
__host__ __device__ __forceinline__ size_t smem_bytes(int S) {
  return sizeof(float) *
         ((size_t)(kRowTile + kPointTile) * stride_of(S) +
          (size_t)kPointTile * kMaxC);
}

// 1 + the last training point with a nonzero alpha (every thread returns
// it; one __syncthreads inside)
__device__ int effective_points(const Gp& gp, int* cell) {
  if (threadIdx.x == 0) *cell = 0;
  __syncthreads();
  int last = 0;
  for (int e = threadIdx.x; e < gp.cap * gp.C; e += blockDim.x)
    if (gp.a[e] != 0.f) last = max(last, e / gp.C + 1);
  atomicMax(cell, last);  // integer: the result does not depend on order
  __syncthreads();
  return *cell;
}

// the transform of the block's row tile starting at row0 (rows < n) ->
// every thread of row slot r holds s[0][:] (row r) and s[1][:] (row r + 32)
__device__ void gp_tile(const float* __restrict__ x, int n, int row0,
                        const Gp& gp, int n_eff, float* sm,
                        float (&s)[2][kMaxC]) {
  const int S = gp.S, C = gp.C, W4 = width4(S), st = stride_of(S);
  float* rows = sm;
  float* xs = rows + kRowTile * st;
  float* as = xs + kPointTile * st;
  const int tid = threadIdx.x, r = tid / kGroups, g = tid % kGroups;
  const float two_ls2 = __fmul_rn(2.f, __fmul_rn(gp.ls[0], gp.ls[0]));
  __syncthreads();  // the previous tile's reads are done
  for (int e = tid; e < kRowTile * W4; e += kThreads) {
    const int rr = e / W4, c = e % W4, gr = row0 + rr;
    float v = 0.f;
    if (gr < n && c < S)
      v = __fdiv_rn(__fsub_rn(x[(size_t)gr * S + c], gp.mu[c]), gp.sd[c]);
    rows[rr * st + c] = v;
  }
  float acc[2][kMaxC];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) acc[h][c] = 0.f;
  for (int j0 = 0; j0 < n_eff; j0 += kPointTile) {
    __syncthreads();  // the previous point tile's reads are done
    for (int e = tid; e < kPointTile * W4; e += kThreads) {
      const int jj = e / W4, c = e % W4, j = j0 + jj;
      xs[jj * st + c] =
          (j < n_eff && c < S) ? gp.X[(size_t)j * S + c] : 0.f;
    }
    for (int e = tid; e < kPointTile * C; e += kThreads) {
      const int j = j0 + e / C;
      as[e] = j < n_eff ? gp.a[(size_t)j0 * C + e] : 0.f;
    }
    __syncthreads();
    float d2[2][kPerThread];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) d2[h][u] = 0.f;
    const float* ra = rows + r * st;
    const float* rb = rows + (r + kRowSlots) * st;
    for (int c = 0; c < W4; c += 4) {
      const float4 xa = *reinterpret_cast<const float4*>(ra + c);
      const float4 xb = *reinterpret_cast<const float4*>(rb + c);
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const float4 xv = *reinterpret_cast<const float4*>(
            xs + (g + kGroups * u) * st + c);
        float t = __fsub_rn(xa.x, xv.x);
        d2[0][u] = __fmaf_rn(t, t, d2[0][u]);
        t = __fsub_rn(xa.y, xv.y);
        d2[0][u] = __fmaf_rn(t, t, d2[0][u]);
        t = __fsub_rn(xa.z, xv.z);
        d2[0][u] = __fmaf_rn(t, t, d2[0][u]);
        t = __fsub_rn(xa.w, xv.w);
        d2[0][u] = __fmaf_rn(t, t, d2[0][u]);
        t = __fsub_rn(xb.x, xv.x);
        d2[1][u] = __fmaf_rn(t, t, d2[1][u]);
        t = __fsub_rn(xb.y, xv.y);
        d2[1][u] = __fmaf_rn(t, t, d2[1][u]);
        t = __fsub_rn(xb.z, xv.z);
        d2[1][u] = __fmaf_rn(t, t, d2[1][u]);
        t = __fsub_rn(xb.w, xv.w);
        d2[1][u] = __fmaf_rn(t, t, d2[1][u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int jj = g + kGroups * u;
      if (j0 + jj >= n_eff) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float k = expf(__fdiv_rn(-d2[h][u], two_ls2));
#pragma unroll
        for (int c = 0; c < kMaxC; ++c)
          if (c < C) acc[h][c] = __fmaf_rn(k, as[jj * C + c], acc[h][c]);
      }
    }
  }
  // the 8 threads of a row: an xor butterfly (a + b == b + a, so all 8
  // end with the same bits), then + ymu
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      float v = acc[h][c];
#pragma unroll
      for (int off = kGroups / 2; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      s[h][c] = c < C ? __fadd_rn(v, gp.ymu[c]) : 0.f;
    }
}

__global__ void __launch_bounds__(kThreads)
gp_transform_kernel(const float* __restrict__ x, int n, Gp gp,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int n_eff_cell;
  const int n_eff = effective_points(gp, &n_eff_cell);
  const int r = threadIdx.x / kGroups, g = threadIdx.x % kGroups;
  for (int row0 = blockIdx.x * kRowTile; row0 < n;
       row0 += gridDim.x * kRowTile) {
    float s[2][kMaxC];
    gp_tile(x, n, row0, gp, n_eff, sm, s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + r + h * kRowSlots;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < gp.C && c == g && row < n)
          out[(size_t)row * gp.C + c] = s[h][c];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gp_accept_kernel(const float* __restrict__ ss, int B, Gp gp,
                 const float* __restrict__ s0g, const float* __restrict__ w,
                 float p, bool values, const pyabc::AcceptTerms terms) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int n_eff_cell;
  __shared__ float s0[kMaxC];
  if (threadIdx.x < gp.C) s0[threadIdx.x] = s0g[threadIdx.x];
  const int n_eff = effective_points(gp, &n_eff_cell);  // syncs s0 too
  const int r = threadIdx.x / kGroups, g = threadIdx.x % kGroups;
  for (int row0 = blockIdx.x * kRowTile; row0 < B;
       row0 += gridDim.x * kRowTile) {
    float s[2][kMaxC];
    gp_tile(ss, B, row0, gp, n_eff, sm, s);
    if (g != 0) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + r + h * kRowSlots;
      if (row >= B) continue;
      const float d = feature_pnorm(s[h], s0, w, gp.C, p);
      if (values)
        terms.d_out[row] = d;
      else
        pyabc::accept_epilogue(terms, row, d);
    }
  }
}

// dynamic shared memory above 48 KB for both kernels, raised once; the
// grid: one block a row tile. The first call is never inside a graph
// capture (each wrapper's first call runs eagerly).
int prepare(int S, int rows, int* grid) {
  static int smem_max = -1;
  if (smem_max < 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    // the static cells (n_eff, s0) sit beside the dynamic buffer
    const int dyn = optin - 64;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gp_transform_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 dyn);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gp_accept_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 dyn);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    smem_max = dyn;
  }
  if ((long long)smem_bytes(S) > smem_max)
    return static_cast<int>(cudaErrorInvalidValue);
  *grid = (rows + kRowTile - 1) / kRowTile;
  return 0;
}

int make_gp(int S, int C, int cap, const float* X, const float* a,
            const float* ls, const float* mu, const float* sd,
            const float* ymu, Gp* gp) {
  if (S < 1 || S > kMaxS || C < 1 || C > kMaxC || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  *gp = Gp{X, a, ls, mu, sd, ymu, S, C, cap};
  return 0;
}

int transform(const float* x, int n, const Gp& gp, float* out,
              cudaStream_t stream) {
  int grid = 0;
  const int err = prepare(gp.S, n, &grid);
  if (err) return err;
  gp_transform_kernel<<<grid, kThreads, smem_bytes(gp.S), stream>>>(x, n, gp,
                                                                    out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, S) -> out (n, C'); X (cap, S), a (cap, C'), ls (), mu, sd (S),
// ymu (C'), all device pointers
extern "C" int pyabc_gp_transform(const float* x, int n, int S, int C,
                                  int cap, const float* X, const float* a,
                                  const float* ls, const float* mu,
                                  const float* sd, const float* ymu,
                                  float* out, void* stream_ptr) {
  if (n <= 0) return 0;
  Gp gp;
  const int err = make_gp(S, C, cap, X, a, ls, mu, sd, ymu, &gp);
  if (err) return err;
  return transform(x, n, gp, out, static_cast<cudaStream_t>(stream_ptr));
}

// ss (B, S) raw statistics, x0 (S,) raw, the GP as above, w (C') the
// feature weights, s0 (C') scratch for x0's transform; values != 0: d_out
// only (valid, eps and the other terms unread); else K5's epilogue
// (accept_epilogue.cuh).
extern "C" int pyabc_gp_accept(
    const float* ss, int B, int S, int C, int cap, const float* x0,
    const float* X, const float* a, const float* ls, const float* mu,
    const float* sd, const float* ymu, const float* w, float* s0, float p,
    int values, const uint8_t* valid, const float* eps,
    const float* hist_min, const float* logpri, const float* logq,
    float log_offset, float* d_out, uint8_t* acc_out, float* logw_out,
    void* stream_ptr) {
  if (B <= 0) return 0;
  if (!values && (valid == nullptr || eps == nullptr || acc_out == nullptr ||
                  logw_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Gp gp;
  int err = make_gp(S, C, cap, X, a, ls, mu, sd, ymu, &gp);
  if (err) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  err = transform(x0, 1, gp, s0, stream);
  if (err) return err;
  int grid = 0;
  err = prepare(S, B, &grid);
  if (err) return err;
  const pyabc::AcceptTerms terms{valid,   eps,     hist_min,
                                 logpri,  logq,    log_offset,
                                 nullptr, nullptr, nullptr,
                                 d_out,   acc_out, logw_out};
  gp_accept_kernel<<<grid, kThreads, smem_bytes(S), stream>>>(
      ss, B, gp, s0, w, p, values != 0, terms);
  return static_cast<int>(cudaGetLastError());
}
