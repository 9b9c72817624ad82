// K25 aggregate: the aggregated distance of a proposal round and its
// adaptive refit.
//
// Replaces: pyabc_tpu/distance/aggregate.py::AggregatedDistance.device_fn
// (:73) composed with UniformAcceptor.device_fn and the log weight (as K5
// does), AdaptiveAggregatedDistance.device_record_reduce (:244) and
// device_weight_update (:351), and the recompute of the accepted rows'
// distances under the new weights (pyabc_tpu/inference/util.py:1847).
//
// The distance's parameters are one flat float32 vector
//   params = [W (n), w_1 (S), ..., w_n (S)]
// with W the top-level weights times the factors and w_k the k-th
// sub-distance's weights (times its factors); each sub-distance is a plain
// weighted p-norm d_k = (sum_c (w_k,c |x_c - x0_c|)^p_k)^(1/p_k) (p_k = inf:
// the max, NaN kept) and d = sum_k W_k d_k in the order k = 0..n-1, each
// step rounded (_rn). n <= 8 and the p_k come by value.
//
// - accept (pyabc_aggregate_accept): one warp per lane reads the row once;
//   each thread keeps the n sub-accumulators in registers, the warp reduces
//   them, lane 0 forms d and runs K5's epilogue (accept_epilogue.cuh: the
//   accept test, hist_min and the log weight, with K5's nullable K > 1
//   model terms). The values mode (vals non-null, the epilogue's outputs
//   null) writes the (B, n) sub-distances instead; a launch may do both.
// - refit (pyabc_aggregate_refit), three steps in one stream:
//   1. the values mode over the ring's rows -> vals (n_rec, n);
//   2. the column scale of vals over the valid rows against a zero
//      observation: span (max - min, the default) in one block a column
//      here; any other one-argument scale through K9's entry
//      (scale_reduce.cu, its radix selection and moments) with neither the
//      ratio clip nor the normalization;
//   3. one launch: block 0 writes params_out = [W', w_1, ..., w_n] with
//      W'_k = factors_k / max(scale_k, 1e-38) where scale_k > 0, else 0
//      (no clip, no normalization: device_weight_update), and one warp a
//      reservoir row writes its aggregated distance under W'.
// - sharded finish (pyabc_aggregate_finish_shards; sharded fused sampling
//   under an AdaptiveAggregatedDistance, replacing combine_moments and
//   scale_from_moments of pyabc_tpu/ops/scale_reduce.py:102, :115 over
//   device_sharded_reduce's value columns (aggregate.py:298), then
//   device_weight_update (:351) and device_sharded_dfeat's combine (:345)):
//   1. moments.cuh's combine of the n shards' (6, n_sub) moment blocks of
//      the value columns, in shard order;
//   2. one launch: every thread finishes the n_sub scales from the
//      combined block against a zero observation (moments.cuh's scale_of)
//      and W' as in step 3 above; block 0 writes the scale and params_out
//      (the sub weights copied), and one thread a reservoir row writes
//      sum_k W'_k f_k of its stored value row f (K24a's copy of the accept's
//      values) with combine below: the distance K25's accept gives that row
//      under W', bit for bit.
//
// Bound on an H100: bytes. The accept reads the (B, S) sum stats once (the
// sub weights, n S floats, stay in L1/L2); the refit reads the ring once
// (131072 x 40 floats, 21 MB, at the LV leg's size), vals n times for the
// scale and the reservoir once; the sharded finish reads the blocks and
// the (n_cap, n) value rows once and writes n_cap distances (0.2 MB at the
// LV leg's size): a few microseconds of launches. A simple kernel: no
// shared-memory staging, the n sub-norms unrolled over registers.
#include "accept_epilogue.cuh"
#include "common.cuh"
#include "moments.cuh"
#include "weights.cuh"

// K9's entry (scale_reduce.cu), linked into the same library
extern "C" int pyabc_scale_reduce(const float* samples, int n, int S,
                                  const uint8_t* valid, const float* x0,
                                  int code, float max_ratio, int normalize,
                                  const float* rows, int n_rows, float p,
                                  void* workspace, float* stats,
                                  float* scale_out, float* w_out, float* d_out,
                                  void* stream_ptr);

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSub = 8;
// the p of a sub-distance: 1, 2, inf or another p >= 1
enum PCode { kP1 = 0, kP2 = 1, kPInf = 2, kPGen = 3 };

// the sub-distances' norms, passed by value
struct SubNorms {
  int n;
  int code[kMaxSub];
  float p[kMaxSub];
  float factor[kMaxSub];  // the refit's top-level factors
};

// The n sub-distances of one row (the calling warp's), on every lane.
__device__ __forceinline__ void sub_distances(const float* __restrict__ row,
                                              int S,
                                              const float* __restrict__ x0,
                                              const float* __restrict__ subw,
                                              const SubNorms& sn, float* d) {
  const int lane = threadIdx.x & 31;
  float acc[kMaxSub];
#pragma unroll
  for (int j = 0; j < kMaxSub; ++j) acc[j] = 0.f;
  for (int c = lane; c < S; c += 32) {
    const float dx = fabsf(row[c] - x0[c]);
#pragma unroll
    for (int j = 0; j < kMaxSub; ++j) {
      if (j >= sn.n) break;
      const float diff = subw[(size_t)j * S + c] * dx;
      const int code = sn.code[j];
      if (code == kPInf)
        acc[j] = nan_max(acc[j], diff);
      else if (code == kP1)
        acc[j] += diff;
      else if (code == kP2)
        acc[j] += diff * diff;
      else
        acc[j] += powf(diff, sn.p[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxSub; ++j) {
    if (j >= sn.n) break;
    const int code = sn.code[j];
    const float a = code == kPInf ? warp_nan_max(acc[j]) : warp_sum(acc[j]);
    d[j] = code == kP2 ? sqrtf(a) : code == kPGen ? powf(a, 1.f / sn.p[j]) : a;
  }
}

// sum_k W_k d_k in order, each step rounded
__device__ __forceinline__ float combine(const float* W, const float* d,
                                         int n) {
  float tot = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxSub; ++j) {
    if (j >= n) break;
    tot = __fadd_rn(tot, __fmul_rn(W[j], d[j]));
  }
  return tot;
}

__global__ void __launch_bounds__(kThreads)
aggregate_accept_kernel(const float* __restrict__ ss, int B, int S,
                        const float* __restrict__ x0,
                        const float* __restrict__ params, const SubNorms sn,
                        const pyabc::AcceptTerms terms,
                        float* __restrict__ vals) {
  const int row_i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row_i >= B) return;  // whole warps exit together
  float d[kMaxSub];
  sub_distances(ss + (size_t)row_i * S, S, x0, params + sn.n, sn, d);
  if ((threadIdx.x & 31) != 0) return;
  if (vals != nullptr) {
#pragma unroll
    for (int j = 0; j < kMaxSub; ++j)
      if (j < sn.n) vals[(size_t)row_i * sn.n + j] = d[j];
  }
  if (terms.d_out == nullptr) return;  // the values mode alone
  float W[kMaxSub];
#pragma unroll
  for (int j = 0; j < kMaxSub; ++j) W[j] = j < sn.n ? params[j] : 0.f;
  pyabc::accept_epilogue(terms, row_i, combine(W, d, sn.n));
}

// span of each value column over the valid rows, one block a column
__global__ void __launch_bounds__(kThreads)
span_kernel(const float* __restrict__ vals, int n_rec, int n_sub,
            const uint8_t* __restrict__ valid, float* __restrict__ scale) {
  __shared__ float s_warp[32];
  const int c = blockIdx.x;
  float mx = -INFINITY, mn = INFINITY;
  for (int i = threadIdx.x; i < n_rec; i += blockDim.x) {
    if (!valid[i]) continue;
    const float x = vals[(size_t)i * n_sub + c];
    mx = nan_max(mx, x);
    mn = pyabc_w::nan_min(mn, x);
  }
  mx = pyabc_w::block_reduce(mx, 1, s_warp);
  mn = pyabc_w::block_reduce(mn, 2, s_warp);
  if (threadIdx.x == 0) scale[c] = mx - mn;
}

// W' from the scale; block 0 writes the new params, a warp a row its
// aggregated distance under W'
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ rows, int n_rows, int S,
              const float* __restrict__ x0,
              const float* __restrict__ params, const SubNorms sn,
              const float* __restrict__ scale,
              float* __restrict__ params_out, float* __restrict__ d_out) {
  float W[kMaxSub];
#pragma unroll
  for (int j = 0; j < kMaxSub; ++j) {
    const float s = j < sn.n ? scale[j] : 0.f;
    W[j] = s > 0.f ? __fmul_rn(1.f / fmaxf(s, 1e-38f), sn.factor[j]) : 0.f;
  }
  if (blockIdx.x == 0) {
    const int P = sn.n + sn.n * S;
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      float v = params[i];
#pragma unroll
      for (int j = 0; j < kMaxSub; ++j)
        if (j == i && j < sn.n) v = W[j];
      params_out[i] = v;
    }
  }
  const int row_i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row_i >= n_rows) return;
  float d[kMaxSub];
  sub_distances(rows + (size_t)row_i * S, S, x0, params + sn.n, sn, d);
  if ((threadIdx.x & 31) == 0) d_out[row_i] = combine(W, d, sn.n);
}

// the sharded finish: each thread finishes W' from the combined block;
// block 0 writes the scale and the new params, a thread a row its distance
__global__ void __launch_bounds__(kThreads)
finish_shards_kernel(const float* __restrict__ mom, int n_sub, int S,
                     int code, const SubNorms sn,
                     const float* __restrict__ params,
                     const float* __restrict__ feat, int n_rows,
                     float* __restrict__ scale_out,
                     float* __restrict__ params_out,
                     float* __restrict__ d_out) {
  float sc[kMaxSub], W[kMaxSub];
#pragma unroll
  for (int j = 0; j < kMaxSub; ++j) {
    sc[j] = j < n_sub ? pyabc_m::scale_of(code, j, n_sub, mom, 0.f) : 0.f;
    W[j] = sc[j] > 0.f ? __fmul_rn(1.f / fmaxf(sc[j], 1e-38f), sn.factor[j])
                       : 0.f;
  }
  if (blockIdx.x == 0) {
    const int P = n_sub + n_sub * S;
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      float v = params[i];
#pragma unroll
      for (int j = 0; j < kMaxSub; ++j)
        if (j == i && j < n_sub) v = W[j];
      params_out[i] = v;
    }
#pragma unroll
    for (int j = 0; j < kMaxSub; ++j)
      if (j == (int)threadIdx.x && j < n_sub) scale_out[j] = sc[j];
  }
  const int row_i = blockIdx.x * blockDim.x + threadIdx.x;
  if (row_i >= n_rows) return;
  d_out[row_i] = combine(W, feat + (size_t)row_i * n_sub, n_sub);
}

bool norms_of(int n_sub, const int* codes, const float* ps,
              const float* factors, SubNorms* sn) {
  if (n_sub < 1 || n_sub > kMaxSub || codes == nullptr || ps == nullptr)
    return false;
  *sn = SubNorms{};
  sn->n = n_sub;
  for (int j = 0; j < n_sub; ++j) {
    if (codes[j] < kP1 || codes[j] > kPGen) return false;
    sn->code[j] = codes[j];
    sn->p[j] = ps[j];
    sn->factor[j] = factors != nullptr ? factors[j] : 1.f;
  }
  return true;
}

int warps_grid(int rows) {
  const int per_block = kThreads / 32;
  return (rows + per_block - 1) / per_block;
}

}  // namespace

// ss (B, S), x0 (S,), params (n_sub + n_sub S,); codes and ps host arrays
// of n_sub. The epilogue's pointers as K5's (d_out null: no accept test);
// vals null or (B, n_sub).
extern "C" int pyabc_aggregate_accept(
    const float* ss, int B, int S, const float* x0, const float* params,
    int n_sub, const int* codes, const float* ps, const uint8_t* valid,
    const float* eps, const float* hist_min, const float* logpri,
    const float* logq, float log_offset, const int* m,
    const float* model_logits, const float* log_model_factor, float* d_out,
    uint8_t* acc_out, float* logw_out, float* vals, void* stream_ptr) {
  if (B <= 0) return 0;
  SubNorms sn;
  if (!norms_of(n_sub, codes, ps, nullptr, &sn) || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d_out == nullptr && vals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d_out != nullptr &&
      (valid == nullptr || eps == nullptr || acc_out == nullptr ||
       logw_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m != nullptr && (model_logits == nullptr ||
                       log_model_factor == nullptr || logpri == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const pyabc::AcceptTerms terms{valid,      eps,     hist_min,
                                 logpri,     logq,    log_offset,
                                 m,          model_logits,
                                 log_model_factor,    d_out,
                                 acc_out,    logw_out};
  aggregate_accept_kernel<<<warps_grid(B), kThreads, 0,
                            static_cast<cudaStream_t>(stream_ptr)>>>(
      ss, B, S, x0, params, sn, terms, vals);
  return static_cast<int>(cudaGetLastError());
}

// ring (n_rec, S) under valid (n_rec,); scale_code < 0: span, else K9's
// code of a one-argument scale; zeros (n_sub,) the zero observation of the
// value columns; vals (n_rec, n_sub), workspace and stats (8 n_sub floats)
// K9's scratch, w_scratch (n_sub,); rows (n_rows, S) -> scale (n_sub,),
// params_out, d_out (n_rows,).
extern "C" int pyabc_aggregate_refit(
    const float* ring, int n_rec, int S, const uint8_t* valid,
    const float* x0, const float* params, int n_sub, const int* codes,
    const float* ps, const float* factors, int scale_code,
    const float* rows, int n_rows, float* vals, const float* zeros,
    void* workspace, float* stats, float* w_scratch, float* scale,
    float* params_out, float* d_out, void* stream_ptr) {
  SubNorms sn;
  if (!norms_of(n_sub, codes, ps, factors, &sn) || S <= 0 || n_rec < 0 ||
      n_rows < 0 || (n_rows > 0 && (rows == nullptr || d_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rec > 0) {
    const pyabc::AcceptTerms none{};
    aggregate_accept_kernel<<<warps_grid(n_rec), kThreads, 0, stream>>>(
        ring, n_rec, S, x0, params, sn, none, vals);
  }
  if (scale_code < 0) {
    span_kernel<<<n_sub, kThreads, 0, stream>>>(vals, n_rec, n_sub, valid,
                                                 scale);
  } else {
    const int err = pyabc_scale_reduce(
        vals, n_rec, n_sub, valid, zeros, scale_code, 0.f, 0, nullptr, 0,
        2.f, workspace, stats, scale, w_scratch, nullptr, stream);
    if (err != 0) return err;
  }
  finish_kernel<<<warps_grid(n_rows > 0 ? n_rows : 1), kThreads, 0,
                  stream>>>(rows, n_rows, S, x0, params, sn, scale,
                            params_out, d_out);
  return static_cast<int>(cudaGetLastError());
}

// parts (n_shards, 6, n_sub) the shards' moment blocks of the value
// columns; scale_code moments.cu's code (0 mean ... 6); factors a host
// array of n_sub; params (n_sub + n_sub S,) the params in effect (their sub
// weights are copied); feat (n_rows, n_sub) the reservoir's value rows;
// mom_out (6, n_sub) scratch -> scale_out (n_sub,), params_out, d_out
// (n_rows,).
extern "C" int pyabc_aggregate_finish_shards(
    const float* parts, int n_shards, int n_sub, int S, int scale_code,
    const float* factors, const float* params, const float* feat,
    int n_rows, float* mom_out, float* scale_out, float* params_out,
    float* d_out, void* stream_ptr) {
  if (n_shards <= 0 || n_sub < 1 || n_sub > kMaxSub || S <= 0 ||
      factors == nullptr || scale_code < 0 || scale_code > pyabc_m::kStdObs ||
      n_rows < 0 || (n_rows > 0 && (feat == nullptr || d_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  SubNorms sn{};
  sn.n = n_sub;
  for (int j = 0; j < n_sub; ++j) sn.factor[j] = factors[j];
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  pyabc_m::combine_shards(parts, n_shards, n_sub, mom_out, stream);
  const int blocks = n_rows > 0 ? (n_rows + kThreads - 1) / kThreads : 1;
  finish_shards_kernel<<<blocks, kThreads, 0, stream>>>(
      mom_out, n_sub, S, scale_code, sn, params, feat, n_rows, scale_out,
      params_out, d_out);
  return static_cast<int>(cudaGetLastError());
}
