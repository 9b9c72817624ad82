// K22 moments: the moment fold of a segmented round and the moment finish of
// the adaptive refit under segmented early reject.
//
// Replaces: pyabc_tpu/ops/scale_reduce.py::{init_moments (:54),
// accumulate_moments (:67), combine_moments (:102), scale_from_moments
// (:115)} as pyabc_tpu/inference/util.py builds them into the segmented
// engine (the per-column take at :1139-1157) and the generation step
// (:1541-1571, :1828-1834), with the weight update and the recompute of
// weights.cuh (K9's, shared).
//
// Fold: after K18's round, the (6, S) float32 block mom (sum, sum of
// squares, sum of |x - x0|, count, max, min per column) takes ss[b, c] of
// every slot b that is valid, whose slot index in the generation,
// counters[1] * B + b, is below rec_cap, and whose simulated segments
// (nseg[b], K18's count) include column c's segment (seg_of[c]): a
// completed slot every column, a retired slot its prefix. A retired row's
// other columns were never written and are never read. The round's sums
// are added to the block, the extrema merged (NaN propagates, as jnp's).
// Sums run in a fixed order: pass 1 gives each (column, part of the rows)
// a block whose threads take fixed rows and reduce by a fixed tree into
// part (P, 6, S); pass 2 gives each column a warp that adds its P parts by
// fixed lanes and a fixed shuffle tree. K18 hands slots to threads through
// a device counter, so folding inside K18 with atomics would give sums
// that change from run to run; here the sums depend on the data only. The
// round index is read on the device: the fold costs no host read.
//
// Finish: one block turns the block into the (S,) scale (moments.cuh's
// scale_of: n = max(count, 1), mean = sum / n, the one-pass variance
// max(E[x^2] - mean^2, 0) of the JAX package), then weights.cuh's weights
// (1 / scale, the max_weight_ratio clip, mean 1) and the weighted p-norm
// distances of the accepted rows under them. The scales are written with the _rn
// intrinsics: one rounding per operation, as the plain version's.
//
// Shard mode (K24d, sharded fused sampling under an adaptive distance):
// replaces accumulate_moments per shard in the vmapped _generation_while
// (pyabc_tpu/inference/util.py:2404-2420 with moment_cfg), combine_moments
// over the shards and the dfeat recompute (:2672-2700). The fold gives
// each (column, shard) one block: a shard that is finished (its n_acc at
// its quota of counters[4], or its rounds at max_rounds; read before the
// round's compaction) folds nothing; else its valid lanes of the round
// whose local slot rounds * B_loc + b is below rec_cap take their whole
// row, reduced by a fixed tree and added to that shard's (6, S) block of
// the (n, 6, S) array: the same data gives the same bits. The finish
// combines the shards in shard order (sums in order 0..n-1, extrema
// merged) into a (6, S) block, runs the finish below on it, and
// recomputes each reservoir row's distance from its stored feature row
// (|x - x0|^p, written by K24a) as (sum_c w_c^p f_c)^(1/p) (max_c w_c f_c
// at p = inf), the JAX package's declared floating-point form.
//
// Bound on an H100: bytes. The fold needs valid for the round's slots
// below rec_cap, nseg for the valid ones, and the 4 bytes of each cell it
// takes (a retired slot's prefix only): at most B x S floats and B x 5
// bytes a round (5.6 MB at config 3's B 65536, S 20), nothing for a round
// past the window. Pass 1 reads each column strided, so the card fetches
// whole sectors of the rows and again from L2 for each column a sector
// holds. The finish reads the (6, S) block and the rows (n_cap x S).
#include "moments.cuh"

namespace {

using pyabc_m::kRows;
using pyabc_m::kStdObs;

constexpr int kThreads = 256;
constexpr int kRoundsCounter = 1;  // counters layout: n_acc, rounds, ...

__global__ void __launch_bounds__(kThreads)
fold_part_kernel(const float* __restrict__ ss, int B, int S,
                 const int* __restrict__ nseg,
                 const uint8_t* __restrict__ valid,
                 const int* __restrict__ seg_of, const float* __restrict__ x0,
                 const int* __restrict__ counters, long long rec_cap,
                 int rows_per_part, float* __restrict__ part) {
  __shared__ float s_warp[32];
  const int c = blockIdx.x, pi = blockIdx.y;
  const int lo = pi * rows_per_part;
  // the slots below rec_cap only: a part past the window reads nothing
  const long long first = (long long)counters[kRoundsCounter] * B;
  const int hi = (int)min((long long)min(B, lo + rows_per_part),
                          max(rec_cap - first, 0LL));
  const int col_seg = seg_of[c];
  const float xo = x0[c];
  float s = 0.f, sq = 0.f, ad = 0.f, cnt = 0.f, mx = -INFINITY,
        mn = INFINITY;
  for (int b = lo + (int)threadIdx.x; b < hi; b += blockDim.x) {
    if (!valid[b] || col_seg >= nseg[b]) continue;
    const float x = ss[(size_t)b * S + c];
    s += x;
    sq += x * x;
    ad += fabsf(x - xo);
    cnt += 1.f;
    mx = nan_max(mx, x);
    mn = pyabc_w::nan_min(mn, x);
  }
  s = pyabc_w::block_reduce(s, 0, s_warp);
  sq = pyabc_w::block_reduce(sq, 0, s_warp);
  ad = pyabc_w::block_reduce(ad, 0, s_warp);
  cnt = pyabc_w::block_reduce(cnt, 0, s_warp);
  mx = pyabc_w::block_reduce(mx, 1, s_warp);
  mn = pyabc_w::block_reduce(mn, 2, s_warp);
  if (threadIdx.x == 0) {
    float* out = part + (size_t)pi * kRows * S + c;
    out[0] = s;
    out[S] = sq;
    out[2 * S] = ad;
    out[3 * S] = cnt;
    out[4 * S] = mx;
    out[5 * S] = mn;
  }
}

// One warp per column: lane l takes parts l, l + 32, ... in order, then a
// fixed shuffle tree; the round's totals are added to the block.
__global__ void __launch_bounds__(kThreads)
fold_add_kernel(float* __restrict__ mom, int S,
                const float* __restrict__ part, int parts) {
  const int c = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= S) return;  // whole warps leave together
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float mx = -INFINITY, mn = INFINITY;
  for (int pi = lane; pi < parts; pi += 32) {
    const float* p = part + (size_t)pi * kRows * S + c;
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r] += p[r * S];
    mx = nan_max(mx, p[4 * S]);
    mn = pyabc_w::nan_min(mn, p[5 * S]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) s[r] = warp_sum(s[r]);
  mx = warp_nan_max(mx);
  for (int off = 16; off > 0; off >>= 1)
    mn = pyabc_w::nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) mom[r * S + c] = mom[r * S + c] + s[r];
  mom[4 * S + c] = nan_max(mom[4 * S + c], mx);
  mom[5 * S + c] = pyabc_w::nan_min(mom[5 * S + c], mn);
}

__global__ void __launch_bounds__(1024)
finish_kernel(int code, int S, const float* __restrict__ mom,
              const float* __restrict__ x0, float max_ratio, int normalize,
              float* __restrict__ scale_out, float* __restrict__ w_out) {
  __shared__ float s_warp[32];
  pyabc_w::finish_weights(
      [&](int c) { return pyabc_m::scale_of(code, c, S, mom, x0[c]); }, S,
      max_ratio, normalize, scale_out, w_out, s_warp);
}

__device__ __forceinline__ int shard_running(const int* counters,
                                              const int* table, int s,
                                              int n_shards, int max_rounds) {
  const int n_tgt = counters[4];
  const int quota = n_tgt / n_shards + (s < n_tgt % n_shards ? 1 : 0);
  return table[4 * s] < quota && table[4 * s + 1] < max_rounds;
}

// grid (S, n_shards): block (c, s) folds column c of shard s's lanes
__global__ void __launch_bounds__(kThreads)
fold_shards_kernel(float* __restrict__ mom, const float* __restrict__ ss,
                   int B_loc, int S, const uint8_t* __restrict__ valid,
                   const float* __restrict__ x0,
                   const int* __restrict__ counters,
                   const int* __restrict__ table, int n_shards,
                   long long rec_cap, int max_rounds) {
  __shared__ float s_warp[32];
  const int c = blockIdx.x, s = blockIdx.y;
  if (!shard_running(counters, table, s, n_shards, max_rounds)) return;
  const long long first = (long long)table[4 * s + 1] * B_loc;
  const int hi = (int)min((long long)B_loc, max(rec_cap - first, 0LL));
  const size_t lane0 = (size_t)s * B_loc;
  const float xo = x0[c];
  float sm = 0.f, sq = 0.f, ad = 0.f, cnt = 0.f, mx = -INFINITY,
        mn = INFINITY;
  for (int b = (int)threadIdx.x; b < hi; b += blockDim.x) {
    if (!valid[lane0 + b]) continue;
    const float x = ss[(lane0 + b) * S + c];
    sm += x;
    sq += x * x;
    ad += fabsf(x - xo);
    cnt += 1.f;
    mx = nan_max(mx, x);
    mn = pyabc_w::nan_min(mn, x);
  }
  sm = pyabc_w::block_reduce(sm, 0, s_warp);
  sq = pyabc_w::block_reduce(sq, 0, s_warp);
  ad = pyabc_w::block_reduce(ad, 0, s_warp);
  cnt = pyabc_w::block_reduce(cnt, 0, s_warp);
  mx = pyabc_w::block_reduce(mx, 1, s_warp);
  mn = pyabc_w::block_reduce(mn, 2, s_warp);
  if (threadIdx.x != 0) return;
  float* out = mom + (size_t)s * kRows * S + c;
  out[0] = out[0] + sm;
  out[S] = out[S] + sq;
  out[2 * S] = out[2 * S] + ad;
  out[3 * S] = out[3 * S] + cnt;
  out[4 * S] = nan_max(out[4 * S], mx);
  out[5 * S] = pyabc_w::nan_min(out[5 * S], mn);
}

// one warp a row: (sum_c w_c^p f_c)^(1/p), max_c w_c f_c at p = inf
__global__ void __launch_bounds__(kThreads)
feature_rows_kernel(const float* __restrict__ feat, int n_rows, int S,
                    const float* __restrict__ w, float p,
                    float* __restrict__ d_out) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;
  const float* row = feat + (size_t)r * S;
  const bool p_inf = isinf(p);
  float acc = 0.f;
  for (int k = lane; k < S; k += 32) {
    const float wk = w[k];
    if (p_inf) {
      acc = nan_max(acc, wk * row[k]);
    } else {
      const float wp = p == 2.f ? wk * wk : p == 1.f ? wk : powf(wk, p);
      acc += wp * row[k];
    }
  }
  acc = p_inf ? warp_nan_max(acc) : warp_sum(acc);
  if (lane != 0) return;
  d_out[r] = p_inf || p == 1.f ? acc
             : p == 2.f        ? sqrtf(acc)
                               : powf(acc, 1.f / p);
}

}  // namespace

// mom: n_shards x 6 x S, folded in place.
extern "C" int pyabc_moment_fold_shards(float* mom, const float* ss,
                                        int n_shards, int B_loc, int S,
                                        const uint8_t* valid, const float* x0,
                                        const int* counters, const int* table,
                                        long long rec_cap, int max_rounds,
                                        void* stream_ptr) {
  if (n_shards <= 0 || B_loc <= 0 || S <= 0 || n_shards > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  fold_shards_kernel<<<dim3(S, n_shards), kThreads, 0, stream>>>(
      mom, ss, B_loc, S, valid, x0, counters, table, n_shards, rec_cap,
      max_rounds);
  return static_cast<int>(cudaGetLastError());
}

// parts: n_shards x 6 x S; mom_out: 6 x S of scratch (the combined block).
extern "C" int pyabc_moment_finish_shards(
    const float* parts, int n_shards, int S, const float* x0, int code,
    float max_ratio, int normalize, const float* feat, int n_rows, float p,
    float* mom_out, float* scale_out, float* w_out, float* d_out,
    void* stream_ptr) {
  if (n_shards <= 0 || S <= 0 || code < 0 || code > kStdObs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  pyabc_m::combine_shards(parts, n_shards, S, mom_out, stream);
  finish_kernel<<<1, 1024, 0, stream>>>(code, S, mom_out, x0, max_ratio,
                                        normalize, scale_out, w_out);
  if (feat != nullptr && n_rows > 0) {
    const int per_block = kThreads / 32;
    feature_rows_kernel<<<(n_rows + per_block - 1) / per_block, kThreads, 0,
                          stream>>>(feat, n_rows, S, w_out, p, d_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// part: parts x 6 x S floats of scratch.
extern "C" int pyabc_moment_fold(float* mom, const float* ss, int B, int S,
                                 const int* nseg, const uint8_t* valid,
                                 const int* seg_of, const float* x0,
                                 const int* counters, long long rec_cap,
                                 int parts, float* part, void* stream_ptr) {
  if (B <= 0) return 0;
  if (S <= 0 || parts <= 0 || parts > 65535 || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows_per_part = (B + parts - 1) / parts;
  fold_part_kernel<<<dim3(S, parts), kThreads, 0, stream>>>(
      ss, B, S, nseg, valid, seg_of, x0, counters, rec_cap, rows_per_part,
      part);
  const int warps = kThreads / 32;
  fold_add_kernel<<<(S + warps - 1) / warps, kThreads, 0, stream>>>(
      mom, S, part, parts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pyabc_moment_finish(const float* mom, int S, const float* x0,
                                   int code, float max_ratio, int normalize,
                                   const float* rows, int n_rows, float p,
                                   float* scale_out, float* w_out,
                                   float* d_out, void* stream_ptr) {
  if (S <= 0 || code < 0 || code > kStdObs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  finish_kernel<<<1, 1024, 0, stream>>>(code, S, mom, x0, max_ratio,
                                        normalize, scale_out, w_out);
  pyabc_w::launch_rows(rows, n_rows, S, x0, w_out, p, d_out, stream);
  return static_cast<int>(cudaGetLastError());
}
