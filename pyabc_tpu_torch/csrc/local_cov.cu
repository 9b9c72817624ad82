// K12 local_cov: LocalTransition's k-nearest-neighbour covariance field.
//
// Replaces: pyabc_tpu/transition/local_transition.py::_device_cov_field
// with pyabc_tpu/ops/select.py::{radius_bisect, compact_within_radius,
// threshold_neighbors} (the plain twin is kernels/local_cov.py).
//
// Two launches on the caller's stream, skipped at once when the refit
// flag in device memory reads 0 (K15's cadence decision, no host branch):
//
// 1. prep (one block): w = weights / max(sum, 1e-38), the valid count
//    c = #(weights > 0), X = thetas * vmask, |x|^2 per row (the norm form),
//    k_dyn = min(k_table[c], k_cap) with the table built on the host in
//    float64 (an f32 product would round differently), the squared
//    Silverman factor at k_dyn times scaling, and the ancestor CDF
//    cummax(where(w > 0, cumsum(w), 0)) that K2's local mode searches.
//    It also packs the m candidates (the [::stride] subsample; top-k: every
//    row) into one array: their masked coordinates (D floats each, D the
//    bucket), then the pairs (|x|^2, validity bit weight > 0).
// 2. field (a warp a row, W rows a block: 32 up to d 4, 16 at d 8, 8 at
//    d 16): the packed candidates stream twice through a ring of 16 KB
//    shared-memory tiles (cp.async, three stages, one barrier a tile), so a
//    candidate leaves L2 twice a block and not once a row; every warp
//    reads each tile. A row keeps no (n, n) tile and no m distances: its
//    warp recomputes each distance where it needs it.
//    - distances follow the JAX size rule: n_cap <= 4096 (dense) the diff
//      form sum_k (x_ik - x_jk)^2, above it |x_i|^2 + |x_j|^2 - 2 x_i.x_j
//      clamped at 0; invalid candidates (weight 0) are +inf. Each
//      operation is written with the _rn intrinsics (no FMA contraction),
//      in the plain version's order, so both give the same distances and
//      the same selections bit for bit.
//    - V, the k-th smallest distance (its bits read as unsigned: for
//      distances >= +0 the order of the values, NaN above +inf), exactly.
//      The first stream keeps the first 1024 distances' keys as a sample,
//      takes from it two pivots 5 sd either side of k's expected rank,
//      then counts every key below the lower pivot and keeps the keys
//      between them (the bracket, about 600 of the LV leg's 4096) in the
//      sample's place. A radix
//      select over warp histograms finds V among the bracket's keys; its
//      first digit spans their own range, and once at most 32 keys share
//      the prefix they are ranked by shuffles. Where V falls outside the
//      bracket (or the bracket outgrows its 1024 slots) the same select
//      runs over every candidate's key, recomputed from device memory.
//    - top-k: the k_dyn smallest by (distance, index) (lax.top_k's set):
//      every candidate below V and the lowest-index candidates equal to V.
//      The covariance divides by k_dyn.
//    - threshold: radius_bisect's radius on the [::stride] subsample (hi0
//      the finite max or 0, lo0 0, 26 steps of mid = 0.5 (lo + hi)) from V
//      alone: count(sq <= mid) >= k_sub = ceil(k_dyn / stride) holds exactly
//      when mid >= V (NaN never counts, +inf counts as a value), so the
//      steps replay on scalars with the same mids and the same radius
//      (ops/select.py::radius_from_kth is this in PyTorch). Then the
//      within-radius candidates, the count clipped to ceil(k_cap /
//      stride). The covariance divides by that realized count.
//    - the second stream selects in candidate order (ballots and prefix
//      popcounts) and sums the covariance from the tile's coordinates:
//      each lane the upper triangle of (x_j - x_i)(x_j - x_i)^T over its
//      own selected neighbours, then a butterfly in a fixed order (the same
//      bits from run to run); / count, * factor^2, the real block kept,
//      max(trace / dim, 1e-10) EPS on the real diagonal and 1 on the
//      padded one.
//
// Bound on an H100: operations. Per row at the scale lane (n_cap 16384,
// d 4, stride 4): 4096 distances of 3 d operations, one comparison a
// candidate for the selection and the covariance (3 d^2) over ~1024
// neighbours, some 1e5 operations; 1.7e9 for the field against 16384 x 16
// floats written. The block-a-row design this replaced paid 26 block-wide
// counting passes and barriers a row (32 for top-k) and re-read the
// strided subsample from L2 for every row. A design that kept each row's
// m distances in shared memory fitted 8 rows on an SM and ran latency
// bound (about 7 cycles an instruction a warp by a clock64 profile);
// recomputing a distance (some 15 instructions) where the row needs it
// lets 32 rows share an SM (0.538 ms at the scale lane against 0.601 for
// 24 rows a block and 0.605 for 18 on an H100 80GB HBM3 at 700 W).
#include "common.cuh"

namespace {

constexpr int kPrepThreads = 1024;
constexpr float kEps = 1e-3f;  // LocalTransition.EPS
constexpr int kBisectIters = 26;
// The depth of the ring of candidate tiles.
constexpr int kStages = 3;

// The packed candidates: m rows of D coordinates (the masked X, zeros past
// d; D the bucket), then at aux_offset(m, D) m pairs (|x|^2, the validity
// bit weight > 0). Both parts are padded to a multiple of 32 candidates,
// so a tile is always copied whole in 16-byte chunks.
__host__ __device__ constexpr int pad32(int m) { return (m + 31) / 32 * 32; }
__host__ __device__ constexpr size_t aux_offset(int m, int D) {
  return (size_t)pad32(m) * D;
}

__device__ float block_sum_f(float v, float* s_warp) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < nw ? s_warp[lane] : 0.f);
    if (lane == 0) s_warp[0] = v;
  }
  __syncthreads();
  return s_warp[0];
}

__device__ __forceinline__ float warp_scan_f(float v, bool is_max) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = is_max ? fmaxf(v, up) : v + up;
  }
  return v;
}

// Exclusive block scan (sum or max, values >= 0) of one float per thread.
__device__ float block_excl_scan_f(float v, bool is_max, float* s_warp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const float incl = warp_scan_f(v, is_max);
  __syncthreads();
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float t = lane < nw ? s_warp[lane] : 0.f;
    s_warp[lane] = warp_scan_f(t, is_max);
  }
  __syncthreads();
  const float before_warp = warp > 0 ? s_warp[warp - 1] : 0.f;
  const float up = __shfl_up_sync(0xffffffffu, incl, 1);
  const float in_warp = lane > 0 ? up : 0.f;
  return is_max ? fmaxf(before_warp, in_warp) : before_warp + in_warp;
}

__global__ void __launch_bounds__(kPrepThreads)
local_prep_kernel(const float* __restrict__ thetas,
                  const float* __restrict__ weights, int n, int d, int dim,
                  const int* __restrict__ k_table, int k_cap,
                  float sel_const, float sel_exp, float scaling,
                  const int* __restrict__ flag, float* __restrict__ X,
                  float* __restrict__ w_out, float* __restrict__ cdf,
                  float* __restrict__ norms, int* __restrict__ k_dyn_out,
                  float* __restrict__ factor2_out, float* __restrict__ cand,
                  int rec_d, int cand_stride, int m) {
  if (flag != nullptr && flag[0] == 0) return;
  __shared__ float s_warp[32];
  const int tid = threadIdx.x;
  float ws = 0.f, cv = 0.f, cc = 0.f;
  for (int i = tid; i < n; i += kPrepThreads) {
    const float w = weights[i];
    ws += w;
    cv += w > 0.f ? 1.f : 0.f;
    cc += (w > 0.f && i % cand_stride == 0) ? 1.f : 0.f;
  }
  ws = block_sum_f(ws, s_warp);
  const int c = (int)block_sum_f(cv, s_warp);  // exact below 2^24 rows
  const int c_cand = (int)block_sum_f(cc, s_warp);
  const float denom = ws < 1e-38f ? 1e-38f : ws;
  float* aux = cand + aux_offset(m, rec_d);
  for (int i = tid; i < n; i += kPrepThreads) {
    w_out[i] = weights[i] / denom;
    const int s = i / cand_stride;
    float* r = i % cand_stride == 0 ? cand + (size_t)s * rec_d : nullptr;
    float nrm = 0.f;
    for (int k = 0; k < d; ++k) {
      const float x = thetas[(size_t)i * d + k] * (k < dim ? 1.f : 0.f);
      X[(size_t)i * d + k] = x;
      if (r != nullptr) r[k] = x;
      const float p = __fmul_rn(x, x);
      nrm = k == 0 ? p : __fadd_rn(nrm, p);
    }
    if (norms != nullptr) norms[i] = nrm;
    if (r != nullptr) {
      for (int k = d; k < rec_d; ++k) r[k] = 0.f;
      aux[2 * s] = nrm;
      aux[2 * s + 1] = __int_as_float(weights[i] > 0.f ? 1 : 0);
    }
  }
  if (tid == 0) {
    const int k_dyn = min(k_table[c], k_cap);
    const float f = sel_const * powf((float)k_dyn, sel_exp) * scaling;
    k_dyn_out[0] = k_dyn;
    k_dyn_out[1] = c_cand;  // the valid candidates, for the field's pivots
    factor2_out[0] = f * f;
  }
  __syncthreads();  // w_out written by every thread before the scan
  const int chunk = (n + kPrepThreads - 1) / kPrepThreads;
  const int a = min(n, tid * chunk), b = min(n, a + chunk);
  float run_sum = 0.f;
  for (int i = a; i < b; ++i) run_sum += w_out[i];
  float run = block_excl_scan_f(run_sum, false, s_warp);
  float local_max = 0.f;
  for (int i = a; i < b; ++i) {
    const float w = w_out[i];
    run += w;
    const float v = w > 0.f ? run : 0.f;
    local_max = fmaxf(local_max, v);
    cdf[i] = v;
  }
  float cur = block_excl_scan_f(local_max, true, s_warp);
  for (int i = a; i < b; ++i) {
    cur = fmaxf(cur, cdf[i]);
    cdf[i] = cur;
  }
}

// The D coordinates of a packed candidate (16-byte loads from D = 4 up).
template <int D>
__device__ __forceinline__ void load_coords(const float* r, float (&x)[D]) {
  if constexpr (D >= 4) {
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(r)[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else if constexpr (D == 2) {
    const float2 v = *reinterpret_cast<const float2*>(r);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = r[0];
  }
}

// A row: its coordinates (zeros past d) and norm, and its squared distance
// to a packed candidate in the plain version's operations and order (the
// _rn intrinsics: no FMA): the diff form, or (|x_i|^2 + |x_j|^2) - 2
// x_i.x_j clamped at 0; +inf when invalid, +0 for -0 (the bits then order
// like the values). The bucket's padded coordinates are 0 in both rows,
// and adding their +0 terms leaves every sum's bits as the plain
// version's d terms give them.
template <int D, bool DENSE>
struct Row {
  float x[D];
  float nrm;
  __device__ __forceinline__ float dist(const float (&xj)[D],
                                        float2 nv) const {
    float v;
    if constexpr (DENSE) {
      v = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float df = __fsub_rn(x[k], xj[k]);
        const float p = __fmul_rn(df, df);
        v = k == 0 ? p : __fadd_rn(v, p);
      }
    } else {
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float p = __fmul_rn(x[k], xj[k]);
        dot = k == 0 ? p : __fadd_rn(dot, p);
      }
      v = __fsub_rn(__fadd_rn(nrm, nv.x), __fmul_rn(2.f, dot));
      v = v < 0.f ? 0.f : v;
    }
    v = v == 0.f ? 0.f : v;
    return __float_as_int(nv.y) != 0 ? v : INFINITY;
  }
  // candidate c of a tile (coordinates cx, pairs ca)
  __device__ __forceinline__ float dist_at(const float* __restrict__ cx,
                                           const float* __restrict__ ca,
                                           int c) const {
    float xj[D];
    load_coords<D>(cx + (size_t)c * D, xj);
    return dist(xj, *reinterpret_cast<const float2*>(ca + 2 * c));
  }
};

// Lane l's 8 bins [8 l, 8 l + 8) of a warp histogram of 256 ints: the
// digit whose bin holds the krem-th key of those counted, the count before
// it and the count in it, the same in every lane.
__device__ __forceinline__ void hist_pick(const int* __restrict__ hist,
                                          int krem, int* digit, int* before,
                                          int* in_bin) {
  const int lane = threadIdx.x & 31;
  int c[8], tot = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    c[q] = hist[lane * 8 + q];
    tot += c[q];
  }
  const int incl = warp_inclusive_scan(tot);
  const int src = __ffs(__ballot_sync(0xffffffffu, incl >= krem)) - 1;
  int dg = 0, bf = 0, ib = 0, run = incl - tot;
  bool found = false;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (!found && run + c[q] >= krem) {
      found = true;
      dg = lane * 8 + q;
      bf = run;
      ib = c[q];
    }
    run += c[q];
  }
  *digit = __shfl_sync(0xffffffffu, dg, src);
  *before = __shfl_sync(0xffffffffu, bf, src);
  *in_bin = __shfl_sync(0xffffffffu, ib, src);
}

// x >> w for w in [0, 32] (a shift by 32 is undefined in C++).
__device__ __forceinline__ unsigned shr(unsigned x, int w) {
  return w >= 32 ? 0u : x >> w;
}

// Keys of a warp's array in shared memory.
struct ArrayKeys {
  const unsigned* a;
  __device__ __forceinline__ unsigned operator()(int s) const { return a[s]; }
};

// Keys recomputed from the packed candidates in device memory (a row whose
// k-th distance fell outside its bracket).
template <int D, bool DENSE>
struct CandKeys {
  Row<D, DENSE> row;
  const float* cx;
  const float* ca;
  __device__ __forceinline__ unsigned operator()(int s) const {
    return __float_as_uint(row.dist_at(cx, ca, s));
  }
};

// One warp: the k-th smallest (k >= 1) of the keys key(0 .. n) that lie in
// [kmin, kmax], exact, where at least k of them lie there -> V and the
// count of those below V. A radix select on rel = key - kmin whose span
// sets the first digit, so the 256 bins cover the keys' own range; 8 bits
// a pass after that until at most 32 keys share the prefix, which are
// gathered one a lane and ranked by shuffles. hist: 256 ints.
template <typename Keys>
__device__ void warp_select(const Keys& key, int n, int k, unsigned kmin,
                            unsigned kmax, int* __restrict__ hist,
                            unsigned* V, int* below) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const unsigned span = kmax - kmin;
  int w = span ? 32 - __clz(span) : 0;  // bits of rel still unknown
  unsigned prefix = 0u;                 // rel >> w of the keys still in
  int krem = k, in_bin = n;
  auto in = [&](int s, unsigned u) {
    return s < n && u >= kmin && u <= kmax && shr(u - kmin, w) == prefix;
  };
  while (w > 0 && in_bin > 32) {
    const int sh = w > 8 ? w - 8 : 0;
    const unsigned dmask = (1u << (w - sh)) - 1u;
    for (int b = lane; b < 256; b += 32) hist[b] = 0;
    __syncwarp();
    for (int s0 = lane; s0 < n; s0 += 128) {
      unsigned u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] = key(min(s0 + 32 * q, n - 1));
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (in(s0 + 32 * q, u[q]))
          atomicAdd(&hist[((u[q] - kmin) >> sh) & dmask], 1);
    }
    __syncwarp();
    int digit, before;
    hist_pick(hist, krem, &digit, &before, &in_bin);
    krem -= before;
    prefix = (prefix << (w - sh)) | (unsigned)digit;
    w = sh;
    __syncwarp();  // every lane has read the histogram before it is reused
  }
  if (w == 0) {
    *V = kmin + prefix;
    *below = k - krem;
    return;
  }
  // at most 32 keys share the prefix: one a lane, ranked among themselves
  int n_in = 0;
  for (int s0 = 0; s0 < n; s0 += 128) {
    unsigned u[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) u[q] = key(min(s0 + 32 * q + lane, n - 1));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool hit = in(s0 + 32 * q + lane, u[q]);
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      if (hit) hist[n_in + __popc(bal & lt_mask)] = (int)(u[q] - kmin);
      n_in += __popc(bal);
    }
  }
  __syncwarp();
  const unsigned mine = lane < n_in ? (unsigned)hist[lane] : 0xffffffffu;
  int lt = 0, le = 0;
  for (int j = 0; j < n_in; ++j) {
    const unsigned o = __shfl_sync(0xffffffffu, mine, j);
    lt += o < mine ? 1 : 0;
    le += o <= mine ? 1 : 0;
  }
  const bool hit = lane < n_in && lt < krem && krem <= le;
  const int src = __ffs(__ballot_sync(0xffffffffu, hit)) - 1;
  *V = kmin + __shfl_sync(0xffffffffu, mine, src);
  *below = k - krem + __shfl_sync(0xffffffffu, lt, src);
  __syncwarp();
}

// The candidates of the block, tile by tile: each tile's coordinates and
// pairs pass through a ring of kStages shared-memory tiles (cp.async, one
// barrier a tile). body(cx, ca, base, cnt) runs for each tile in order in
// every thread.
template <int D, typename Body>
__device__ __forceinline__ void stream_candidates(const float* cand, int m,
                                                  int tc, float* ring,
                                                  Body&& body) {
  const float* aux = cand + aux_offset(m, D);
  const int tiles = (m + tc - 1) / tc;
  auto stage = [&](int t) {
    if (t < tiles) {
      float* dst = ring + (size_t)(t % kStages) * tc * (D + 2);
      const int c32 = pad32(min(tc, m - t * tc));  // inside the padding
      const float* sx = cand + (size_t)t * tc * D;
      const float* sa = aux + (size_t)t * tc * 2;
      const int nx = c32 * D / 4, na = c32 / 2;
      for (int c = threadIdx.x; c < nx + na; c += blockDim.x) {
        if (c < nx)
          cp_async16(dst + 4 * c, sx + 4 * c);
        else
          cp_async16(dst + tc * D + 4 * (c - nx), sa + 4 * (c - nx));
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) stage(t);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; tile t - 1's stage is free
    stage(t + kStages - 1);
    const float* st = ring + (size_t)(t % kStages) * tc * (D + 2);
    body(st, st + tc * D, t * tc, min(tc, m - t * tc));
  }
  __syncthreads();  // the ring may be refilled by a later stream
}

// One lane's four candidates c0, c0 + 32, c0 + 64, c0 + 96 of a tile, all
// loads first. A tile's stage is followed by the rest of the ring or the
// warps' scratch, so loads past the tile's last candidate stay in the
// block's shared memory; their values go unused.
template <int D>
__device__ __forceinline__ void load_batch(const float* __restrict__ cx,
                                           const float* __restrict__ ca,
                                           int c0, float (&xj)[4][D],
                                           float2 (&nv)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    load_coords<D>(cx + (c0 + 32 * q) * D, xj[q]);
    nv[q] = *reinterpret_cast<const float2*>(ca + 2 * (c0 + 32 * q));
  }
}

// A warp's scratch in shared memory: the first kSample distances' keys
// (the sample), compacted in place into the bracket's keys once the pivots
// are known; a histogram; the bracket's fill count.
constexpr int kSample = 1024;
constexpr int kBracket = kSample;
constexpr int kScratch = kSample + 256 + 4;

// One row's selection state through the first stream: the pivots' keys
// (warp-wide) and each lane's keys below the lower one and its largest
// finite key (distances are >= +0, so a key below that of +inf is a finite
// distance; 0, the key of +0, where there is none); the keys inside [lo,
// hi] go to the bracket array at a shared fill count (their order does not
// matter: the select on them finds the same key whatever it is).
struct Bracket {
  unsigned lo = 0u, hi = 0xffffffffu;
  bool ready = false;
  int below = 0;
  unsigned kmax = 0u;
  __device__ __forceinline__ void count(unsigned u) {
    if (u < 0x7f800000u) kmax = max(kmax, u);
    below += u < lo ? 1 : 0;
  }
  __device__ __forceinline__ void add(unsigned u, unsigned* __restrict__ keys,
                                      int* fill) {
    count(u);
    if (u >= lo && u <= hi) {
      const int pos = atomicAdd(fill, 1);
      if (pos < kBracket) keys[pos] = u;
    }
  }
  // the sample's n_s keys, compacted in place in index order (each lane
  // reads its key before any lane writes, and a key moves only down)
  __device__ __forceinline__ void add_sample(unsigned* __restrict__ keys,
                                             int n_s, int* fill) {
    const int lane = threadIdx.x & 31;
    const unsigned lt_mask = (1u << lane) - 1u;
    int inside = 0;
    for (int c0 = 0; c0 < n_s; c0 += 32) {
      const bool ok = c0 + lane < n_s;
      const unsigned u = ok ? keys[c0 + lane] : 0u;
      if (ok) count(u);
      const bool in = ok && u >= lo && u <= hi;
      const unsigned bb = __ballot_sync(0xffffffffu, in);
      if (in) keys[inside + __popc(bb & lt_mask)] = u;
      inside += __popc(bb);
    }
    if (lane == 0) *fill = inside;
    __syncwarp();
  }
};

// The bracket of the k-th key (1 <= k <= m) from the sample (n_s keys) of
// a row whose candidates hold m_valid valid ones: V is the k-th of the
// valid keys (the invalid ones are +inf, above them), so the pivots are
// the sample's order statistics 5 sd either side of k's expected rank
// among the sample's s_v finite keys, the upper one at most the largest of
// them. A sample of every candidate, or a k past the valid ones, needs no
// pivot (the bracket is every key).
__device__ void pick_pivots(const unsigned* __restrict__ sample, int n_s,
                            int m, int m_valid, int k,
                            int* __restrict__ hist, Bracket& br) {
  if (n_s >= m || k > m_valid) return;
  const int lane = threadIdx.x & 31;
  unsigned smin = 0xffffffffu, smax = 0u;
  int s_v = 0;
  for (int s = lane; s < n_s; s += 32) {
    const unsigned u = sample[s];
    smin = min(smin, u);
    if (u < 0x7f800000u) {
      smax = max(smax, u);
      ++s_v;
    }
  }
  smin = __reduce_min_sync(0xffffffffu, smin);
  smax = __reduce_max_sync(0xffffffffu, smax);
  s_v = __reduce_add_sync(0xffffffffu, (unsigned)s_v);
  if (s_v == 0) return;
  const float p = (float)k / (float)m_valid, mu = p * (float)s_v;
  const float sd = sqrtf((float)s_v * p * (1.f - p));
  const int r_lo = (int)floorf(mu - 5.f * sd - 1.f);
  const int r_hi = min(s_v, (int)ceilf(mu + 5.f * sd + 1.f));
  const ArrayKeys keys{sample};
  int unused;
  if (r_lo >= 1)
    warp_select(keys, n_s, r_lo, smin, smax, hist, &br.lo, &unused);
  warp_select(keys, n_s, max(r_hi, 1), smin, smax, hist, &br.hi, &unused);
}

// Rows a block serves (a warp each), by the bucket's register needs.
template <int D>
constexpr int max_warps() {
  return D <= 4 ? 32 : D == 8 ? 16 : 8;
}

template <int D, bool DENSE>
__device__ __forceinline__ void field_row(
    const float* __restrict__ X, const float* __restrict__ norms,
    const float* __restrict__ cand, int n, int d, int dim, int k_dyn,
    int m_valid, float f2, int topk, int stride, float* __restrict__ covs,
    int* __restrict__ cnt_out, int* __restrict__ idx_out, int buf, int m,
    int tc, float* ring, int* scratch) {
  constexpr int NT = D * (D + 1) / 2;  // the covariance's upper triangle
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  const bool row_ok = i < n;
  unsigned* keys = reinterpret_cast<unsigned*>(scratch);  // sample, bracket
  int* hist = scratch + kSample;
  int* fill = hist + 256;
  Row<D, DENSE> row;
#pragma unroll
  for (int e = 0; e < D; ++e)
    row.x[e] = (row_ok && e < d) ? X[(size_t)i * d + e] : 0.f;
  row.nrm = (row_ok && !DENSE) ? norms[i] : 0.f;
  const int k = topk ? min(k_dyn, m) : (k_dyn + stride - 1) / stride;
  const bool select = k >= 1 && k <= m;
  const int n_s = min(kSample, m);

  // 1. the first stream: the first n_s distances' keys into the sample,
  //    the bracket's pivots from it, then every key counted against them
  //    and the bracket's own keys kept
  Bracket br;
  stream_candidates<D>(
      cand, m, tc, ring,
      [&](const float* cx, const float* ca, int base, int cnt) {
        if (!row_ok) return;
        const int n_first = max(0, min(cnt, n_s - base));
        for (int c = lane; c < n_first; c += 32)
          keys[base + c] = __float_as_uint(row.dist_at(cx, ca, c));
        if (!br.ready && base + cnt >= n_s) {
          __syncwarp();
          if (select) pick_pivots(keys, n_s, m, m_valid, k, hist, br);
          br.ready = true;
          br.add_sample(keys, n_s, fill);
        }
        for (int c0 = n_first + lane; c0 - lane < cnt; c0 += 128) {
          float xj[4][D];
          float2 nv[4];
          load_batch<D>(cx, ca, c0, xj, nv);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float v = row.dist(xj[q], nv[q]);
            if (c0 + 32 * q < cnt) br.add(__float_as_uint(v), keys, fill);
          }
        }
      });
  const unsigned kmax = __reduce_max_sync(0xffffffffu, br.kmax);
  const int below_lo = __reduce_add_sync(0xffffffffu, (unsigned)br.below);
  __syncwarp();
  const int inside = row_ok ? *fill : 0;

  // 2. V, the k-th smallest key, by a select over the bracket's keys; where
  //    the k-th key fell outside the bracket (or the bracket outgrew its
  //    array), over the keys of the interval that holds it, recomputed
  //    from the packed candidates
  unsigned V = 0u;
  int below = 0;
  if (row_ok && select) {
    if (below_lo < k && k <= below_lo + inside && inside <= kBracket) {
      warp_select(ArrayKeys{keys}, inside, k - below_lo, br.lo, br.hi, hist,
                  &V, &below);
      below += below_lo;
    } else {
      unsigned a = br.lo, b = br.hi;
      int cb = below_lo;
      if (k <= below_lo) {
        a = 0u;
        b = br.lo - 1u;
        cb = 0;
      } else if (k > below_lo + inside) {
        a = br.hi + 1u;
        b = 0xffffffffu;
        cb = below_lo + inside;
      }
      warp_select(CandKeys<D, DENSE>{row, cand, cand + aux_offset(m, D)},
                  m, k - cb, a, b, hist, &V, &below);
      below += cb;
    }
  }
  // top-k: every candidate below V, then the lowest-index ones equal to
  // V; threshold: radius_bisect's 26 steps replayed on scalars, as
  // count(sq <= mid) >= k holds exactly when mid >= V (NaN never counts:
  // V is NaN when fewer than k distances are numbers; +inf counts as a
  // value), then every candidate within the radius
  const int need = (topk && k >= 1) ? k - below : 0;
  float rad = 0.f;
  if (!topk) {
    const float v = k <= 0 ? -INFINITY : k > m ? NAN : __uint_as_float(V);
    float hi = __uint_as_float(kmax), lo = 0.f;
    for (int it = 0; it < kBisectIters; ++it) {
      const float mid = 0.5f * __fadd_rn(lo, hi);
      if (mid >= v)
        hi = mid;
      else
        lo = mid;
    }
    rad = hi;
  }

  // 3. the second stream: the selection in candidate order (ballots and
  //    prefix popcounts) and the neighbours' covariance from the tiles'
  //    coordinates: each lane sums the upper triangle of its own selected
  //    ones, then a butterfly in a fixed order gives every lane the sums
  float acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t] = 0.f;
  int total = 0, eq_seen = 0;
  stream_candidates<D>(
      cand, m, tc, ring,
      [&](const float* cx, const float* ca, int base, int cnt) {
        if (!row_ok) return;
        for (int c0 = lane; c0 - lane < cnt; c0 += 128) {
          float xj[4][D], v[4];
          float2 nv[4];
          load_batch<D>(cx, ca, c0, xj, nv);
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = row.dist(xj[q], nv[q]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = c0 + 32 * q;
            const bool ok = c < cnt;
            bool take;
            if (topk) {
              const unsigned u = __float_as_uint(v[q]);
              const bool eq = ok && u == V && need > 0;
              const unsigned eb = __ballot_sync(0xffffffffu, eq);
              take = (ok && u < V && need > 0) ||
                     (eq && eq_seen + __popc(eb & lt_mask) < need);
              eq_seen += __popc(eb);
            } else {
              take = ok && v[q] <= rad;
            }
            const unsigned tb = __ballot_sync(0xffffffffu, take);
            const int pos = total + __popc(tb & lt_mask);
            total += __popc(tb);
            if (take && pos < buf) {
              if (idx_out != nullptr)
                idx_out[(size_t)i * buf + pos] =
                    topk ? base + c : (base + c) * stride;
              if (__float_as_int(nv[q].y) != 0) {
                float xc[D];
#pragma unroll
                for (int e = 0; e < D; ++e)
                  xc[e] = e < d ? xj[q][e] - row.x[e] : 0.f;
                int t = 0;
#pragma unroll
                for (int a = 0; a < D; ++a)
#pragma unroll
                  for (int b = a; b < D; ++b, ++t) acc[t] += xc[a] * xc[b];
              }
            }
          }
        }
      });
  if (!row_ok) return;
  const int sel = topk ? min(k, buf) : min(total, buf);
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t] = warp_sum(acc[t]);
  const int div = topk ? k_dyn : sel;
  const float dv = (float)(div > 1 ? div : 1);
  float tr = 0.f;
  {
    int t = 0;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      if (a < d) tr += __fmul_rn(acc[t] / dv, f2);
      t += D - a;
    }
  }
  tr = tr / (float)dim;
  const float jit = (tr < 1e-10f ? 1e-10f : tr) * kEps;
  float* crow = covs + (size_t)i * d * d;
  {
    int t = 0;
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = a; b < D; ++b, ++t) {
        if (a >= d || b >= d) continue;
        float v = (a < dim && b < dim) ? __fmul_rn(acc[t] / dv, f2) : 0.f;
        if (a == b) v += a < dim ? jit : 1.f;
        if (((a * d + b) & 31) == lane) crow[a * d + b] = v;
        if (a != b && ((b * d + a) & 31) == lane) crow[b * d + a] = v;
      }
  }
  if (lane == 0) cnt_out[i] = topk ? k_dyn : sel;
  if (idx_out != nullptr)
    for (int p = sel + lane; p < buf; p += 32)
      idx_out[(size_t)i * buf + p] = 0;
}

template <int D>
__global__ void __launch_bounds__(max_warps<D>() * 32)
local_field_kernel(const float* __restrict__ X,
                   const float* __restrict__ norms,
                   const float* __restrict__ cand, int n, int d, int dim,
                   const int* __restrict__ k_dyn_p,
                   const float* __restrict__ factor2_p, int topk,
                   int stride, const int* __restrict__ flag,
                   float* __restrict__ covs, int* __restrict__ cnt_out,
                   int* __restrict__ idx_out, int buf, int m, int tc) {
  if (flag != nullptr && flag[0] == 0) return;
  extern __shared__ __align__(16) float smem[];
  int* scratch = reinterpret_cast<int*>(smem + kStages * tc * (D + 2)) +
                 (threadIdx.x >> 5) * kScratch;
  if (norms == nullptr)
    field_row<D, true>(X, norms, cand, n, d, dim, k_dyn_p[0], k_dyn_p[1],
                       factor2_p[0], topk, stride, covs, cnt_out, idx_out,
                       buf, m, tc, smem, scratch);
  else
    field_row<D, false>(X, norms, cand, n, d, dim, k_dyn_p[0], k_dyn_p[1],
                        factor2_p[0], topk, stride, covs, cnt_out, idx_out,
                        buf, m, tc, smem, scratch);
}

template <int D>
int launch_field(const float* X, const float* norms, const float* cand,
                 int n, int d, int dim, const int* k_dyn,
                 const float* factor2, int topk, int stride,
                 const int* flag, float* covs, int* cnt, int* idx, int buf,
                 int warps, int tc, cudaStream_t stream) {
  if (warps < 1 || warps > max_warps<D>() || tc < 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = topk ? n : (n + stride - 1) / stride;
  const size_t smem =
      ((size_t)kStages * tc * (D + 2) + (size_t)warps * kScratch) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_field_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + warps - 1) / warps;
  local_field_kernel<D><<<blocks, warps * 32, smem, stream>>>(
      X, norms, cand, n, d, dim, k_dyn, factor2, topk, stride, flag, covs,
      cnt, idx, buf, m, tc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// thetas (n, d), weights (n,), k_table (n + 1,) int32 on the device; flag
// nullable (int32, 0 = skip); norms null selects the diff form (dense);
// idx nullable (n, buf) int32. Scratch k_dyn (2 ints: k_dyn and the valid
// candidates) and factor2 (1 float) carry the prep kernel's scalars to the
// field kernel; cand (pad32(m) (D +
// 2) floats, D the bucket) holds the packed candidates. warps (rows a
// block) and tc (candidates a tile of the ring, a multiple of 32) are the
// host's plan.
extern "C" int pyabc_local_cov(
    const float* thetas, const float* weights, int n, int d, int dim,
    const int* k_table, int k_cap, float sel_const, float sel_exp,
    float scaling, int topk, int stride, const int* flag, float* X,
    float* w, float* cdf, float* norms, int* k_dyn, float* factor2,
    float* covs, int* cnt, int* idx, int buf, float* cand, int warps,
    int tc, void* stream_ptr) {
  if (n <= 0 || d <= 0 || d > 16 || dim <= 0 || dim > d || stride < 1 ||
      buf < 1 || k_cap < 1 || tc % 32 != 0 || cand == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rec_d = d <= 1 ? 1 : d <= 2 ? 2 : d <= 4 ? 4 : d <= 8 ? 8 : 16;
  const int m = topk ? n : (n + stride - 1) / stride;
  local_prep_kernel<<<1, kPrepThreads, 0, stream>>>(
      thetas, weights, n, d, dim, k_table, k_cap, sel_const, sel_exp,
      scaling, flag, X, w, cdf, norms, k_dyn, factor2, cand, rec_d,
      topk ? 1 : stride, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
#define PYABC_FIELD(DB)                                                    \
  return launch_field<DB>(X, norms, cand, n, d, dim, k_dyn, factor2, topk, \
                          stride, flag, covs, cnt, idx, buf, warps, tc,    \
                          stream)
  if (d <= 1) PYABC_FIELD(1);
  if (d <= 2) PYABC_FIELD(2);
  if (d <= 4) PYABC_FIELD(4);
  if (d <= 8) PYABC_FIELD(8);
  PYABC_FIELD(16);
#undef PYABC_FIELD
}
