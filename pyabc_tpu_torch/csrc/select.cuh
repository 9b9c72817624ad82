// Radix selection by 256-bin histograms, shared by K7 (the weighted
// quantile) and K9 (the medians of the adaptive scales).
//
// Each float is mapped to the order-preserving uint32 image (sign bit
// flipped for positives, all bits for negatives; NaN first made the
// positive quiet NaN, so it sorts above +inf as torch.sort and jnp.sort
// place it). Four passes, most significant byte first: every pass builds,
// per column and per target, a 256-bin histogram of the elements whose
// key agrees with the target's prefix so far, then one small scan kernel
// per column picks the bin and narrows the prefix. After the fourth pass
// the prefix is the key of the selected element.
//
// A target selects the least v whose running total W(<= v) is "reached",
// W counting elements (K9) or summing weights in double (K7). The bin
// chosen is the first non-empty one at which the running total (the
// total below the prefix plus the bins so far) is reached; if none is
// (rounding, or no weight at all), the last non-empty bin, so the
// selection ends at the column's maximum. K7's target is reached where
// float32(W(<= v) / W) >= alpha, the plain version's cdf test (exact for
// counts, within float rounding of a step for weights); K9 runs two
// targets per column, the low and high order statistics of
// jnp.nanquantile's linear method (reached at count floor(q) + 1 and
// ceil(q) + 1, q = 0.5 (count - 1) in float32), and a target whose
// prefix equals target 0's reuses target 0's histogram.
//
// No size limit: blocks of rows of one column each histogram into shared
// memory and add their non-zero bins to the global histogram with atomics,
// so any number of rows runs on any number of blocks (the record ring
// grows with the population, rec_cap = 8 n_cap). Workspace (zeroed by
// select_run): the per-column State, then the counts, then the weights.
#pragma once

#include "common.cuh"

namespace pyabc_select {
namespace {  // every source that includes this keeps its own copy

constexpr int kBins = 256;
constexpr int kMaxTargets = 2;
constexpr int kHistThreads = 256;
constexpr int kRowsPerBlock = 2048;

// selection modes
constexpr int kQuantile = 0;  // one target: float(W(<= v) / W) >= alpha
constexpr int kMedian = 1;    // two targets, the linear-method median

struct State {
  uint32_t prefix[kMaxTargets];
  double below[kMaxTargets];   // total of the elements below the prefix
  double target[kMaxTargets];  // kMedian: the count to reach
  double total;                // total of the column
  float high_weight;           // kMedian: q - floor(q)
  int empty;                   // no included element in the column
};
static_assert(sizeof(State) == 56, "State layout is shared with Python");

// Element (i, c) is data[i * ld + c], left out where valid[i] == 0; with
// ref its value is |x - ref[c]|; with skip_nan a NaN value is left out.
struct Source {
  const float* data;
  int ld;
  const uint8_t* valid;
  const float* weights;
  const float* ref;
  int skip_nan;
};

__device__ __forceinline__ uint32_t key_of(float v) {
  uint32_t u = isnan(v) ? 0x7FC00000u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ bool fetch(const Source& s, int i, int c,
                                      float* v) {
  if (s.valid != nullptr && !s.valid[i]) return false;
  float x = s.data[(size_t)i * s.ld + c];
  if (s.ref != nullptr) x = fabsf(x - s.ref[c]);
  if (s.skip_nan && isnan(x)) return false;
  *v = x;
  return true;
}

template <bool kWeighted>
__global__ void __launch_bounds__(kHistThreads)
select_hist_kernel(Source src, int n_rows, int T, int pass,
                   const State* __restrict__ st, unsigned* __restrict__ cnt,
                   double* __restrict__ wsum) {
  __shared__ unsigned s_cnt[kMaxTargets * kBins];
  __shared__ double s_w[kWeighted ? kMaxTargets * kBins : 1];
  const int c = blockIdx.y;
  for (int j = threadIdx.x; j < T * kBins; j += blockDim.x) {
    s_cnt[j] = 0;
    if (kWeighted) s_w[j] = 0.0;
  }
  __syncthreads();
  const State s = st[c];
  const int shift = 24 - 8 * pass;
  const uint32_t hmask = pass == 0 ? 0u : (0xFFFFFFFFu << (32 - 8 * pass));
  const bool alias = T > 1 && s.prefix[1] == s.prefix[0];
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(n_rows, r0 + kRowsPerBlock);
  for (int i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    float v;
    if (!fetch(src, i, c, &v)) continue;
    const uint32_t key = key_of(v);
    const int bin = (key >> shift) & 0xFF;
    for (int t = 0; t < T; ++t) {
      if (t > 0 && alias) break;
      if (((key ^ s.prefix[t]) & hmask) != 0) continue;
      atomicAdd(&s_cnt[t * kBins + bin], 1u);
      if (kWeighted) atomicAdd(&s_w[t * kBins + bin], (double)src.weights[i]);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < T * kBins; j += blockDim.x) {
    if (s_cnt[j] == 0) continue;
    atomicAdd(&cnt[(size_t)c * T * kBins + j], s_cnt[j]);
    if (kWeighted) atomicAdd(&wsum[(size_t)c * T * kBins + j], s_w[j]);
  }
}

// One block of 32 threads per column; thread t < T scans target t.
__global__ void select_scan_kernel(int T, int pass, int mode, float alpha,
                                   int weighted, State* __restrict__ st,
                                   unsigned* __restrict__ cnt,
                                   double* __restrict__ wsum,
                                   float* __restrict__ out) {
  __shared__ State s;
  __shared__ uint32_t new_prefix[kMaxTargets];
  __shared__ double new_below[kMaxTargets];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  unsigned* hc0 = cnt + (size_t)c * T * kBins;
  double* hw0 = weighted ? wsum + (size_t)c * T * kBins : nullptr;
  if (t == 0) {
    s = st[c];
    if (pass == 0) {
      unsigned n = 0;
      double total = 0.0;
      for (int b = 0; b < kBins; ++b) {
        n += hc0[b];
        total += weighted ? hw0[b] : (double)hc0[b];
      }
      s.empty = n == 0;
      s.total = total;
      if (mode == kMedian) {
        const float q = 0.5f * (float)((int)n - 1);
        const float lo = fminf(fmaxf(floorf(q), 0.f), (float)n - 1.f);
        const float hi = fminf(fmaxf(ceilf(q), 0.f), (float)n - 1.f);
        s.high_weight = q - floorf(q);
        s.target[0] = (double)lo + 1.0;
        s.target[1] = (double)hi + 1.0;
      }
    }
  }
  __syncthreads();
  const int shift = 24 - 8 * pass;
  if (t < T) {
    new_prefix[t] = s.prefix[t];
    new_below[t] = s.below[t];
    if (!s.empty) {
      const int src_t = (t > 0 && s.prefix[t] == s.prefix[0]) ? 0 : t;
      const unsigned* hc = hc0 + src_t * kBins;
      const double* hw = weighted ? hw0 + src_t * kBins : nullptr;
      double cum = s.below[t], before = cum;
      int chosen = -1;
      for (int b = 0; b < kBins; ++b) {
        if (hc[b] == 0) continue;
        before = cum;
        cum += weighted ? hw[b] : (double)hc[b];
        chosen = b;
        // an all-zero (or NaN) total leaves the plain cdf NaN, and its
        // search runs off the end: the largest point is taken
        const bool reached =
            mode == kMedian ? cum >= s.target[t]
                            : s.total > 0.0 && (float)(cum / s.total) >= alpha;
        if (reached) break;
      }
      new_prefix[t] = s.prefix[t] | ((uint32_t)chosen << shift);
      new_below[t] = before;
    }
  }
  __syncthreads();
  for (int j = t; j < T * kBins; j += blockDim.x) {
    hc0[j] = 0;
    if (weighted) hw0[j] = 0.0;
  }
  if (t == 0) {
    for (int k = 0; k < T; ++k) {
      st[c].prefix[k] = new_prefix[k];
      st[c].below[k] = new_below[k];
    }
    if (pass == 0) st[c] = State{{new_prefix[0], new_prefix[1]},
                                 {new_below[0], new_below[1]},
                                 {s.target[0], s.target[1]}, s.total,
                                 s.high_weight, s.empty};
    if (pass == 3) {
      float v = NAN;
      if (!s.empty) {
        const float lo = float_of(new_prefix[0]);
        if (mode == kQuantile) {
          v = lo;
        } else {
          // jnp.nanquantile's linear method: low (1 - hw) + high hw
          const float hw = s.high_weight;
          const float hi = float_of(new_prefix[1]);
          v = __fadd_rn(__fmul_rn(lo, 1.f - hw), __fmul_rn(hi, hw));
        }
      }
      out[c] = v;
    }
  }
}

inline size_t workspace_bytes(int C, int T, bool weighted) {
  return (size_t)C * sizeof(State) + (size_t)C * T * kBins * sizeof(unsigned) +
         (weighted ? (size_t)C * T * kBins * sizeof(double) : 0);
}

// Launches the four passes; out[c] gets each column's selected value (NaN
// for a column with no included element).
inline void select_run(Source src, int n_rows, int C, int T, int mode,
                       float alpha, bool weighted, void* workspace,
                       float* out, cudaStream_t stream) {
  State* st = static_cast<State*>(workspace);
  unsigned* cnt = reinterpret_cast<unsigned*>(st + C);
  double* wsum = weighted ? reinterpret_cast<double*>(cnt + (size_t)C * T * kBins)
                          : nullptr;
  cudaMemsetAsync(workspace, 0, workspace_bytes(C, T, weighted), stream);
  const dim3 grid((unsigned)max(1, (n_rows + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)C);
  for (int pass = 0; pass < 4; ++pass) {
    if (weighted)
      select_hist_kernel<true><<<grid, kHistThreads, 0, stream>>>(
          src, n_rows, T, pass, st, cnt, wsum);
    else
      select_hist_kernel<false><<<grid, kHistThreads, 0, stream>>>(
          src, n_rows, T, pass, st, cnt, wsum);
    select_scan_kernel<<<C, 32, 0, stream>>>(T, pass, mode, alpha,
                                             weighted ? 1 : 0, st, cnt, wsum,
                                             out);
  }
}

}  // namespace
}  // namespace pyabc_select
