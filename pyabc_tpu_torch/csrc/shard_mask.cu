// K24b shard_mask: the shard quotas, the kept-row mask over the
// shard-blocked reservoir and the generation's totals of a sharded fused
// generation (ABCSMC(..., sharded=n)).
//
// Replaces: pyabc_tpu/ops/shard.py::{shard_quota (:44), shard_mask (:79)}
// as pyabc_tpu/inference/util.py::_multigen_sharded traces them after the
// shards' round loops (:2655-2668), with the sums of the per-shard
// counters.
//
// From the (n, 4) counter table [n_acc, rounds, n_valid, -] and the
// generation's counters (N_TARGET at [4], eps <= min_eps at [3]), all in
// device memory:
//   quota[s] = N_TARGET / n + (s < N_TARGET % n)
//   mask[j]  = (j % cap_loc) < min(n_acc[j / cap_loc], quota[j / cap_loc])
//   summary  = [sum n_acc, max rounds, sum n_valid, counters[3],
//               counters[4], all(n_acc[s] >= min(quota[s], cap_loc))]
// The summary has the layout of a generation's counters (then gen_ok), so
// the generation step reads it where an unsharded generation reads its
// counters; nothing goes to the host.
//
// Bound on an H100: bytes (the n x cap_loc mask written once; the table is
// a few dozen bytes). One thread a mask row; block 0 also writes the
// quotas and, in thread 0, the summary over the n shards in order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int quota_of(int s, int n_shards, int n_tgt) {
  return n_tgt / n_shards + (s < n_tgt % n_shards ? 1 : 0);
}

__global__ void __launch_bounds__(kThreads)
shard_mask_kernel(int n_shards, int cap_loc, const int* __restrict__ counters,
                  const int* __restrict__ table, int* __restrict__ quota,
                  uint8_t* __restrict__ mask, int* __restrict__ summary) {
  const int n_tgt = counters[4];
  const long long total = (long long)n_shards * cap_loc;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < total; j += (long long)gridDim.x * blockDim.x) {
    const int s = (int)(j / cap_loc);
    const int off = (int)(j - (long long)s * cap_loc);
    const int lim = min(table[4 * s], quota_of(s, n_shards, n_tgt));
    mask[j] = off < lim ? 1 : 0;
  }
  if (blockIdx.x != 0) return;
  for (int s = threadIdx.x; s < n_shards; s += blockDim.x)
    quota[s] = quota_of(s, n_shards, n_tgt);
  if (threadIdx.x != 0) return;
  int n_acc = 0, rounds = 0, n_valid = 0, ok = 1;
  for (int s = 0; s < n_shards; ++s) {
    const int* row = table + 4 * s;
    n_acc += row[0];
    rounds = max(rounds, row[1]);
    n_valid += row[2];
    if (row[0] < min(quota_of(s, n_shards, n_tgt), cap_loc)) ok = 0;
  }
  summary[0] = n_acc;
  summary[1] = rounds;
  summary[2] = n_valid;
  summary[3] = counters[3];
  summary[4] = n_tgt;
  summary[5] = ok;
}

}  // namespace

extern "C" int pyabc_shard_mask(int n_shards, int cap_loc,
                                const int* counters, const int* table,
                                int* quota, uint8_t* mask, int* summary,
                                void* stream_ptr) {
  if (n_shards <= 0 || cap_loc <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long total = (long long)n_shards * cap_loc;
  const long long blocks = (total + kThreads - 1) / kThreads;
  shard_mask_kernel<<<(int)(blocks < 1024 ? blocks : 1024), kThreads, 0,
                      stream>>>(n_shards, cap_loc, counters, table, quota,
                                mask, summary);
  return static_cast<int>(cudaGetLastError());
}
