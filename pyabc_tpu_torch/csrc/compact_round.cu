// K6 compact_round: the mask-and-refill compaction of one proposal round.
//
// Replaces: the body of pyabc_tpu/inference/util.py::
// DeviceContext._generation_while (the lax.while_loop round step).
//
// With acc = accept & valid and slot = r*B + lane:
//   - lane i's accepted rank within the round is the exclusive prefix count
//     of acc; its reservoir row is n_acc + rank, written (theta, sumstats,
//     distance, log_weight, slot) only while < n_cap;
//   - the record ring keeps the first rec_cap evaluations in slot order:
//     row `slot` gets (sumstats, distance, acc, valid=1) for every VALID
//     lane with slot < rec_cap (rec_cap = 0: no ring);
//   - record mode (a noisy-ABC run: rec_theta, rec_logq and logq given):
//     ring row `slot` also gets the lane's theta (d floats) and logq, the
//     log-density of the proposal it was drawn from
//     (_generation_while(record_proposal=True)); with null pointers the
//     kernel does exactly the work it did without the mode;
//   - ring mask (segmented noisy ABC: ring_valid given): the ring row of a
//     valid lane gets valid = ring_valid[lane] in place of 1, so a slot
//     that K18 retired is recorded invalid (its statistics are partial),
//     while n_valid still counts it as evaluated; nullptr: valid = 1;
//   - model column (a run over several models: m and res_m given): the
//     lane's model index goes to res_m at the lane's reservoir row, like
//     its slot; with null pointers nothing of it runs;
//   - counters = [n_acc, r, n_valid, ...] are updated in device memory:
//     n_acc += count(acc) (lanes dropped past n_cap still count, exactly
//     like the JAX loop, since gen_ok reads it), r += 1,
//     n_valid += count(valid).
// The host reads the counters once per round.
//
// Shard mode (K24a, sharded fused sampling, ABCSMC(..., sharded=n)):
// replaces the vmapped per-shard round step of
// pyabc_tpu/inference/util.py::_generation_while under local_generation
// (:493, :2404-2420). One block a shard: block s reads its row of the
// (n, 4) counter table [n_acc, rounds, n_valid, -]; when n_acc >= its
// quota (N_TARGET / n, one more on the first N_TARGET % n shards, from
// counters[4] on the card) or rounds >= max_rounds the shard is finished
// and the block returns with nothing changed (its reservoir block and row
// stay frozen). Otherwise it compacts lanes [s*B_loc, (s+1)*B_loc) into
// reservoir rows [s*cap_loc, (s+1)*cap_loc) exactly as the one-block round
// above does for the whole round, with the shard's own round and local
// slot r*B_loc + i, and updates its row. Block 0 also adds one to
// counters[1], the round the lanes of the next round draw at. Under an
// adaptive distance each written row also gets its distance-feature row
// |x - x0|^p (x*x at p = 2, |x - x0| at p = 1 or inf), which the moment
// finish reads back (K24d). Given-rows feature mode (feat_rows non-null,
// an adaptive aggregated distance): the feature row is the lane's F given
// values (K25's sub-distances of the round, pyabc_tpu/inference/util.py:
// 590-595 with device_sharded_dfeat's row, aggregate.py:340-343), copied
// bit for bit into the (n_cap, F) feature rows in place of |x - x0|^p.
// There is no record ring: the sharded adaptive refit folds moments
// instead (K24d's fold).
//
// Bound on an H100: bytes (each lane's row is read once, each accepted or
// recorded row written once). The design is deliberately simple and
// deterministic, and one SM's load/store rate, not the card's memory,
// sets its time: ONE block walks the round in chunks of blockDim lanes
// with a running offset (warp-shuffle scan + a scan of the warp totals),
// writes each chunk's destination rows to shared memory, and then copies
// the rows cooperatively so that neighbouring threads touch neighbouring
// floats. The shard mode runs the same walk in n blocks at once, one a
// shard over its B_loc lanes, so n SMs share the round.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// |x - x0|^p, the distance feature of one statistic (p = 2: one multiply)
__device__ __forceinline__ float dist_feature(float x, float xo, float p) {
  const float a = fabsf(x - xo);
  if (p == 2.f) return __fmul_rn(a, a);
  if (p == 1.f || isinf(p)) return a;
  return powf(a, p);
}

// The compaction of lanes [lane0, lane0 + nb) of a round, local slot
// r * nb + i, into reservoir rows n_acc0 + rank below n_cap of the arrays
// given, and into the ring; the block's accepted and valid counts come back
// in taken and n_valid (uniform). One block runs it.
__device__ void compact_lanes(
    int lane0, int nb, int S, int d, int r, int n_acc0, int n_cap,
    const uint8_t* __restrict__ accept, const uint8_t* __restrict__ valid,
    const float* __restrict__ theta, const float* __restrict__ ss,
    const float* __restrict__ dist, const float* __restrict__ logw,
    const float* __restrict__ logq, const int* __restrict__ m,
    const uint8_t* __restrict__ ring_valid, float* __restrict__ res_theta,
    float* __restrict__ res_ss, float* __restrict__ res_dist,
    float* __restrict__ res_logw, int* __restrict__ res_slot,
    int* __restrict__ res_m, float* __restrict__ res_feat,
    const float* __restrict__ x0, float p,
    const float* __restrict__ feat_rows, int F, int rec_cap,
    float* __restrict__ rec_ss, float* __restrict__ rec_dist,
    uint8_t* __restrict__ rec_acc, uint8_t* __restrict__ rec_valid,
    float* __restrict__ rec_theta, float* __restrict__ rec_logq,
    int& taken, int& n_valid) {
  __shared__ int s_pos[kThreads];   // reservoir row of the chunk's lanes
  __shared__ int s_ring[kThreads];  // ring row of the chunk's lanes
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const bool ring = rec_cap > 0 && rec_ss != nullptr;
  const bool record = ring && rec_theta != nullptr;
  taken = 0;      // accepted lanes in earlier chunks (uniform)
  n_valid = 0;    // valid lanes so far (uniform)

  for (int start = 0; start < nb; start += kThreads) {
    const int li = start + tid;
    const int i = lane0 + li;
    const bool in = li < nb;
    const int v = (in && valid[i]) ? 1 : 0;
    const int a = (v && accept[i]) ? 1 : 0;
    const int incl = warp_inclusive_scan(a);
    if ((tid & 31) == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int tot = warp_inclusive_scan(s_warp[tid & 31]);
      s_warp[tid & 31] = tot;
    }
    __syncthreads();
    const int before = (warp > 0 ? s_warp[warp - 1] : 0) + incl - a;
    const int chunk_total = s_warp[kWarps - 1];
    const long long pos = (long long)n_acc0 + taken + before;
    const int slot = r * nb + li;
    s_pos[tid] = (a && pos < n_cap) ? (int)pos : -1;
    s_ring[tid] = (ring && v && slot < rec_cap) ? slot : -1;
    n_valid += __syncthreads_count(v);  // also the barrier for s_pos/s_ring

    if (s_pos[tid] >= 0) {
      const int q = s_pos[tid];
      res_dist[q] = dist[i];
      res_logw[q] = logw[i];
      res_slot[q] = slot;
      if (res_m != nullptr) res_m[q] = m[i];
    }
    if (s_ring[tid] >= 0) {
      const int q = s_ring[tid];
      rec_dist[q] = dist[i];
      rec_acc[q] = (uint8_t)a;
      rec_valid[q] = ring_valid != nullptr ? ring_valid[i] : 1;
      if (record) rec_logq[q] = logq[i];
    }
    const int cnt = min(kThreads, nb - start);
    const size_t row0 = (size_t)(lane0 + start);
    for (int idx = tid; idx < cnt * S; idx += kThreads) {
      const int j = idx / S, k = idx - j * S;
      const float val = ss[(row0 + j) * S + k];
      const int q = s_pos[j];
      if (q >= 0) {
        res_ss[(size_t)q * S + k] = val;
        if (res_feat != nullptr && feat_rows == nullptr)
          res_feat[(size_t)q * S + k] = dist_feature(val, x0[k], p);
      }
      const int g = s_ring[j];
      if (g >= 0) rec_ss[(size_t)g * S + k] = val;
    }
    if (res_feat != nullptr && feat_rows != nullptr) {
      for (int idx = tid; idx < cnt * F; idx += kThreads) {
        const int j = idx / F, k = idx - j * F;
        const int q = s_pos[j];
        if (q >= 0)
          res_feat[(size_t)q * F + k] = feat_rows[(row0 + j) * F + k];
      }
    }
    for (int idx = tid; idx < cnt * d; idx += kThreads) {
      const int j = idx / d, k = idx - j * d;
      const float val = theta[(row0 + j) * d + k];
      const int q = s_pos[j];
      if (q >= 0) res_theta[(size_t)q * d + k] = val;
      const int g = s_ring[j];
      if (record && g >= 0) rec_theta[(size_t)g * d + k] = val;
    }
    taken += chunk_total;
    __syncthreads();  // s_pos/s_ring/s_warp are rewritten by the next chunk
  }
}

__global__ void __launch_bounds__(kThreads)
compact_round_kernel(int B, int S, int d, const uint8_t* __restrict__ accept,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ theta,
                     const float* __restrict__ ss,
                     const float* __restrict__ dist,
                     const float* __restrict__ logw,
                     const float* __restrict__ logq,
                     const int* __restrict__ m,
                     const uint8_t* __restrict__ ring_valid, int n_cap,
                     float* __restrict__ res_theta, float* __restrict__ res_ss,
                     float* __restrict__ res_dist,
                     float* __restrict__ res_logw, int* __restrict__ res_slot,
                     int* __restrict__ res_m, int rec_cap,
                     float* __restrict__ rec_ss,
                     float* __restrict__ rec_dist,
                     uint8_t* __restrict__ rec_acc,
                     uint8_t* __restrict__ rec_valid,
                     float* __restrict__ rec_theta,
                     float* __restrict__ rec_logq,
                     int* __restrict__ counters) {
  const int n_acc0 = counters[0];
  const int r = counters[1];
  int taken, n_valid;
  compact_lanes(0, B, S, d, r, n_acc0, n_cap, accept, valid, theta, ss,
                dist, logw, logq, m, ring_valid, res_theta, res_ss, res_dist,
                res_logw, res_slot, res_m, nullptr, nullptr, 2.f, nullptr, 0,
                rec_cap, rec_ss, rec_dist, rec_acc, rec_valid, rec_theta,
                rec_logq, taken, n_valid);
  if (threadIdx.x == 0) {
    counters[0] = n_acc0 + taken;
    counters[1] = r + 1;
    counters[2] += n_valid;
  }
}

constexpr int kTargetCounter = 4;  // counters layout: ..., N_TARGET

__global__ void __launch_bounds__(kThreads)
compact_shards_kernel(int n_shards, int B_loc, int S, int d,
                      const uint8_t* __restrict__ accept,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ theta,
                      const float* __restrict__ ss,
                      const float* __restrict__ dist,
                      const float* __restrict__ logw,
                      const int* __restrict__ m, int cap_loc,
                      float* __restrict__ res_theta,
                      float* __restrict__ res_ss,
                      float* __restrict__ res_dist,
                      float* __restrict__ res_logw,
                      int* __restrict__ res_slot, int* __restrict__ res_m,
                      float* __restrict__ res_feat,
                      const float* __restrict__ x0, float p,
                      const float* __restrict__ feat_rows, int F,
                      int max_rounds,
                      int* __restrict__ counters, int* __restrict__ table) {
  const int s = blockIdx.x;
  if (s == 0 && threadIdx.x == 0) counters[1] += 1;
  int* row = table + 4 * s;
  const int n_tgt = counters[kTargetCounter];
  const int quota = n_tgt / n_shards + (s < n_tgt % n_shards ? 1 : 0);
  const int n_acc0 = row[0];
  const int r = row[1];
  if (n_acc0 >= quota || r >= max_rounds) return;  // finished: frozen
  const size_t o = (size_t)s * cap_loc;
  int taken, n_valid;
  compact_lanes(s * B_loc, B_loc, S, d, r, n_acc0, cap_loc, accept, valid,
                theta, ss, dist, logw, nullptr, m, nullptr, res_theta + o * d,
                res_ss + o * S, res_dist + o, res_logw + o, res_slot + o,
                res_m != nullptr ? res_m + o : nullptr,
                res_feat != nullptr ? res_feat + o * F : nullptr, x0, p,
                feat_rows, F, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, taken, n_valid);
  if (threadIdx.x == 0) {
    row[0] = n_acc0 + taken;
    row[1] = r + 1;
    row[2] += n_valid;
  }
}

}  // namespace

extern "C" int pyabc_compact_round(
    int B, int S, int d, const uint8_t* accept, const uint8_t* valid,
    const float* theta, const float* ss, const float* dist, const float* logw,
    const float* logq, const int* m, const uint8_t* ring_valid, int n_cap,
    float* res_theta,
    float* res_ss, float* res_dist, float* res_logw, int* res_slot,
    int* res_m, int rec_cap, float* rec_ss, float* rec_dist, uint8_t* rec_acc,
    uint8_t* rec_valid, float* rec_theta, float* rec_logq, int* counters,
    void* stream_ptr) {
  if ((rec_theta == nullptr) != (rec_logq == nullptr) ||
      (rec_theta != nullptr && logq == nullptr) ||
      (m == nullptr) != (res_m == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  compact_round_kernel<<<1, kThreads, 0, stream>>>(
      B, S, d, accept, valid, theta, ss, dist, logw, logq, m, ring_valid,
      n_cap,
      res_theta, res_ss, res_dist, res_logw, res_slot, res_m, rec_cap, rec_ss,
      rec_dist, rec_acc, rec_valid, rec_theta, rec_logq, counters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pyabc_compact_shards(
    int n_shards, int B_loc, int S, int d, const uint8_t* accept,
    const uint8_t* valid, const float* theta, const float* ss,
    const float* dist, const float* logw, const int* m, int cap_loc,
    float* res_theta, float* res_ss, float* res_dist, float* res_logw,
    int* res_slot, int* res_m, float* res_feat, const float* x0, float p,
    const float* feat_rows, int F, int max_rounds, int* counters, int* table,
    void* stream_ptr) {
  // the feature rows: |x - x0|^p (F = S, x0 given) or the given rows
  const bool given = feat_rows != nullptr;
  if (n_shards <= 0 || B_loc <= 0 || cap_loc <= 0 ||
      (m == nullptr) != (res_m == nullptr) ||
      (res_feat != nullptr && !given && (x0 == nullptr || F != S)) ||
      (given && (res_feat == nullptr || F <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  compact_shards_kernel<<<n_shards, kThreads, 0, stream>>>(
      n_shards, B_loc, S, d, accept, valid, theta, ss, dist, logw, m,
      cap_loc, res_theta, res_ss, res_dist, res_logw, res_slot, res_m,
      res_feat, x0, p, feat_rows, F, max_rounds, counters, table);
  return static_cast<int>(cudaGetLastError());
}
