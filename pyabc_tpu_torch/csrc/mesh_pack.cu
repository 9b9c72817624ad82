// K24e mesh_pack / mesh_unpack: the mesh's gather, packed.
//
// Replaces: the reshape and concatenation of
// pyabc_tpu/inference/util.py::_HybridShards.rows (:2575-2577), which
// all-gathers each device's block of the shards' columns in device order,
// and the out_spec P(None, axis) of the sharded chunk (:3040-3046).
//
// A device mesh rank of the port owns v of the run's n shards. After its
// generation it packs the pieces the replicated stage reads (its counters
// and (v, 4) table, its reservoir blocks' columns, its moment blocks) into
// one contiguous buffer of 32-bit words (mesh_pack), so a generation needs
// one gather; the gathered (w, W) buffer is then scattered into the global
// shard-blocked arrays (mesh_unpack): piece k of rank r lands at words
// [r * len_k, (r + 1) * len_k) of its destination, since rank r's shards
// are the global shards [r v, (r + 1) v). A null destination skips its
// piece (the head, which the host reads from its copy of the buffer).
// Every piece is 4-byte words (int32 columns and float32 bits), so both
// directions are exact copies.
//
// Design: one thread a word, a grid-stride loop over the buffer; a thread
// finds its piece by a linear search of at most kMaxPieces prefix ends,
// which ride the launch arguments (no descriptor copy to the card).
//
// Bound on an H100: bytes, each word read once and written once. At the LV
// mesh leg (n_cap 16384 rows of 4 + 40 + 4 words, w 2 or 4) a pack moves
// 0.8-1.6 MB and an unpack 3.1 MB a way: about 1 microsecond at 3.35 TB/s,
// so both are launch bound.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPieces = 16;
constexpr int kMaxBlocks = 1024;

struct PackArgs {
  const int32_t* src[kMaxPieces];
  long long end[kMaxPieces];  // exclusive prefix ends in words
  int n;
};

struct UnpackArgs {
  int32_t* dst[kMaxPieces];
  long long end[kMaxPieces];
  int n;
};

__device__ __forceinline__ int piece_of(const long long* end, int n,
                                        long long i) {
  int k = 0;
  while (k < n - 1 && i >= end[k]) ++k;
  return k;
}

__global__ void __launch_bounds__(kThreads)
mesh_pack_kernel(PackArgs a, long long total, int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int k = piece_of(a.end, a.n, i);
    const long long start = k ? a.end[k - 1] : 0;
    out[i] = a.src[k][i - start];
  }
}

__global__ void __launch_bounds__(kThreads)
mesh_unpack_kernel(UnpackArgs a, const int32_t* __restrict__ buf, int w,
                   long long W) {
  const long long total = (long long)w * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long r = idx / W;
    const long long i = idx - r * W;
    const int k = piece_of(a.end, a.n, i);
    if (a.dst[k] == nullptr) continue;
    const long long start = k ? a.end[k - 1] : 0;
    const long long len = a.end[k] - start;
    a.dst[k][r * len + (i - start)] = buf[idx];
  }
}

int grid_of(long long total) {
  const long long g = (total + kThreads - 1) / kThreads;
  return (int)(g < kMaxBlocks ? (g > 0 ? g : 1) : kMaxBlocks);
}

}  // namespace

// src / dst: n_pieces pointers (n_pieces <= 16); lens: n_pieces word counts
// (a rank's piece); out (pack): sum(lens) words; buf (unpack): w rows of
// sum(lens) words.
extern "C" int pyabc_mesh_pack(int n_pieces, const void* const* src,
                               const long long* lens, int32_t* out,
                               void* stream_ptr) {
  if (n_pieces <= 0 || n_pieces > kMaxPieces)
    return static_cast<int>(cudaErrorInvalidValue);
  PackArgs a{};
  long long total = 0;
  for (int k = 0; k < n_pieces; ++k) {
    if (lens[k] < 0) return static_cast<int>(cudaErrorInvalidValue);
    a.src[k] = static_cast<const int32_t*>(src[k]);
    total += lens[k];
    a.end[k] = total;
  }
  a.n = n_pieces;
  if (total == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  mesh_pack_kernel<<<grid_of(total), kThreads, 0, stream>>>(a, total, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pyabc_mesh_unpack(int n_pieces, void* const* dst,
                                 const long long* lens, const int32_t* buf,
                                 int w, void* stream_ptr) {
  if (n_pieces <= 0 || n_pieces > kMaxPieces || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  UnpackArgs a{};
  long long W = 0;
  for (int k = 0; k < n_pieces; ++k) {
    if (lens[k] < 0) return static_cast<int>(cudaErrorInvalidValue);
    a.dst[k] = static_cast<int32_t*>(dst[k]);
    W += lens[k];
    a.end[k] = W;
  }
  a.n = n_pieces;
  if (W == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  mesh_unpack_kernel<<<grid_of((long long)w * W), kThreads, 0, stream>>>(
      a, buf, w, W);
  return static_cast<int>(cudaGetLastError());
}
