// The tail of the venue-scale clustering in one kernel: stream-order labels
// -> dense cluster ids in point order, and the number of clusters.
//
// Replaces ops/pallas/fill.py::extract_stream (_extract_kernel) of
// lidar_ai_recommendation_software_tpu, which reads the labels back into
// stream order with a transposed one-hot matmul, together with the jnp code
// that ranks the clusters after it (ops/ccl.py::dbscan_gs: a two-key sort,
// a cumulative sum and a sort back to point order). The port's first
// design was a gather kernel (column_table.cu, table_gather) followed by a
// dozen PyTorch launches, each reading or writing every point.
//
// In:  labels (N,) int32 in stream order, INT_MAX where a position has no
//      label (noise, or no slot); a cluster's label is its smallest point
//      index, and that point is the cluster's representative: the one
//      point whose label is its own index;
//      point_stream (N,) int32, each point's stream position, -1 where the
//      point has no slot (masked, or past its column's cap).
// Out: dense (N,) int32: -1 where the point has no label, else the number
//      of representatives at or below its label (clamped to N - 1) minus
//      one: the cluster's rank by its smallest point index;
//      n_clusters () int32: the representatives.
//
// Labels point forward: a border point takes the smallest label of its
// core neighbours, which may be a larger point index than its own and lie
// in any block's range. So the ranks cannot come from one pass in index
// order (a look-back scan would wait on a block that need not be resident).
// Two launches of the same grid, so that every block's phase 1 is done
// before any block's phase 2:
//
//   phase 1: block b takes points [b * per_block, (b + 1) * per_block), a
//     multiple of 32. A warp takes 4 words of 32 points at a time (four
//     gathers in flight), keeps each point's label in `dense` (-1 for
//     none), and votes the representatives into one 32-bit word a word
//     (__ballot_sync). A scan over the block's words, 64 at a time with
//     the running count carried, gives each word the representatives
//     before it in the block's range; word and count go to `words` as one
//     uint2, the block's total to `totals`.
//   phase 2: each block scans the block totals in shared memory, then for
//     each of its points reads the label back and the (word, count) pair
//     of the label's word, 8 bytes for 32 points (through L1, 256 KB at
//     1M points: 17% faster there than through L2 alone), and writes the
//     rank: the prefix of the word's block +
//     the count + __popc of the word's bits at or below the label, - 1.
//     The last block writes n_clusters.
//
// What bounds it on the H100: device memory. Any implementation reads
// point_stream once and a label per placed point and writes dense once:
// 12 bytes a point. Point order is not stream order, so each label read
// is a 32-byte sector of its own, and so is each word the ranks look up.
// This design also writes the labels and reads them back (L2-resident up
// to about 4M points) and writes the words (1/4 byte a point). Integers
// only: the ranks are exact, and no atomic touches a value, so the result
// is the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                       // words a warp takes at once
constexpr int kChunkWords = kWarps * kUnroll;    // 64 words, 2,048 points
constexpr int kMaxBlocks = 1024;                 // block totals phase 2 scans
constexpr int32_t kIntMax = 0x7fffffff;

static_assert(kChunkWords == 64, "the chunk scan takes 2 words a lane");
static_assert(kMaxBlocks == 2 * kThreads, "phase 2 scans 2 totals a thread");

struct Args {
  const int32_t* labels;        // (N,) stream order
  const int32_t* point_stream;  // (N,)
  int32_t n;
  int32_t per_block;            // points a block takes, a multiple of 32
  int32_t* dense;               // (N,) out; the labels between the phases
  uint2* words;                 // (ceil(N / 32),) (bits, count before)
  int32_t* totals;              // (gridDim.x,) representatives a block
  int32_t* n_clusters;          // () out
};

// The end of the range of points that starts at `lo`.
__device__ int64_t range_end(const Args& a, int64_t lo) {
  const int64_t end = lo + a.per_block;
  return end < a.n ? end : static_cast<int64_t>(a.n);
}

// Inclusive sum over the warp's lanes.
__device__ int32_t warp_inclusive(int32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int32_t up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads, 2) dense_tail_phase1(Args a) {
  __shared__ int32_t before[kChunkWords];
  __shared__ int32_t chunk_total;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * a.per_block;
  const int64_t hi = range_end(a, lo);
  const int64_t nwords = hi > lo ? (hi - lo + 31) / 32 : 0;
  int32_t carry = 0;
  for (int64_t c0 = 0; c0 < nwords; c0 += kChunkWords) {
    int32_t k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = lo + (c0 + warp * kUnroll + u) * 32 + lane;
      k[u] = i < hi ? a.point_stream[i] : -1;
    }
    int32_t lab[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t v = k[u] >= 0 ? a.labels[k[u]] : kIntMax;
      lab[u] = v == kIntMax ? -1 : v;
    }
    uint32_t bits[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = lo + (c0 + warp * kUnroll + u) * 32 + lane;
      if (i < hi) a.dense[i] = lab[u];
      bits[u] = __ballot_sync(0xffffffffu, i < hi && lab[u] == i);
    }
    if (lane < kUnroll) {
      uint32_t mine = bits[0];
#pragma unroll
      for (int u = 1; u < kUnroll; ++u) mine = lane == u ? bits[u] : mine;
      before[warp * kUnroll + lane] = __popc(mine);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the chunk's 64 word counts
      const int32_t x0 = before[2 * lane];
      const int32_t x1 = before[2 * lane + 1];
      const int32_t incl = warp_inclusive(x0 + x1, lane);
      before[2 * lane] = incl - x0 - x1;
      before[2 * lane + 1] = incl - x1;
      if (lane == 31) chunk_total = incl;
    }
    __syncthreads();
    if (lane < kUnroll) {
      const int64_t w = c0 + warp * kUnroll + lane;
      uint32_t mine = bits[0];
#pragma unroll
      for (int u = 1; u < kUnroll; ++u) mine = lane == u ? bits[u] : mine;
      if (w < nwords) {
        const int32_t count = carry + before[warp * kUnroll + lane];
        a.words[lo / 32 + w] = make_uint2(mine, static_cast<uint32_t>(count));
      }
    }
    carry += chunk_total;
    __syncthreads();  // `before` and `chunk_total` are rewritten next chunk
  }
  if (threadIdx.x == 0) a.totals[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(kThreads, 2) dense_tail_phase2(Args a) {
  __shared__ int32_t prefix[kMaxBlocks];
  __shared__ int32_t warp_sums[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nb = static_cast<int>(gridDim.x);
  // exclusive scan of the block totals, two a thread
  const int t0 = 2 * threadIdx.x;
  const int32_t x0 = t0 < nb ? __ldcg(a.totals + t0) : 0;
  const int32_t x1 = t0 + 1 < nb ? __ldcg(a.totals + t0 + 1) : 0;
  const int32_t incl = warp_inclusive(x0 + x1, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t s = lane < kWarps ? warp_sums[lane] : 0;
    const int32_t si = warp_inclusive(s, lane);
    if (lane < kWarps) warp_sums[lane] = si - s;
  }
  __syncthreads();
  const int32_t base = warp_sums[warp] + incl - x0 - x1;
  prefix[t0] = base;
  prefix[t0 + 1] = base + x0;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == kThreads - 1) {
    *a.n_clusters = base + x0 + x1;  // the last thread's inclusive sum
  }
  __syncthreads();

  const int64_t lo = static_cast<int64_t>(blockIdx.x) * a.per_block;
  const int64_t hi = range_end(a, lo);
  const int32_t last = a.n - 1;
  for (int64_t i0 = lo + threadIdx.x; i0 < hi; i0 += kUnroll * kThreads) {
    int32_t lab[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * kThreads;
      lab[u] = i < hi ? __ldcg(a.dense + i) : -1;
    }
    // through L1: the launch before wrote the words, so no line L1 caches
    // is stale
    uint2 e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      e[u] = lab[u] >= 0 ? __ldca(a.words + (min(lab[u], last) >> 5))
                         : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i >= hi) continue;
      int32_t rank = -1;
      if (lab[u] >= 0) {
        const int32_t l = min(lab[u], last);
        const uint32_t upto = 0xffffffffu >> (31 - (l & 31));
        rank = prefix[l / a.per_block] + static_cast<int32_t>(e[u].y) +
               __popc(e[u].x & upto) - 1;
      }
      a.dense[i] = rank;
    }
  }
}

}  // namespace

// The plan (`blocks` of `per_block` points) is the caller's
// (ops/cuda/columns.py::dense_tail_plan); it is refused unless it covers
// the N points with at most kMaxBlocks blocks of a multiple of 32 points
// each. `scratch` holds the words (8 bytes per 32 points) and then the
// block totals (4 bytes a block).
extern "C" int dense_tail_launch(const void* labels, const void* point_stream,
                                 int n, int blocks, int per_block,
                                 void* dense, void* scratch,
                                 void* n_clusters, void* stream) {
  if (n < 0 || blocks < 1 || blocks > kMaxBlocks || per_block < 32 ||
      per_block % 32 != 0 ||
      static_cast<int64_t>(blocks) * per_block < n ||
      static_cast<int64_t>(blocks - 1) * per_block >= (n > 0 ? n : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.labels = static_cast<const int32_t*>(labels);
  a.point_stream = static_cast<const int32_t*>(point_stream);
  a.n = n;
  a.per_block = per_block;
  a.dense = static_cast<int32_t*>(dense);
  a.words = static_cast<uint2*>(scratch);
  a.totals = reinterpret_cast<int32_t*>(static_cast<uint2*>(scratch) +
                                        (static_cast<int64_t>(n) + 31) / 32);
  a.n_clusters = static_cast<int32_t*>(n_clusters);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dense_tail_phase1<<<blocks, kThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_tail_phase2<<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
