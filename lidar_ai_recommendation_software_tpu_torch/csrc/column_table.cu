// The column table of the venue-scale clustering: the fill, from the
// cell-sorted point stream to the table and the two maps between them.
//
// Replaces the TPU kernel ops/pallas/fill.py::fill_planes (_fill_kernel)
// of lidar_ai_recommendation_software_tpu, which builds the (PX, 5*CAP,
// PYP) accumulator planes of ops/ccl.py::build_planes_stream with one-hot
// dispatch matmuls on the MXU, because the TPU has no fast scatter. A GPU
// gathers directly. None of the TPU layout is carried over: no 128-lane
// padding, no tile schedule, no bf16 splits.
//
// Layout: the table is (ncx + 2) x (ncy + 2) columns, one empty border
// column on each side, each column `cap` slots in a row, each slot a
// float4 (x, y, z, stream position as int bits). Empty slots hold
// EMPTY_COORD (1e18) in x, y, z and -1 in the last lane. A column's occupied
// slots are a prefix: the stream is sorted by cell id (stably, by the
// caller), and cell_start[c] is the stream position of cell c's first
// point, so column c holds stream positions cell_start[c] + r for the ranks
// r < min(cap, cell_start[c + 1] - cell_start[c]). Masked points sort last:
// stream positions from cell_start[ncells] on have no column.
//
// What bounds it on the H100: device memory. Most of the bytes are the
// table's writes (16 bytes a slot, every slot: 420 MB at the 3M-point
// scan's 1,282 x 1,282 columns of 16, 631 MB at the 10M buffer's columns
// of 24); the rest are a few bytes a stream position, two of them random:
// the gather of a placed point's coordinates (order is a permutation of
// points in no spatial order) and the scatter of point_stream. The design
// keeps the store stream dense and the threads off it, and keeps the
// scatter of the large streams out of the table's way in L2. A persistent
// grid (kBlocksPerSm blocks an SM) walks tiles of tile_cols = max(1,
// min(kThreads - 1, kTileSlots / cap)) whole columns, block b the tiles
// b, b + blocks, ... (so the blocks store neighbouring tiles at once):
//   1. A tile is one contiguous run of table slots and one contiguous run
//      of stream positions, [cell_start[c0], cell_start[c1]); the block
//      reads cell_start[c0..c1] once, coalesced, a thread a start. A
//      stream position's column is a binary search of those starts in
//      shared memory, its rank a difference: no thread divides. The tile
//      is built in shared memory (every slot empty, then the placed points
//      over them: order[k] read coalesced, a point's three coordinates as
//      three loads in flight, each thread's first point issued before the
//      block's barriers) and written by one bulk asynchronous copy
//      (cp.async.bulk, shared -> global, marked evict-first in L2),
//      double-buffered: the next tile is built while the copy engine
//      drains this one. stream_slot[k] is written coalesced, -1 for a
//      point past its column's cap; for streams of at most
//      kScatterInlineMax positions point_stream[order[k]] too.
//   2. Longer streams scatter point_stream after the block's tiles (the
//      blocks end them at about the same time), so the 4-byte writes meet
//      each other in L2 instead of being evicted half-written by the
//      table's stores: kUnroll of the block's tiles at once, order and
//      stream_slot read again, evict-first.
// The masked tail [cell_start[ncells], n) is cut into one chunk of
// masked_chunk = ceil(n / tiles) positions a tile (tile t takes [t, t + 1)
// x masked_chunk within it), so no tile carries the whole tail. The cell
// ids are not read at all. overflow: each thread counts its points past a
// cap; one sum a block and one integer atomicAdd. The launch function
// zeroes it first, in the same call (a memset on the stream, no
// allocation). ops/cuda/columns.py::fill_plan mirrors the plan;
// chip_smoke.py computes the bound from the run's sizes, and PERF.md has
// it beside the time; tools/fill_stages.py times the stages and the
// alternatives (PERF.md: the random gather and scatter keep the large
// streams under 50% of the bound).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileSlots = 2048;
constexpr int kBlocksPerSm = 3;
constexpr int kUnroll = 4;  // tiles a thread scatters for at once
// streams longer than this scatter point_stream after their tiles
constexpr int kScatterInlineMax = 1 << 21;
constexpr int kSmemPerBlock = 232448;
constexpr float kEmptyCoord = 1.0e18f;

struct FillArgs {
  const float* points;        // (N, 3) in point order
  const int32_t* order;       // (N,) the point at each stream position
  const int32_t* cell_start;  // (ncells + 1,)
  int32_t n, ncells, cap, tile_cols, tiles, masked_chunk;
  float4* table;              // (ncells * cap,)
  int32_t* point_stream;      // (N,)
  int32_t* stream_slot;       // (N,)
  int32_t* overflow;          // ()
};

__device__ __forceinline__ void bulk_store(float4* dst, const float4* src,
                                           uint32_t bytes, uint64_t policy) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;"
      :: "l"(dst), "r"(s), "r"(bytes), "l"(policy) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// a point's coordinates, three loads in flight
__device__ __forceinline__ float3 load_point(const float* points,
                                             int32_t i) {
  const float* p = points + 3 * static_cast<int64_t>(i);
  return make_float3(p[0], p[1], p[2]);
}

// this tile's chunk of the masked tail, [t, t + 1) x masked_chunk from
// cell_start[ncells] on: no slot, no stream position
__device__ __forceinline__ void masked_chunk(const FillArgs& a, int t,
                                             int64_t valid_end) {
  const int64_t m0 = static_cast<int64_t>(t) * a.masked_chunk;
  const int64_t m_end = m0 + a.masked_chunk;
  const int64_t m1 = m_end < a.n ? m_end : a.n;
  for (int64_t k = (m0 > valid_end ? m0 : valid_end) + threadIdx.x; k < m1;
       k += kThreads) {
    a.stream_slot[k] = -1;
    a.point_stream[__ldcs(a.order + k)] = -1;
  }
}

// kScatterAfter: point_stream in a second walk over the block's tiles (the
// large streams, whose points and point_stream do not stay in L2 beside
// the table's stores), else with each tile.
template <bool kScatterAfter>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
table_fill_kernel(const FillArgs a) {
  extern __shared__ __align__(128) float4 bufs[];  // 2 tiles, then words
  const int tile_slots = a.tile_cols * a.cap;
  int32_t* cs = reinterpret_cast<int32_t*>(bufs + 2 * tile_slots);
  int32_t* warp_dropped = cs + a.tile_cols + 1;
  const int tid = threadIdx.x;
  const int64_t valid_end = a.cell_start[a.ncells];
  const float4 empty = make_float4(kEmptyCoord, kEmptyCoord, kEmptyCoord,
                                   __int_as_float(-1));
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  int dropped = 0;  // the block's points past their column's cap

  // 1. the block's tiles, b, b + blocks, ...: the table (built in shared
  // memory, stored by one bulk copy) and stream_slot. Each thread's first
  // point of a tile is looked up and its coordinates loaded before the
  // tile's barriers.
  int buffer = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, buffer ^= 1) {
    const int c0 = t * a.tile_cols;
    const int ncols = min(a.tile_cols, a.ncells - c0);
    const int slots = ncols * a.cap;
    float4* buf = bufs + buffer * tile_slots;
    if (tid <= ncols) cs[tid] = a.cell_start[c0 + tid];
    const int32_t k0 = a.cell_start[c0];
    const int32_t k1 = a.cell_start[c0 + ncols];
    const int32_t kf = k0 + tid;
    const int32_t i_first = kf < k1 ? __ldcs(a.order + kf) : 0;
    const float3 first = kf < k1 ? load_point(a.points, i_first)
                                 : make_float3(0.f, 0.f, 0.f);
    // this buffer's copy, two tiles back, has read it out
    if (tid == 0) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    }
    __syncthreads();
    for (int s = tid; s < slots; s += kThreads) buf[s] = empty;
    __syncthreads();
    for (int32_t k = kf; k < k1; k += kThreads) {
      int lo = 0, hi = ncols - 1;  // the last column starting at or before k
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (cs[mid] <= k) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const int r = k - cs[lo];
      const int32_t i = k == kf ? i_first : __ldcs(a.order + k);
      if (r < a.cap) {
        const int slot = lo * a.cap + r;
        const float3 q = k == kf ? first : load_point(a.points, i);
        buf[slot] = make_float4(q.x, q.y, q.z, __int_as_float(k));
        a.stream_slot[k] = c0 * a.cap + slot;
        if (!kScatterAfter) a.point_stream[i] = k;
      } else {
        ++dropped;
        a.stream_slot[k] = -1;
        if (!kScatterAfter) a.point_stream[i] = -1;
      }
    }
    if (!kScatterAfter) masked_chunk(a, t, valid_end);
    // the tile's shared-memory writes, before the copy engine reads them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      bulk_store(a.table + static_cast<int64_t>(c0) * a.cap, buf,
                 static_cast<uint32_t>(slots) * sizeof(float4), policy);
    }
  }

  // 2. point_stream of the large streams, once the block's tiles are out
  // (the blocks end their tiles at about the same time), so the 4-byte
  // writes meet each other in L2 and not the table's stores: kUnroll of
  // the block's tiles at once, their stream ranges read again
  // (evict-first) a round of kThreads positions each at a time
  for (int t = blockIdx.x; kScatterAfter && t < a.tiles;
       t += gridDim.x * kUnroll) {
    int32_t lo[kUnroll], hi[kUnroll];
    int32_t rounds = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tu = t + u * gridDim.x;
      lo[u] = tu < a.tiles ? a.cell_start[tu * a.tile_cols] : 0;
      hi[u] = tu < a.tiles
                  ? a.cell_start[min((tu + 1) * a.tile_cols, a.ncells)] : 0;
      rounds = max(rounds, (hi[u] - lo[u] + kThreads - 1) / kThreads);
    }
    for (int32_t round = 0; round < rounds; ++round) {
      int32_t i[kUnroll], slot[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int32_t k = lo[u] + round * kThreads + tid;
        i[u] = k < hi[u] ? __ldcs(a.order + k) : 0;
        slot[u] = k < hi[u] ? __ldcs(a.stream_slot + k) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int32_t k = lo[u] + round * kThreads + tid;
        if (k < hi[u]) a.point_stream[i[u]] = slot[u] >= 0 ? k : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u * gridDim.x < a.tiles) {
        masked_chunk(a, t + u * gridDim.x, valid_end);
      }
    }
  }
  if (tid == 0) {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
  dropped = __reduce_add_sync(0xffffffffu, dropped);
  if ((tid & 31) == 0) warp_dropped[tid / 32] = dropped;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_dropped[w];
    if (total > 0) atomicAdd(a.overflow, total);
  }
}

}  // namespace

// The fill by the plan of ops/cuda/columns.py::fill_plan, derived here
// from the shapes; `blocks` is the persistent grid (at most the tiles).
// Refuses a cap whose double-buffered tile of one column does not fit a
// block's shared memory.
extern "C" int table_fill_launch(const void* points, const void* order,
                                 const void* cell_start, int n, int ncells,
                                 int cap, int blocks, void* table,
                                 void* point_stream, void* stream_slot,
                                 void* overflow, void* stream) {
  if (n < 0 || ncells < 1 || cap < 1 ||
      static_cast<int64_t>(ncells) * cap > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile_cols = max(1, min(kThreads - 1, kTileSlots / cap));
  const int tiles = (ncells + tile_cols - 1) / tile_cols;
  const size_t smem = 2 * static_cast<size_t>(tile_cols) * cap *
                          sizeof(float4) +
                      sizeof(int32_t) * (tile_cols + 1 + kWarps);
  if (smem > kSmemPerBlock || blocks < 1 || blocks > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool after = n > kScatterInlineMax;
  auto* kernel =
      after ? table_fill_kernel<true> : table_fill_kernel<false>;
  static int ready_on[2] = {-1, -1};  // the device whose limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != ready_on[after]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemPerBlock);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready_on[after] = dev;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(overflow, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  FillArgs a;
  a.points = static_cast<const float*>(points);
  a.order = static_cast<const int32_t*>(order);
  a.cell_start = static_cast<const int32_t*>(cell_start);
  a.n = n;
  a.ncells = ncells;
  a.cap = cap;
  a.tile_cols = tile_cols;
  a.tiles = tiles;
  a.masked_chunk =
      static_cast<int32_t>((static_cast<int64_t>(n) + tiles - 1) / tiles);
  a.table = static_cast<float4*>(table);
  a.point_stream = static_cast<int32_t*>(point_stream);
  a.stream_slot = static_cast<int32_t*>(stream_slot);
  a.overflow = static_cast<int32_t*>(overflow);
  kernel<<<blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
