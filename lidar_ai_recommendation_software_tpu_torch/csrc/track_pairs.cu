// track_pairs: the temporal tracking's all-pairs tests in one kernel body,
// with two reductions kept in registers (track_kernel<kNodes>).
//
//   track_match (kNodes false): for each slot of two frames of people, the
//   nearest slot of the other frame, both ways. Block row y = 0 gives each
//   slot of frame A its nearest slot of frame B (fwd) and that squared
//   distance (dmin); y = 1 gives each slot of B its nearest of A (bwd).
//   track_nodes (kNodes true): for each lattice node, the kept velocity
//   samples of every pair of frames within g2 of it, summed (wsum) and
//   counted (cnt).
//
// Replaces no pallas_call. The JAX package tracks in jnp
// (lidar_ai_recommendation_software_tpu/models/temporal.py: match_people,
// the node sums of temporal_flow_multi). The port's plain versions
// (ops/cuda/track.py: nearest_reference, node_sums_reference) build the
// (K, K) distance matrix of a pair and (nodes, K) masked sums in device
// memory: 822 MB and ~10 GB of traffic a pair at K = 14,336 people slots,
// for some 470 live people a frame.
//
// What each computes is the plain version's, bit for bit but for the order
// of the node sums:
//   - a pair's squared distance is dx*dx + dy*dy, the differences row minus
//     column, each operation rounded on its own (__fsub_rn / __fmul_rn /
//     __fadd_rn: nvcc would otherwise contract them into fused multiply-adds).
//     Row minus column and column minus row are exact negations, so both
//     directions of a match see the same d2;
//   - match: a pair with a masked end counts as 1e18; among equal distances
//     the first index wins; a masked row gets index 0 and 1e18, argmin's
//     answer for a row that is all 1e18. A thread walks its row's columns in
//     ascending order and keeps a strict minimum, so the first index wins
//     within the live columns; the masked columns are one candidate, (1e18,
//     the first masked column), taken as a (value, index) pair at the end.
//   - nodes: a sample counts where d2 <= g2 (g2 read from the device: no read
//     of the host). For each pair in order a node's samples are added in
//     index order into a pair sum that starts at 0, then the pair sum into
//     the node's total, as the plain version adds each pair's sum. The plain
//     version's sum over K runs in torch's order, so float32 sums differ by
//     reassociation; counts are exact. No atomics: every run gives the same
//     bits.
//
// Design for Hopper: one body over a grid of row tiles. blockIdx.x is a tile
// of kRowTile rows, kRowsPerThread a thread, in registers; the block walks
// every column tile of the other side (every pair of frames, for the node
// sums), so each thread owns its rows' reductions and no second pass or
// atomic is needed.
//   - A column tile is kColTile columns, kColsPerThread a thread. Only kept
//     columns (live slots; kept samples) are staged in shared memory, as
//     float4 (x, y, the index or the velocity): a warp ballot compacts them
//     warp by warp in ascending order, as csrc/eps_edges.cu does, so the
//     test loop reads no mask. A tile with nothing kept is skipped whole
//     (__syncthreads_or), double-buffered with one barrier a tile.
//   - A block whose rows are all masked (match: the slots past the frame's
//     people) writes (0, 1e18) and returns; an invalid row holds NaN, which
//     fails every test.
//
// What bounds it on the H100: the tests between live rows and kept columns,
// 7 floating-point instructions that cannot fuse (2 differences, 2 products,
// a sum, a compare, a select or add), on 132 SMs x 128 FP32 lanes at 1.98 GHz,
// about 3.3e13 a second: ~470 x 470 pairs both ways, or 16,384 nodes x ~1,400
// kept samples, are some microseconds. The inputs are the slots' 9 bytes
// (K x 9 bytes a frame, 17 with a velocity) and the outputs 8 or 12 bytes a
// row. With so little work the walk over K / kColTile column tiles, a global
// load and a barrier each, sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;  // rows a thread holds
constexpr int kRowTile = kThreads * kRowsPerThread;
constexpr int kColsPerThread = 4;  // columns a thread stages a tile
constexpr int kColTile = kThreads * kColsPerThread;
constexpr int kSegments = kColTile / 32;  // a warp's 32 columns of a round
constexpr float kFar = 1e18f;  // a masked pair's distance

__device__ __forceinline__ float squared(float qx, float qy, float cx,
                                         float cy) {
  const float dx = __fsub_rn(qx, cx);
  const float dy = __fsub_rn(qy, cy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Match: a (K, 2) frames a and b, masks a_mask, b_mask; rows of a against
// columns of b for blockIdx.y = 0, b against a for 1; idx (2, K): fwd, bwd;
// dmin (K,). Nodes: a (G, 2) the nodes, a_mask unused; b (pairs + 1, K, 2)
// the frames, pair t's samples at frame t + 1; b_mask (pairs, K) keep; vel
// (pairs, K, 2); wsum (G, 2), cnt (G,).
template <bool kNodes>
__global__ void __launch_bounds__(kThreads)
track_kernel(const float2* __restrict__ a, const uint8_t* __restrict__ a_mask,
             const float2* __restrict__ b, const uint8_t* __restrict__ b_mask,
             const float2* __restrict__ vel, const float* __restrict__ g2p,
             int32_t n_rows, int32_t n_cols, int32_t pairs,
             int32_t* __restrict__ idx, float* __restrict__ dmin,
             float2* __restrict__ wsum, int32_t* __restrict__ cnt) {
  // each column tile's kept columns: segment s = round * kWarps + warp holds
  // that warp's kept columns of the round at [32 s, 32 s + kept[s]), in
  // ascending order, so the segments in turn are the tile's in order
  __shared__ float4 staged[2][kColTile];
  __shared__ int kept[2][kSegments];
  __shared__ int first_masked;  // match: the columns' first masked slot

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool flip = !kNodes && blockIdx.y == 1;
  const float2* rows = flip ? b : a;
  const uint8_t* row_mask = flip ? b_mask : a_mask;
  const float2* cols = flip ? a : b;
  const uint8_t* col_mask = flip ? a_mask : b_mask;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRowTile;
  const float nan = __int_as_float(0x7fffffff);
  const float g2 = kNodes ? *g2p : 0.0f;

  float qx[kRowsPerThread], qy[kRowsPerThread];
  float best[kRowsPerThread];  // match: the least d2 so far, and its column
  int32_t arg[kRowsPerThread];
  float sx[kRowsPerThread], sy[kRowsPerThread];  // nodes: the totals
  float px[kRowsPerThread], py[kRowsPerThread];  // nodes: this pair's sums
  int32_t total[kRowsPerThread], count[kRowsPerThread];
  bool live = false;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t i = r0 + r * kThreads + tid;
    const bool valid = i < n_rows && (kNodes || row_mask[i] != 0);
    const float2 q = valid ? rows[i] : make_float2(nan, nan);
    qx[r] = q.x;
    qy[r] = q.y;
    best[r] = __int_as_float(0x7f800000);  // +inf
    arg[r] = 0;
    sx[r] = sy[r] = px[r] = py[r] = 0.0f;
    total[r] = count[r] = 0;
    live |= valid;
  }
  if (tid == 0) first_masked = n_cols;

  if (__syncthreads_or(live)) {
    const int n_tiles = (n_cols + kColTile - 1) / kColTile;
    const int passes = kNodes ? pairs : 1;
    int buf = 0;
    for (int t = 0; t < passes; ++t) {
      const float2* pos = kNodes ? b + (t + 1) * static_cast<int64_t>(n_cols)
                                 : cols;
      const uint8_t* keep_of =
          kNodes ? b_mask + t * static_cast<int64_t>(n_cols) : col_mask;
      const float2* v = kNodes ? vel + t * static_cast<int64_t>(n_cols)
                               : nullptr;
      // a buffer is written again two tiles later, after the barrier of the
      // tile between, which every thread reaches only when done reading it
      for (int tile = 0; tile < n_tiles; ++tile, buf ^= 1) {
        bool any = false;
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const int j = tile * kColTile + c * kThreads + tid;
          const bool inside = j < n_cols;
          const bool keep = inside && keep_of[j] != 0;
          const uint32_t ballot = __ballot_sync(0xffffffffu, keep);
          const int seg = c * kWarps + warp;
          if (keep) {
            const float2 p = pos[j];
            const float4 item =
                kNodes ? make_float4(p.x, p.y, v[j].x, v[j].y)
                       : make_float4(p.x, p.y, __int_as_float(j), 0.0f);
            staged[buf][seg * 32 + __popc(ballot & ((1u << lane) - 1u))] =
                item;
          }
          if (lane == 0) kept[buf][seg] = __popc(ballot);
          if (!kNodes) {
            const uint32_t masked = __ballot_sync(0xffffffffu,
                                                  inside && !keep);
            if (lane == 0 && masked != 0) {
              atomicMin(&first_masked, j + __ffs(masked) - 1);
            }
          }
          any |= keep;
        }
        if (!__syncthreads_or(any)) continue;
#pragma unroll 1
        for (int s = 0; s < kSegments; ++s) {
          const float4* seg = staged[buf] + s * 32;
          const int m = kept[buf][s];
#pragma unroll 4
          for (int q = 0; q < m; ++q) {
            const float4 col = seg[q];
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r) {
              const float d2 = squared(qx[r], qy[r], col.x, col.y);
              if (kNodes) {
                if (d2 <= g2) {
                  px[r] = __fadd_rn(px[r], col.z);
                  py[r] = __fadd_rn(py[r], col.w);
                  ++count[r];
                }
              } else if (d2 < best[r]) {
                best[r] = d2;
                arg[r] = __float_as_int(col.z);
              }
            }
          }
        }
      }
      if (kNodes) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          sx[r] = __fadd_rn(sx[r], px[r]);
          sy[r] = __fadd_rn(sy[r], py[r]);
          total[r] += count[r];
          px[r] = py[r] = 0.0f;
          count[r] = 0;
        }
      }
    }
  }
  __syncthreads();  // first_masked is final
  const int first = first_masked;

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t i = r0 + r * kThreads + tid;
    if (i >= n_rows) continue;
    if (kNodes) {
      wsum[i] = make_float2(sx[r], sy[r]);
      cnt[i] = total[r];
      continue;
    }
    float v = best[r];
    int32_t k = arg[r];
    if (row_mask[i] == 0) {
      v = kFar;
      k = 0;
    } else if (first < n_cols && (kFar < v || (kFar == v && first < k))) {
      v = kFar;
      k = first;
    }
    idx[blockIdx.y * static_cast<int64_t>(n_rows) + i] = k;
    if (!flip) dmin[i] = v;
  }
}

// The grid's row tiles must cover every row; the block walks the columns.
bool covers(int n_rows, int n_cols, int grid_x) {
  return n_rows > 0 && n_cols > 0 && grid_x >= 1 &&
         static_cast<int64_t>(grid_x) * kRowTile >= n_rows;
}

}  // namespace

// The launch plans come from ops/cuda/track.py (match_plan, nodes_plan),
// which mirror this file's tile sizes; a grid that does not cover the slots
// or the nodes gives cudaErrorInvalidValue, as does a match grid of other
// than 2 rows of blocks or a node launch without a pair.
extern "C" int track_match_launch(const void* a, const void* a_mask,
                                  const void* b, const void* b_mask, int k,
                                  int grid_x, int grid_y, void* idx,
                                  void* dmin, void* stream) {
  if (!covers(k, k, grid_x) || grid_y != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  track_kernel<false><<<dim3(grid_x, grid_y), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<const uint8_t*>(a_mask),
      static_cast<const float2*>(b), static_cast<const uint8_t*>(b_mask),
      nullptr, nullptr, k, k, 1, static_cast<int32_t*>(idx),
      static_cast<float*>(dmin), nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int track_nodes_launch(const void* nodes, const void* g2,
                                  const void* positions, const void* keep,
                                  const void* vel, int g, int k, int pairs,
                                  int grid_x, int grid_y, void* wsum,
                                  void* cnt, void* stream) {
  if (!covers(g, k, grid_x) || grid_y != 1 || pairs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  track_kernel<true><<<dim3(grid_x, grid_y), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(nodes), nullptr,
      static_cast<const float2*>(positions),
      static_cast<const uint8_t*>(keep), static_cast<const float2*>(vel),
      static_cast<const float*>(g2), g, k, pairs, nullptr, nullptr,
      static_cast<float2*>(wsum), static_cast<int32_t*>(cnt));
  return static_cast<int>(cudaGetLastError());
}
