// eps_edges: the eps-adjacency of a clustering buffer as compressed rows.
// For every valid point i, the valid points j with squared distance at most
// r2 (self included), in ascending j; the rows one after another.
//
// Replaces no pallas_call. It is the all-pairs pass that the JAX package's
// dbscan_bruteforce (lidar_ai_recommendation_software_tpu/ops/clustering.py:
// 54-96) runs as tiled jnp: row chunks of 2,048 in lax.map, each row packed
// into a bitmask of the columns within eps. The port's plain version
// (ops/cuda/eps.py::eps_edges_reference) tests chunks of 2^24 pairs with
// elementwise PyTorch operators and compacts each chunk with nonzero, a read
// of the host a chunk. Here two launches and one read build the same list.
//
// The pair test is the plain version's, bit for bit: the differences are
// query minus column, the squared distance is summed axis by axis,
// ((dx*dx + dy*dy) + dz*dz), with every product and sum rounded on its own
// (__fsub_rn / __fmul_rn / __fadd_rn: nvcc would otherwise contract them into
// fused multiply-adds), and the comparison is d2 <= r2. The caller forms r2
// as the plain version does, float32(eps) squared in float32. D is 1, 2 or
// 3; a missing axis reads 0 on both ends, whose square adds an exact 0.
//
// Design for Hopper: two passes of one kernel body (kFill false, then true)
// over a 2-D grid. blockIdx.x is a tile of kRowTile consecutive rows, each
// thread holding kRowsPerThread of them in registers; blockIdx.y is a slice
// of tiles_per_slice column tiles of kColTile columns. The launch plan
// (ops/cuda/eps.py::eps_plan) sizes the slices so that the grid holds some
// thousands of blocks, enough to fill the 132 SMs at the sensor frame's
// 32,768 points.
//   - The block stages each column tile in shared memory as float4 (x, y, z,
//     the column's index), one column a thread, double-buffered with one
//     barrier a tile as csrc/radius_count.cu does. Only valid columns are
//     staged: a warp ballot compacts them warp by warp in ascending order, so
//     the pair loop reads no mask, and a tile with no valid column is
//     skipped whole (__syncthreads_or). A staged column serves
//     kRowsPerThread pair tests for one broadcast load.
//   - An invalid row holds NaN, which fails every test; a block whose rows
//     are all invalid (the buffer's padded tail) tests nothing.
//   - The count pass writes each (row, slice)'s count, (N, slices) int32,
//     rows major. The wrapper's prefix over them, in that order, gives
//     every (row, slice)'s end in the edge list; the last end is the total,
//     the one value the host reads, which sizes the output.
//   - The fill pass repeats the test and writes each hit's column at its
//     row's position in the slice. A thread owns its rows and walks the
//     slice's columns in ascending order, so each row's columns land in
//     ascending order without a ballot or an atomic: the same edges in the
//     same order on every run. A block none of whose rows has an edge in
//     its slice returns at once.
//   - No culling by the tiles' bounding boxes: the clustering buffer holds
//     the non-ground points in scan order, which in every benchmarked cell
//     is spatially random, so a tile's box spans the venue.
//
// What bounds it on the H100: the pair tests. Each is 9 floating-point
// instructions that cannot fuse (3 differences, 3 products, 2 sums, a
// compare), on 132 SMs x 128 FP32 lanes at 1.98 GHz, about 3.3e13 a
// second; two passes over the 28,000^2 valid pairs of a sensor frame are
// about 1.4e10 instructions, 0.4 ms. The inputs are N * (4 D + 1) bytes and
// the edges a few MB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;  // query points a thread holds
constexpr int kRowTile = kThreads * kRowsPerThread;
constexpr int kColTile = kThreads;  // columns staged a tile, one a thread

__device__ __forceinline__ float coord(const float* __restrict__ pts,
                                       int64_t i, int d, int axis) {
  return axis < d ? pts[i * d + axis] : 0.0f;
}

template <bool kFill>
__global__ void __launch_bounds__(kThreads)
eps_kernel(const float* __restrict__ pts,          // (N, d)
           const uint8_t* __restrict__ mask,       // (N,)
           int32_t d, float r2, int32_t n, int32_t tiles_per_slice,
           int32_t slices,
           int32_t* __restrict__ slice_counts,     // (N, slices)
           const int64_t* __restrict__ ends,       // (N * slices,), fill
           int32_t* __restrict__ cols) {           // (E,), fill
  // each column tile, compacted warp by warp: warp w's valid columns at
  // [32 w, 32 w + kept[w]), in ascending order
  __shared__ float4 staged[2][kColTile];
  __shared__ int kept[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRowTile;
  const float nan = __int_as_float(0x7fffffff);
  float qx[kRowsPerThread], qy[kRowsPerThread], qz[kRowsPerThread];
  int32_t count[kRowsPerThread];
  int32_t* out[kRowsPerThread];
  bool live = false;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t i = r0 + r * kThreads + tid;
    const bool valid = i < n && mask[i] != 0;
    qx[r] = valid ? coord(pts, i, d, 0) : nan;
    qy[r] = valid ? coord(pts, i, d, 1) : 0.0f;
    qz[r] = valid ? coord(pts, i, d, 2) : 0.0f;
    count[r] = 0;
    out[r] = cols;
    if (kFill) {
      if (i < n) {
        const int64_t k = i * slices + s;
        const int32_t c = slice_counts[k];
        out[r] = cols + (ends[k] - c);
        live |= c > 0;
      }
    } else {
      live |= valid;
    }
  }

  if (__syncthreads_or(live)) {
    const int n_tiles = (n + kColTile - 1) / kColTile;
    const int t0 = s * tiles_per_slice;
    const int t1 = min(t0 + tiles_per_slice, n_tiles);
    for (int t = t0; t < t1; ++t) {
      // a buffer is written again two tiles later, after the barrier of the
      // tile between, which every thread reaches only when done reading it
      const int buf = (t - t0) & 1;
      const int j = t * kColTile + tid;
      const bool keep = j < n && mask[j] != 0;
      const uint32_t ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        staged[buf][warp * 32 + __popc(ballot & ((1u << lane) - 1u))] =
            make_float4(coord(pts, j, d, 0), coord(pts, j, d, 1),
                        coord(pts, j, d, 2), __int_as_float(j));
      }
      if (lane == 0) kept[buf][warp] = __popc(ballot);
      // skip a tile with no valid column
      if (!__syncthreads_or(keep)) continue;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4* seg = staged[buf] + w * 32;
        const int m = kept[buf][w];
#pragma unroll 4
        for (int q = 0; q < m; ++q) {
          const float4 c = seg[q];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
            const float dx = __fsub_rn(qx[r], c.x);
            const float dy = __fsub_rn(qy[r], c.y);
            const float dz = __fsub_rn(qz[r], c.z);
            const float d2 = __fadd_rn(
                __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                __fmul_rn(dz, dz));
            if (kFill) {
              if (d2 <= r2) *out[r]++ = __float_as_int(c.w);
            } else {
              count[r] += d2 <= r2;
            }
          }
        }
      }
    }
  }
  if (!kFill) {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int64_t i = r0 + r * kThreads + tid;
      if (i < n) slice_counts[i * slices + s] = count[r];
    }
  }
}

// The grid (grid_x row tiles, grid_y slices of tiles_per_slice column
// tiles) must cover every row and every column.
bool covers(int d, int n, int tiles_per_slice, int grid_x, int grid_y) {
  const int64_t rows = static_cast<int64_t>(grid_x) * kRowTile;
  const int64_t columns =
      static_cast<int64_t>(grid_y) * tiles_per_slice * kColTile;
  return d >= 1 && d <= 3 && n > 0 && tiles_per_slice >= 1 && grid_x >= 1 &&
         grid_y >= 1 && grid_y <= 65535 && rows >= n && columns >= n;
}

}  // namespace

// The launch plan comes from ops/cuda/eps.py::eps_plan, which mirrors this
// file's tile sizes; a plan that does not cover the points, or a D outside
// 1..3, gives cudaErrorInvalidValue. The count pass writes every (row,
// slice)'s count; the fill pass takes those counts and their inclusive
// prefix in the same order (ends) and writes the columns.
extern "C" int eps_count_launch(const void* pts, const void* mask, int d,
                                float r2, int n, int tiles_per_slice,
                                int grid_x, int grid_y, void* slice_counts,
                                void* stream) {
  if (!covers(d, n, tiles_per_slice, grid_x, grid_y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  eps_kernel<false><<<dim3(grid_x, grid_y), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask), d,
      r2, n, tiles_per_slice, grid_y, static_cast<int32_t*>(slice_counts),
      nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int eps_fill_launch(const void* pts, const void* mask, int d,
                               float r2, int n, int tiles_per_slice,
                               int grid_x, int grid_y,
                               const void* slice_counts, const void* ends,
                               void* cols, void* stream) {
  if (!covers(d, n, tiles_per_slice, grid_x, grid_y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  eps_kernel<true><<<dim3(grid_x, grid_y), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask), d,
      r2, n, tiles_per_slice, grid_y,
      const_cast<int32_t*>(static_cast<const int32_t*>(slice_counts)),
      static_cast<const int64_t*>(ends), static_cast<int32_t*>(cols));
  return static_cast<int>(cudaGetLastError());
}
