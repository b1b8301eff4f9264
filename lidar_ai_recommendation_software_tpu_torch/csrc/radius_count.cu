// radius_count: number of valid people within radius r (inclusive) of each
// density-cell centre.
//
// Replaces the TPU kernel lidar_ai_recommendation_software_tpu/ops/pallas/
// kernels.py::radius_count (_radius_count_kernel). It computes the same
// counts, bit for bit: the squared distance is formed as dx*dx + dy*dy from
// the direct differences, with every product and sum rounded on its own
// (__fmul_rn / __fadd_rn), so no fused multiply-add moves a person who sits
// exactly at the radius across it, and the comparison is d2 <= r2. The
// caller passes r2 as the TPU kernel forms it: r * r in double precision,
// rounded once to float.
//
// Design for Hopper. The TPU kernel walks a grid of centre tiles x people
// tiles in order, adds each tile's counts into the revisited output block
// and skips the tiles past the live prefix of the people. Here both axes
// run in parallel:
//   - a 2-D grid: blockIdx.x is a tile of kCentreTile consecutive centres,
//     each thread holding kPerThread of them (and their counts) in
//     registers; blockIdx.y is a slice of tiles_per_slice people tiles of
//     kPeopleTile. The launch plan (ops/cuda/kernels.py::radius_plan) sizes
//     the slices so that the grid holds some thousands of blocks, enough to
//     fill the 132 SMs with live work at the sensor frame's shape;
//   - the block stages each people tile in shared memory as float2 (x, y),
//     one person a thread, and each staged person serves kPerThread pair
//     tests for one broadcast load. It stages only the people that can
//     count: valid, and within the radius of the bounding box of the
//     tile's centres by the pair test's own rounding (in_reach), so the
//     culling changes no count. The density's centres come x-major, so a
//     tile of 512 holds a few columns of cells, and at the venue's shapes
//     most people of a tile are out of its reach. A warp ballot compacts
//     the kept people warp by warp; the pair loop reads no mask;
//   - one barrier a tile, the tiles double-buffered: __syncthreads_or over
//     the kept flags, so a tile with no valid person in reach is skipped
//     whole. Valid people are normally a dense prefix, so this contains the
//     TPU kernel's live-prefix skip, found inside the kernel without a pass
//     over the mask first, and it stays right for any mask;
//   - the slices' counts are combined with integer atomicAdd into the
//     output, which the launch zeroes first with cudaMemsetAsync on the
//     same stream. Integer sums do not depend on their order, so the result
//     is bit-equal and deterministic. A thread adds only a count that is
//     not 0. (The alternative, a cluster along the people axis reducing in
//     distributed shared memory, would tie the slices' number to the
//     cluster size, 8, and leave the same barrier; the atomics cost one
//     add per centre with a neighbour in the slice.)
//
// What bounds it on the H100: the pair tests that survive the culling. Each
// is 5 floating-point operations that cannot fuse (2 differences, 2
// products, a sum) and a compare, 7 instructions with the count; the
// inputs are (C + K) * 8 bytes and the mask, the output C * 4. At the
// sensor frame's shape a launch is a few microseconds of work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;  // centres a thread holds
constexpr int kCentreTile = kThreads * kPerThread;
constexpr int kPeopleTile = kThreads;  // people staged a tile, one a thread

// Whether a person at coordinate p can be within the radius of a centre
// whose coordinate lies in [lo, hi], tested as the pair test rounds: for a
// centre at c >= lo > p, fl(c - p) >= fl(lo - p) > 0 (rounding is
// monotone), so fl(dx * dx) >= fl(fl(lo - p)^2), and d2 = fl(fl(dx * dx) +
// fl(dy * dy)) >= fl(dx * dx) since fl(dy * dy) >= 0; likewise on the
// right. A person this rejects fails the pair test with every centre of the
// tile, so dropping it changes no count. A NaN coordinate is kept (and
// fails the pair test).
__device__ __forceinline__ bool in_reach(float p, float lo, float hi,
                                         float r2) {
  if (p < lo) {
    const float d = __fsub_rn(lo, p);
    return __fmul_rn(d, d) <= r2;
  }
  if (p > hi) {
    const float d = __fsub_rn(hi, p);
    return __fmul_rn(d, d) <= r2;
  }
  return true;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
radius_count_kernel(const float2* __restrict__ centers,  // (C,)
                    const float2* __restrict__ people,   // (K,)
                    const uint8_t* __restrict__ pmask,   // (K,)
                    float r2, int32_t c, int32_t k,
                    int32_t tiles_per_slice,
                    int32_t* __restrict__ out) {         // (C,), zeroed
  // each people tile, compacted warp by warp: warp w's kept people at
  // [32 w, 32 w + kept[w])
  __shared__ float2 staged[2][kPeopleTile];
  __shared__ int kept[2][kWarps];
  __shared__ float box[kWarps][4];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kCentreTile;
  float cx[kPerThread], cy[kPerThread];
  int32_t count[kPerThread];
  // the bounding box of the tile's centres, as (min x, -max x, min y,
  // -max y) so that one minimum serves all four; a NaN centre, which
  // counts no one, is left out by fminf
  const float inf = __int_as_float(0x7f800000);
  float lim[4] = {inf, inf, inf, inf};
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int64_t i = c0 + r * kThreads + tid;
    const float2 q = i < c ? centers[i] : make_float2(0.0f, 0.0f);
    cx[r] = q.x;
    cy[r] = q.y;
    count[r] = 0;
    if (i < c) {
      lim[0] = fminf(lim[0], q.x);
      lim[1] = fminf(lim[1], -q.x);
      lim[2] = fminf(lim[2], q.y);
      lim[3] = fminf(lim[3], -q.y);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lim[e] = warp_min(lim[e]);
    if (lane == 0) box[warp][e] = lim[e];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lim[e] = box[0][e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) lim[e] = fminf(lim[e], box[w][e]);
  }

  const int n_tiles = (k + kPeopleTile - 1) / kPeopleTile;
  const int t0 = blockIdx.y * tiles_per_slice;
  const int t1 = min(t0 + tiles_per_slice, n_tiles);
  for (int t = t0; t < t1; ++t) {
    // a buffer is written again two tiles later, after the barrier of the
    // tile between, which every thread reaches only when done reading it
    const int buf = (t - t0) & 1;
    const int j = t * kPeopleTile + tid;
    float2 p = make_float2(0.0f, 0.0f);
    bool keep = j < k && pmask[j] != 0;
    if (keep) {
      p = people[j];
      keep = in_reach(p.x, lim[0], -lim[1], r2) &&
             in_reach(p.y, lim[2], -lim[3], r2);
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      staged[buf][warp * 32 + __popc(ballot & ((1u << lane) - 1u))] = p;
    }
    if (lane == 0) kept[buf][warp] = __popc(ballot);
    // skip a tile with no valid person in reach of the tile's centres
    if (!__syncthreads_or(keep)) continue;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2* seg = staged[buf] + w * 32;
      const int m = kept[buf][w];
#pragma unroll 4
      for (int q = 0; q < m; ++q) {
        const float2 pq = seg[q];
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) {
          const float dx = __fsub_rn(cx[r], pq.x);
          const float dy = __fsub_rn(cy[r], pq.y);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          count[r] += d2 <= r2;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int64_t i = c0 + r * kThreads + tid;
    if (i < c && count[r] != 0) atomicAdd(out + i, count[r]);
  }
}

}  // namespace

// The launch plan comes from ops/cuda/kernels.py::radius_plan, which
// mirrors this file's tile sizes: the grid (grid_x centre tiles, grid_y
// slices of tiles_per_slice people tiles) must cover every centre and every
// person, otherwise cudaErrorInvalidValue. The output is zeroed on the
// stream first; with no people (grid_y == 0) that is all.
extern "C" int radius_count_launch(const void* centers, const void* people,
                                   const void* pmask, float r2, int c, int k,
                                   int tiles_per_slice, int grid_x,
                                   int grid_y, void* out, void* stream) {
  const int64_t centre_cover = static_cast<int64_t>(grid_x) * kCentreTile;
  const int64_t people_cover =
      static_cast<int64_t>(grid_y) * tiles_per_slice * kPeopleTile;
  if (c < 0 || k < 0 || tiles_per_slice < 1 || grid_x < 0 || grid_y < 0 ||
      grid_y > 65535 || centre_cover < c || people_cover < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, static_cast<size_t>(c) * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid_y > 0) {
    radius_count_kernel<<<dim3(grid_x, grid_y), kThreads, 0, s>>>(
        static_cast<const float2*>(centers),
        static_cast<const float2*>(people),
        static_cast<const uint8_t*>(pmask), r2, c, k, tiles_per_slice,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
