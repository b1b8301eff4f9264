// The column table of the venue-scale clustering: the fill (cell-sorted
// point stream -> table) and the gather (stream-order values -> point
// order).
//
// Replaces two TPU kernels of lidar_ai_recommendation_software_tpu:
//   - ops/pallas/fill.py::fill_planes (_fill_kernel), which builds the
//     (PX, 5*CAP, PYP) accumulator planes of ops/ccl.py::build_planes_stream
//     with one-hot dispatch matmuls on the MXU, because the TPU has no fast
//     scatter;
//   - ops/pallas/fill.py::extract_stream (_extract_kernel), which reads the
//     labels back into stream order with the transposed matmul and byte
//     planes.
// A GPU gathers directly, so both become one thread per output element.
// None of the TPU layout is carried over: no 128-lane padding, no tile
// schedule, no bf16 splits.
//
// Layout: the table is (ncx + 2) x (ncy + 2) columns, one empty border
// column on each side, each column `cap` slots in a row, each slot a
// float4 (x, y, z, stream position as int bits). Empty slots hold
// EMPTY_COORD (1e18) in x, y, z and -1 in the last lane. A column's occupied
// slots are a prefix: the stream is sorted by cell id (stably, by the
// caller), and cell_start[c] is the stream position of cell c's first
// point, so column c holds stream positions cell_start[c] + r for the ranks
// r < min(cap, cell_start[c + 1] - cell_start[c]).
//
// table_fill: one launch, two kinds of block. The slot blocks write every
// slot of the table once, each thread one slot: the point at its column's
// rank, or the empty value; so the kernel, not a fill before it, writes
// the empty slots. The stream blocks write the maps, each thread one
// stream position k: stream_slot[k] (its slot, or -1) and
// point_stream[order[k]] (k, or -1), -1 for masked points (cell id ncells)
// and for valid points at rank >= cap, which are counted in `overflow`,
// once per block (__syncthreads_count, then one integer atomicAdd).
//
// table_gather: out[i] = values[point_stream[i]], or `fill` where the
// point has no slot (masked or dropped by the cap). The clustering's
// per-point values live in stream order, so this is the read back to
// point order, and the unsort sort that extract_stream needed is gone.
//
// What bounds them on the H100: device memory. The fill writes the whole
// table, 16 bytes a slot (269 MB at the 1M-point scan's 1,026 x 1,026
// columns of 16), and reads a few bytes per point; the gather moves 12
// bytes per point. Both write in order (coalesced float4 and int stores);
// their scattered reads (a point's coordinates, a stream-order value) are
// one per point. chip_smoke.py computes each bound from the run's sizes;
// PERF.md has it beside the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEmptyCoord = 1.0e18f;

__global__ void __launch_bounds__(kThreads)
table_fill_kernel(const float* __restrict__ points,       // (N, 3)
                  const int32_t* __restrict__ order,      // (N,) stream->pt
                  const int32_t* __restrict__ scid,       // (N,) sorted ids
                  const int32_t* __restrict__ cell_start, // (ncells + 1,)
                  int32_t n, int32_t ncells, int32_t cap,
                  int32_t slot_blocks,
                  float4* __restrict__ table,             // (ncells * cap)
                  int32_t* __restrict__ point_stream,     // (N,)
                  int32_t* __restrict__ stream_slot,      // (N,)
                  int32_t* __restrict__ overflow) {       // ()
  if (static_cast<int32_t>(blockIdx.x) < slot_blocks) {
    // a whole block takes this branch, so the barrier below is not split
    const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
    if (s < static_cast<int64_t>(ncells) * cap) {
      const int32_t c = static_cast<int32_t>(s / cap);
      const int32_t r = static_cast<int32_t>(s - static_cast<int64_t>(c) * cap);
      const int32_t first = cell_start[c];
      float4 v = make_float4(kEmptyCoord, kEmptyCoord, kEmptyCoord,
                             __int_as_float(-1));
      if (r < cell_start[c + 1] - first) {
        const int32_t k = first + r;
        const int32_t i = order[k];
        v = make_float4(points[3 * i], points[3 * i + 1], points[3 * i + 2],
                        __int_as_float(k));
      }
      table[s] = v;
    }
    return;
  }
  const int32_t k = (static_cast<int32_t>(blockIdx.x) - slot_blocks) *
                    kThreads + threadIdx.x;
  bool dropped = false;
  if (k < n) {
    const int32_t c = scid[k];
    const bool valid = c < ncells;
    const bool placed = valid && k - cell_start[min(c, ncells)] < cap;
    dropped = valid && !placed;
    stream_slot[k] = placed ? c * cap + (k - cell_start[c]) : -1;
    point_stream[order[k]] = placed ? k : -1;
  }
  const int n_dropped = __syncthreads_count(dropped);
  if (threadIdx.x == 0 && n_dropped > 0) atomicAdd(overflow, n_dropped);
}

__global__ void __launch_bounds__(kThreads)
table_gather_kernel(const int32_t* __restrict__ values,        // (N,)
                    const int32_t* __restrict__ point_stream,  // (N,)
                    int32_t n, int32_t fill,
                    int32_t* __restrict__ out) {               // (N,)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    const int32_t k = point_stream[i];
    out[i] = k >= 0 ? values[k] : fill;
  }
}

}  // namespace

extern "C" int table_fill_launch(const void* points, const void* order,
                                 const void* scid, const void* cell_start,
                                 int n, int ncells, int cap, void* table,
                                 void* point_stream, void* stream_slot,
                                 void* overflow, void* stream) {
  const int64_t slots = static_cast<int64_t>(ncells) * cap;
  const int32_t slot_blocks =
      static_cast<int32_t>((slots + kThreads - 1) / kThreads);
  const int32_t blocks = slot_blocks + (n + kThreads - 1) / kThreads;
  if (blocks > 0) {
    table_fill_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points),
        static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(scid),
        static_cast<const int32_t*>(cell_start), n, ncells, cap, slot_blocks,
        static_cast<float4*>(table), static_cast<int32_t*>(point_stream),
        static_cast<int32_t*>(stream_slot),
        static_cast<int32_t*>(overflow));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int table_gather_launch(const void* values,
                                   const void* point_stream, int n, int fill,
                                   void* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    table_gather_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(values),
        static_cast<const int32_t*>(point_stream), n, fill,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
