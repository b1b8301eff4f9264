// The eps-neighbourhood kernels of the venue-scale clustering on the column
// table (column_table.cu): the core counts, the border minimum and the label
// propagation, one templated kernel in three modes.
//
// Replaces three TPU kernels of lidar_ai_recommendation_software_tpu/ops/
// ccl.py, which share one inner loop (_neighbor_min_and_count):
//   - column_counts_planes (_counts_kernel): per slot, the number of points
//     within eps over the 3x3 neighbouring columns, self included;
//   - border_min_planes (_border_kernel): per slot, the smallest label among
//     its eps-neighbours (labels are INT_MAX at non-core points, so border
//     points adopt the smallest adjacent core label);
//   - gs_passes (_gs_kernel_blocked, _gs_kernel): min-label propagation over
//     the core-core eps adjacency to the connected-component fixpoint.
// The TPU kernels keep their values per slot of the table. Here they are
// per stream position k (the cell-sorted order the table is filled from,
// entry k belongs to the point order[k]): an (N,) array, not one of the
// table's size, which at the 1M-point scan is 16.8M slots for 700,000
// placed points.
// A slot's last lane holds its stream position, so a neighbour's value is
// one load away.
//
// The TPU kernels walk the table row by row, and the propagation is
// Gauss-Seidel because a Pallas grid runs in order on one core. CUDA blocks
// run in no order, so the propagation here is a sweep of in-place updates:
// each core point takes the minimum of its own label and its core
// eps-neighbours' labels, then jumps twice through the point -> stream
// position map (label L -> the label of point L). Every label is at all
// times the index of a core point of the same component and never grows,
// and a label is written only by its own thread, so the sweeps reach the
// one fixpoint (each core point carries the smallest point index of its
// component) whatever order the blocks run in. Each sweep counts the labels
// it changed (__syncthreads_count, then one integer atomicAdd per block);
// the caller sweeps until a sweep changes nothing, which no concurrent
// write can fake: a sweep that writes nothing read a state no thread was
// changing.
//
// Numerics, as the JAX package rounds them (ccl.py:295-299): per axis
// dx = neighbour - centre, d2 = (dx*dx + dy*dy) + dz*dz, each product and
// sum rounded on its own (__fmul_rn, __fadd_rn, so nvcc contracts no fused
// multiply-add), and the test is d2 <= r2 with r2 = float32(eps) squared in
// float32, which the caller passes.
//
// Work: one thread per stream position; those with a slot scan the 3x3
// columns around it, the others write their "none" value (0 or INT_MAX),
// so every output element is written by the kernel, once. Neighbouring
// threads of a warp sit in the same or adjacent columns, so most neighbour
// reads hit L1. A column's occupied slots are a prefix, so the scan of a
// neighbouring column stops at its first empty slot: at the 1M-point scan
// (1,024 x 1,024 columns of up to 16 slots, most of them holding one point
// or none) a thread reads a few slots per column, not 9 x 16. No TPU layout
// is carried over (lanes, row blocks, DMA windows, transposed orientation).
//
// What bounds them on the H100: the latency of dependent, data-dependent
// loads (a column's length is known only by reading it), not bandwidth or
// arithmetic: per point a few dozen 16-byte reads, mostly cached, and 9
// float operations per pair test. The least time for the same work, the
// bytes the run needs (each occupied slot and each column's end marker read
// once, the (N,) arrays read or written once) over 3.35 TB/s against the
// pair tests over the FP32 rate, is computed from each run's table by
// chip_smoke.py and written in PERF.md beside the measured time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kIntMax = 2147483647;

enum Mode { kCount = 0, kMin = 1, kPropagate = 2 };

// labels and out alias in kPropagate (the sweep updates in place), so
// neither is __restrict__.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
neighbour_kernel(const float4* __restrict__ table,         // (S,)
                 const int32_t* __restrict__ stream_slot,  // (N,)
                 const int32_t* __restrict__ point_stream, // (N,) kPropagate
                 int32_t n, int32_t py, int32_t cap, float r2,
                 const int32_t* labels,                    // (N,) kMin, kProp
                 int32_t* out,                             // (N,)
                 int32_t* __restrict__ changed) {          // () kPropagate
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int32_t pos = k < n ? stream_slot[k] : -1;
  bool did_change = false;
  const int32_t own = (MODE == kPropagate && pos >= 0) ? labels[k] : kIntMax;
  int32_t acc = MODE == kCount ? 0 : kIntMax;
  if (pos >= 0 && (MODE != kPropagate || own != kIntMax)) {
    const float4 c = table[pos];
    const int32_t col = pos / cap;
    for (int dx = -1; dx <= 1; ++dx) {
      for (int dy = -1; dy <= 1; ++dy) {
        const int32_t base = (col + dx * py + dy) * cap;
        for (int j = 0; j < cap; ++j) {
          const float4 q = table[base + j];
          const int32_t kq = __float_as_int(q.w);
          if (kq < 0) break;  // occupied slots: a prefix
          const float ex = __fsub_rn(q.x, c.x);
          const float ey = __fsub_rn(q.y, c.y);
          const float ez = __fsub_rn(q.z, c.z);
          const float d2 = __fadd_rn(
              __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
              __fmul_rn(ez, ez));
          if (d2 <= r2) {
            if (MODE == kCount) {
              ++acc;
            } else {
              acc = min(acc, labels[kq]);
            }
          }
        }
      }
    }
    if (MODE == kPropagate) {
      // acc <= own (self is its own neighbour) and is a core point's index
      for (int hop = 0; hop < 2; ++hop) {
        const int32_t s = point_stream[acc];
        if (s < 0) break;
        acc = min(acc, labels[s]);
      }
      if (acc < own) {
        out[k] = acc;
        did_change = true;
      }
    }
  }
  if (MODE != kPropagate && k < n) out[k] = acc;
  if (MODE == kPropagate) {
    const int n_changed = __syncthreads_count(did_change);
    if (threadIdx.x == 0 && n_changed > 0) atomicAdd(changed, n_changed);
  }
}

template <int MODE>
int launch(const void* table, const void* stream_slot,
           const void* point_stream, int n, int py, int cap, float r2,
           const void* labels, void* out, void* changed, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    neighbour_kernel<MODE><<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table),
        static_cast<const int32_t*>(stream_slot),
        static_cast<const int32_t*>(point_stream), n, py, cap, r2,
        static_cast<const int32_t*>(labels), static_cast<int32_t*>(out),
        static_cast<int32_t*>(changed));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int column_counts_launch(const void* table, const void* stream_slot,
                                    int n, int py, int cap, float r2,
                                    void* out, void* stream) {
  return launch<kCount>(table, stream_slot, nullptr, n, py, cap, r2, nullptr,
                        out, nullptr, stream);
}

extern "C" int border_min_launch(const void* table, const void* stream_slot,
                                 int n, int py, int cap, float r2,
                                 const void* labels, void* out, void* stream) {
  return launch<kMin>(table, stream_slot, nullptr, n, py, cap, r2, labels,
                      out, nullptr, stream);
}

extern "C" int propagate_launch(const void* table, const void* stream_slot,
                                const void* point_stream, int n, int py,
                                int cap, float r2, void* labels,
                                void* changed, void* stream) {
  return launch<kPropagate>(table, stream_slot, point_stream, n, py, cap, r2,
                            labels, labels, changed, stream);
}
