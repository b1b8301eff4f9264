// The eps-neighbourhood kernels of the venue-scale clustering on the column
// table (column_table.cu): the core counts, the border minimum and the label
// propagation, one templated kernel in three modes, and two small kernels of
// the propagation.
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
// run in no order, so the propagation here is a union-find over the
// core-core eps edges, in three launches and no host read:
//   1. init: parent[k] = k (a separate (N,) buffer: labels, which say which
//      points are core and carry each core point's key, its point index,
//      are only read until the last launch);
//   2. hook: each core point k scans its 3x3 columns like the count does
//      and unites itself with every core eps-neighbour q earlier in the
//      stream (q < k: each edge once). A union finds both roots (with path
//      halving) and hooks the root of the larger key under the other with
//      atomicCAS, retrying from what the CAS found when another thread
//      moved the root first. A parent's key is never larger than its
//      child's, so path-halving writes, which only shorten a path to an
//      ancestor, are benign, and the root of every component is its core
//      point of the smallest point index;
//   3. compress: labels[k] = labels[root of k] for core points that are not
//      roots (roots keep their own label; non-core points stay INT_MAX).
// The atomics make the trees' shapes vary from run to run; the labels (each
// component's smallest point index) do not, and there is no sweep count:
// one pass reaches the fixpoint.
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
// float operations per pair test. The hook adds a chain of parent reads
// and a CAS per edge to an earlier core point. The least time for the same work, the
// bytes the run needs (each occupied slot and each column's end marker read
// once, the (N,) arrays read or written once) over 3.35 TB/s against the
// pair tests over the FP32 rate, is computed from each run's table by
// chip_smoke.py and written in PERF.md beside the measured time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kIntMax = 2147483647;

enum Mode { kCount = 0, kMin = 1, kHook = 2 };

// the root of x's tree, halving the path on the way. Parents are read
// through L2 (ld.global.cg): other blocks write them, and L1 is not
// coherent across SMs.
__device__ __forceinline__ int32_t find_root(int32_t* parent, int32_t x) {
  int32_t p = __ldcg(parent + x);
  while (p != x) {
    const int32_t gp = __ldcg(parent + p);
    if (gp != p) parent[x] = gp;  // benign: gp is an ancestor of x too
    x = p;
    p = gp;
  }
  return x;
}

// unite the trees of core points a and b: the root of the larger key goes
// under the other root
__device__ __forceinline__ void unite(int32_t* parent,
                                      const int32_t* __restrict__ key,
                                      int32_t a, int32_t b) {
  int32_t ra = find_root(parent, a);
  int32_t rb = find_root(parent, b);
  while (ra != rb) {
    if (key[ra] < key[rb]) {
      const int32_t t = ra;
      ra = rb;
      rb = t;
    }
    // ra has the larger key: hook it under rb, if it is still a root
    const int32_t seen = atomicCAS(parent + ra, ra, rb);
    if (seen == ra) return;
    ra = find_root(parent, seen);
    rb = find_root(parent, rb);
  }
}

// labels is read-only in every mode; out is the count, the minimum, or, in
// kHook, the parent buffer.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
neighbour_kernel(const float4* __restrict__ table,         // (S,)
                 const int32_t* __restrict__ stream_slot,  // (N,)
                 int32_t n, int32_t py, int32_t cap, float r2,
                 const int32_t* __restrict__ labels,       // (N,) kMin, kHook
                 int32_t* out) {                           // (N,)
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int32_t pos = k < n ? stream_slot[k] : -1;
  int32_t acc = MODE == kCount ? 0 : kIntMax;
  if (pos >= 0 && (MODE != kHook || labels[k] != kIntMax)) {
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
            } else if (MODE == kMin) {
              acc = min(acc, labels[kq]);
            } else if (kq < k && labels[kq] != kIntMax) {
              unite(out, labels, k, kq);
            }
          }
        }
      }
    }
  }
  if (MODE != kHook && k < n) out[k] = acc;
}

__global__ void __launch_bounds__(kThreads)
init_parent_kernel(int32_t n, int32_t* __restrict__ parent) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k < n) parent[k] = k;
}

// after the hook no parent changes, so plain loads walk the trees
__global__ void __launch_bounds__(kThreads)
compress_kernel(int32_t n, const int32_t* __restrict__ parent,
                int32_t* labels) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n || labels[k] == kIntMax) return;
  int32_t r = k;
  while (parent[r] != r) r = parent[r];
  if (r != k) labels[k] = labels[r];  // a root's label is never written
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <int MODE>
int launch(const void* table, const void* stream_slot, int n, int py,
           int cap, float r2, const void* labels, void* out, void* stream) {
  if (n > 0) {
    neighbour_kernel<MODE><<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table),
        static_cast<const int32_t*>(stream_slot), n, py, cap, r2,
        static_cast<const int32_t*>(labels), static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int column_counts_launch(const void* table, const void* stream_slot,
                                    int n, int py, int cap, float r2,
                                    void* out, void* stream) {
  return launch<kCount>(table, stream_slot, n, py, cap, r2, nullptr, out,
                        stream);
}

extern "C" int border_min_launch(const void* table, const void* stream_slot,
                                 int n, int py, int cap, float r2,
                                 const void* labels, void* out, void* stream) {
  return launch<kMin>(table, stream_slot, n, py, cap, r2, labels, out,
                      stream);
}

// three launches on the stream, none when n is 0: init, hook, compress;
// labels in place, parent (N,) int32 scratch
extern "C" int propagate_launch(const void* table, const void* stream_slot,
                                int n, int py, int cap, float r2,
                                void* labels, void* parent, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* par = static_cast<int32_t*>(parent);
  init_parent_kernel<<<blocks_for(n), kThreads, 0, s>>>(n, par);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hooked = launch<kHook>(table, stream_slot, n, py, cap, r2, labels,
                                   parent, stream);
  if (hooked != 0) return hooked;
  compress_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      n, par, static_cast<int32_t*>(labels));
  return static_cast<int>(cudaGetLastError());
}
