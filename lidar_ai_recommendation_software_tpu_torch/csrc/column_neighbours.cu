// The eps-neighbourhood kernels of the venue-scale clustering on the column
// table (column_table.cu): the core counts and the border minimum (one
// scan in two modes), and the three kernels of the label propagation.
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
//
// Numerics, as the JAX package rounds them (ccl.py:295-299): per axis
// dx = neighbour - centre, d2 = (dx*dx + dy*dy) + dz*dz, each product and
// sum rounded on its own (__fmul_rn, __fadd_rn, so nvcc contracts no fused
// multiply-add), and the test is d2 <= r2 with r2 = float32(eps) squared in
// float32, which the caller passes. Counts and minima are integers, so the
// order in which a point meets its neighbours changes nothing.
//
// The scan (counts and border minimum). A block takes a tile: kTileCols
// consecutive columns (x, y0 .. y1) of one x row (tiles never cross a row;
// the row's last tile is shorter). Every eps-neighbour of its points lies
// in three contiguous column ranges, (x + dx, y0 - 1 .. y1 + 1) for dx in
// -1, 0, 1, and a column's occupancy is min(cell_start[c + 1] -
// cell_start[c], cap): so the block
//   1. reads cell_start over the three ranges (coalesced) and takes, over
//      the staged columns, prefix sums of each column's occupied slots in
//      the three rows together and in its own row;
//   2. stages the occupied slots of as many columns as fit its window of
//      `window` slots (a sub-tile: centre columns a .. b, whose end one
//      __syncthreads_count finds; staged columns a - 1 .. b + 1) in shared
//      memory with cp.async, 16 bytes a slot, a thread a column, column by
//      column and in a column row by row, so that the 3x3 neighbourhood of
//      any column j is ONE contiguous run of the window, [pre[j - 1],
//      pre[j + 2]); an empty column costs no read of the table. The
//      staging thread of a centre's column notes the column beside the
//      centre's index, so no thread searches for its work;
//   3. gives each thread centres, the staged slots of its own row, and
//      tests each against its run in shared memory; the border minimum
//      reads a hit's label at the stream position the slot's last lane
//      holds (a tile's neighbours' labels are three runs of the stream,
//      which L1 keeps); the centre's value is written at its stream
//      position;
//   4. repeats 2-3 until the tile's columns are done. A sub-tile of one
//      column stages at most 9 * cap slots, and the plan's window is at
//      least that, so any occupancy up to cap fits.
// Unplaced stream positions cost one store: the positions past a column's
// cap (in the tile's own row) and the masked points at the end of the
// stream (from cell_start[ncells], over the whole grid) take the "none"
// value, 0 or INT_MAX. So every output element is written once and there
// is no read back to the host. The launch plan (blocks, window, shared
// memory) comes from the shapes alone: the entry points derive it from the
// grid and the cap, and ops/cuda/columns.py::neighbour_plan mirrors it
// with the constants below (the block count, and a ValueError for a cap
// whose window cannot fit a block's shared memory).
//
// What the function needs with these inputs: each occupied slot read once
// (a column's occupancy comes from cell_start, so no end marker and no
// stream_slot), cell_start once, the output written once and, for the
// border minimum, the placed points' labels. chip_smoke.py computes that
// bound from each run's table and PERF.md holds it beside the measured
// time, with the times of the scan's stages (tools/scan_stages.py): at the
// 1M-point scan the staging loop and the pair tests take most of it, in
// each block a chain of dependent trips to memory (cell_start, then the
// staged slots) and the barriers between them; and the table's layout
// keeps most occupied slots alone in their column's 256 bytes, so each is a
// separate DRAM access.
//
// The propagation runs on the table itself: a slot's last lane holds its
// stream position. The TPU kernels walk the table row by row, and the
// propagation is Gauss-Seidel because a Pallas grid runs in order on one
// core. CUDA blocks run in no order, so the propagation here is a
// union-find over the core-core eps edges, in three launches and no host
// read:
//   1. init: parent[k] = k (a separate (N,) buffer: labels, which say which
//      points are core and carry each core point's key, its point index,
//      are only read until the last launch);
//   2. hook: one thread per stream position; each core point k scans its
//      3x3 columns (a column's occupied slots are a prefix, so a column's
//      scan stops at its first empty slot) and unites itself with every
//      core eps-neighbour q earlier in the stream (q < k: each edge once).
//      A union finds both roots (with path halving) and hooks the root of
//      the larger key under the other with atomicCAS, retrying from what
//      the CAS found when another thread moved the root first. A parent's
//      key is never larger than its child's, so path-halving writes, which
//      only shorten a path to an ancestor, are benign, and the root of
//      every component is its core point of the smallest point index;
//   3. compress: labels[k] = labels[root of k] for core points that are not
//      roots (roots keep their own label; non-core points stay INT_MAX).
// The atomics make the trees' shapes vary from run to run; the labels (each
// component's smallest point index) do not, and there is no sweep count:
// one pass reaches the fixpoint. What bounds it: the hook's dependent,
// data-dependent loads (a column's length is known only by reading it) and
// a chain of parent reads and a CAS per edge to an earlier core point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kIntMax = 2147483647;

// The scan's layout, which ops/cuda/columns.py::neighbour_plan mirrors:
// centre columns a tile takes along y; the least slots a window holds (the
// plan gives max(kWindow, 9 * cap)); per block, the int32 words beside the
// window (cell_start of the three rows, the two prefix sums, each over the
// tile's staged columns and the end of the last, the scan's warp totals,
// the masked tail's start); the most shared memory a block of sm_90 may
// use.
constexpr int kTileCols = 256;
constexpr int kWindow = 1024;
constexpr int kColumnWords = kTileCols + 3;
constexpr int kBlockWords = 5 * kColumnWords + 2 * kWarps + 1;
// shared-memory bytes per window slot: the slot's 16 and a centre's column
constexpr int kSlotBytes = 18;
// staged columns a thread takes in the prefix sums
constexpr int kColsPerThread = (kTileCols + 2 + kThreads - 1) / kThreads;
static_assert(kTileCols % kThreads == 0,
              "every thread meets the sub-tile's barrier counts alike");
constexpr int kSmemPerBlock = 232448;

enum Mode { kCount = 0, kMin = 1 };

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

// a 16-byte copy from device to shared memory that holds no register
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

// wait for every copy this thread issued
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// exclusive prefix sums over the block of two quantities, one pair a
// thread; tot: 2 * kWarps words of shared memory
__device__ __forceinline__ int2 block_exclusive_scan(int2 v, int32_t* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, inc.x, d);
    const int y = __shfl_up_sync(0xffffffffu, inc.y, d);
    if (lane >= d) {
      inc.x += x;
      inc.y += y;
    }
  }
  if (lane == 31) {
    tot[warp] = inc.x;
    tot[kWarps + warp] = inc.y;
  }
  __syncthreads();
  if (warp == 0) {
    int2 t = lane < kWarps ? make_int2(tot[lane], tot[kWarps + lane])
                           : make_int2(0, 0);
    for (int d = 1; d < kWarps; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, t.x, d);
      const int y = __shfl_up_sync(0xffffffffu, t.y, d);
      if (lane >= d) {
        t.x += x;
        t.y += y;
      }
    }
    if (lane < kWarps) {
      tot[lane] = t.x;
      tot[kWarps + lane] = t.y;
    }
  }
  __syncthreads();
  const int2 before = warp ? make_int2(tot[warp - 1], tot[kWarps + warp - 1])
                           : make_int2(0, 0);
  return make_int2(before.x + inc.x - v.x, before.y + inc.y - v.y);
}

// Counts (kCount) or border minima (kMin) of one tile per block; see the
// note at the top. Dynamic shared memory: the window's slots (window
// float4), kBlockWords int32, and each staged centre's column (window
// uint16).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float4* __restrict__ table,        // (S,)
            const int32_t* __restrict__ cell_start,  // (ncells + 1,)
            int32_t n, int32_t py, int32_t cap, float r2,
            int32_t tiles_per_row, int32_t window,
            const int32_t* __restrict__ labels,      // (N,) kMin
            int32_t* __restrict__ out) {             // (N,)
  extern __shared__ float4 win[];
  int32_t* cs = reinterpret_cast<int32_t*>(win + window);  // [3][words]
  int32_t* pre = cs + 3 * kColumnWords;  // slots of columns < j, 3 rows
  int32_t* cen = pre + kColumnWords;     // slots of columns < j, own row
  int32_t* tot = cen + kColumnWords;
  int32_t* masked = tot + 2 * kWarps;  // the masked tail's first position
  uint16_t* centre_col = reinterpret_cast<uint16_t*>(masked + 1);
  const int32_t none = MODE == kCount ? 0 : kIntMax;
  const int tid = threadIdx.x;

  // the tile: padded x row `row + 1`, padded y y0 .. y0 + len - 1; its
  // staged columns j = 0 .. len + 1 are y0 - 1 + j in rows row .. row + 2
  const int row = blockIdx.x / tiles_per_row;
  const int y0 = 1 + (blockIdx.x - row * tiles_per_row) * kTileCols;
  const int len = min(kTileCols, py - 1 - y0);
  const int ncol = len + 2;
  if (tid == 0) *masked = cell_start[(gridDim.x / tiles_per_row + 2) * py];
  for (int r = 0; r < 3; ++r) {
    for (int j = tid; j <= ncol; j += kThreads) {
      cs[r * kColumnWords + j] = cell_start[(row + r) * py + y0 - 1 + j];
    }
  }
  __syncthreads();
  auto occ = [&](int r, int j) {
    const int32_t* c = cs + r * kColumnWords + j;
    return min(c[1] - c[0], cap);
  };

  // pre[j], cen[j]: the occupied slots of the staged columns before j, in
  // the three rows and in the tile's own row (thread t: kColsPerThread
  // columns from kColsPerThread * t)
  const int j0 = kColsPerThread * tid;
  int2 v[kColsPerThread];
  int2 sum = make_int2(0, 0);
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) {
    const int j = j0 + i;
    v[i] = j < ncol ? make_int2(occ(0, j) + occ(1, j) + occ(2, j), occ(1, j))
                    : make_int2(0, 0);
    sum.x += v[i].x;
    sum.y += v[i].y;
  }
  int2 prefix = block_exclusive_scan(sum, tot);
  if (tid == 0) pre[0] = cen[0] = 0;
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) {
    prefix.x += v[i].x;
    prefix.y += v[i].y;
    if (j0 + i < ncol) {
      pre[j0 + i + 1] = prefix.x;
      cen[j0 + i + 1] = prefix.y;
    }
  }

  // unplaced positions: past the cap in the tile's own columns, a thread a
  // column; the masked tail of the stream, over the whole grid
  for (int j = 1 + tid; j <= len; j += kThreads) {
    const int32_t* c = cs + kColumnWords + j;
    for (int32_t k = c[0] + cap; k < c[1]; ++k) out[k] = none;
  }
  for (int64_t k = *masked + static_cast<int64_t>(blockIdx.x) * kThreads + tid;
       k < n; k += static_cast<int64_t>(gridDim.x) * kThreads) {
    out[k] = none;
  }
  __syncthreads();

  for (int a = 1; a <= len;) {
    // the sub-tile: centre columns a .. b, the most that fit the window
    // (one always does: its 9 columns hold at most 9 * cap <= window). The
    // counts' barriers also keep the last sub-tile's reads of the window
    // before this one's copies.
    const int base = pre[a - 1];
    int b = a - 1;
    for (int jt = a + tid; jt < a + kTileCols; jt += kThreads) {
      b += __syncthreads_count(jt <= len && pre[jt + 2] - base <= window);
    }
    // stage columns a - 1 .. b + 1, a thread a column, row by row; note
    // the column of each centre (row 1 of columns a .. b)
    const int first = cen[a];
    for (int j = a - 1 + tid; j <= b + 1; j += kThreads) {
      int dst = pre[j] - base;
      for (int r = 0; r < 3; ++r) {
        const int o = occ(r, j);
        const float4* src =
            table + (static_cast<int64_t>(row + r) * py + y0 - 1 + j) * cap;
        const bool own_row = r == 1 && j >= a && j <= b;
        for (int u = 0; u < o; ++u) {
          copy_async16(win + dst + u, src + u);
          if (own_row) centre_col[cen[j] - first + u] = j;
        }
        dst += o;
      }
    }
    wait_copies();
    __syncthreads();

    const int centres = cen[b + 1] - first;
    for (int i = tid; i < centres; i += kThreads) {
      // centre i: rank u in the tile's row of column j
      const int j = centre_col[i];
      const int u = i + first - cen[j];
      const float4 c = win[pre[j] - base + occ(0, j) + u];
      const int end = pre[j + 2] - base;
      int32_t acc = none;
#pragma unroll 4
      for (int q = pre[j - 1] - base; q < end; ++q) {
        const float4 o = win[q];
        const float ex = __fsub_rn(o.x, c.x);
        const float ey = __fsub_rn(o.y, c.y);
        const float ez = __fsub_rn(o.z, c.z);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
            __fmul_rn(ez, ez));
        if (d2 <= r2) {
          // a neighbour's label: its stream position is the slot's last
          // lane, and a tile's neighbours' labels are three runs of the
          // stream, which L1 holds
          if (MODE == kCount) {
            ++acc;
          } else {
            acc = min(acc, __ldg(labels + __float_as_int(o.w)));
          }
        }
      }
      out[cs[kColumnWords + j] + u] = acc;
    }
    a = b + 1;
  }
}

// the propagation's hook: one thread per stream position, a core point
// scanning its 3x3 columns in the table
__global__ void __launch_bounds__(kThreads)
hook_kernel(const float4* __restrict__ table,         // (S,)
            const int32_t* __restrict__ stream_slot,  // (N,)
            int32_t n, int32_t py, int32_t cap, float r2,
            const int32_t* __restrict__ labels,       // (N,)
            int32_t* parent) {                        // (N,)
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int32_t pos = k < n ? stream_slot[k] : -1;
  if (pos >= 0 && labels[k] != kIntMax) {
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
          if (d2 <= r2 && kq < k && labels[kq] != kIntMax) {
            unite(parent, labels, k, kq);
          }
        }
      }
    }
  }
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
int launch_scan(const void* table, const void* cell_start, int n, int ncx,
                int py, int cap, float r2, const void* labels, void* out,
                void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (ncx < 1 || py < 3 || cap < 1 || cap > kSmemPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the plan: tiles of kTileCols columns along each x row, and a window
  // that holds the 9 columns around one column at any occupancy up to cap
  const int tiles_per_row = (py - 2 + kTileCols - 1) / kTileCols;
  const int window = max(kWindow, 9 * cap);
  const size_t smem =
      static_cast<size_t>(window) * kSlotBytes + 4 * kBlockWords;
  if (smem > kSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<MODE><<<ncx * tiles_per_row, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table),
      static_cast<const int32_t*>(cell_start), n, py, cap, r2, tiles_per_row,
      window, static_cast<const int32_t*>(labels),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the core counts: (N,) int32, 0 where a stream position has no slot
extern "C" int column_counts_launch(const void* table, const void* cell_start,
                                    int n, int ncx, int py, int cap, float r2,
                                    const void* labels, void* out,
                                    void* stream) {
  return launch_scan<kCount>(table, cell_start, n, ncx, py, cap, r2, labels,
                             out, stream);
}

// the border minimum of labels (N,): (N,) int32, INT_MAX where a stream
// position has no slot
extern "C" int border_min_launch(const void* table, const void* cell_start,
                                 int n, int ncx, int py, int cap, float r2,
                                 const void* labels, void* out,
                                 void* stream) {
  return launch_scan<kMin>(table, cell_start, n, ncx, py, cap, r2, labels,
                           out, stream);
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
  hook_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const float4*>(table),
      static_cast<const int32_t*>(stream_slot), n, py, cap, r2,
      static_cast<const int32_t*>(labels), par);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compress_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      n, par, static_cast<int32_t*>(labels));
  return static_cast<int>(cudaGetLastError());
}
