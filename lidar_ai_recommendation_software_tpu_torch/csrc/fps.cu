// fps: farthest-point sampling of B clouds.
//
// Replaces the two TPU kernels of lidar_ai_recommendation_software_tpu/ops/
// pallas/kernels.py: _fps_single (_fps_kernel) is the case B = 1 and
// _fps_batched (_fps_grid_kernel) the general one. It selects the same
// indices, bit for bit:
//   - out[0] is the start index whatever the mask says;
//   - each step updates every point's cached distance to the chosen set with
//     the squared distance to the last chosen point, (dx*dx + dy*dy) + dz*dz,
//     every product and sum rounded on its own (__fmul_rn / __fadd_rn: nvcc
//     would contract them into fused multiply-adds, and one differing ulp
//     changes every later index of the argmax chain);
//   - masked points compete with -3.4e38 and are never chosen while a valid
//     point is left; with fewer valid points than samples the indices
//     repeat;
//   - ties go to the lowest index: the reductions compare (value, index)
//     pairs, an associative and commutative order, so how the points are
//     split between threads and blocks does not change the result.
// The TPU's (rows, 128) coordinate planes and its masked-reduce read of the
// last point are workarounds of that machine; here the point is indexed.
//
// The n_samples steps depend on each other, so a step's latency is the
// whole cost: a pass over the points, an argmax, and at least one barrier
// among the threads that share the cloud. Three bodies, and a launch plan
// (ops/cuda/pointnet.py::fps_plan) that picks one by the cloud's size:
//
//   - fps_register_kernel<T, P>, one block of T threads a cloud, up to
//     T x P points (the instantiations in kRegisterShapes, up to 8,192
//     points: every launch of a CrowdNet forward, served or default width,
//     whose largest cloud is 8,192).
//     Each thread holds P points, x, y, z and the cached distance, in
//     registers, point tid + j * T in slot j, so the first load is
//     coalesced and a thread meets its indices in rising order; a step
//     reads no memory for the scan. A masked point (and a slot past n)
//     caches -3.4e38 from the start: min() keeps it there, so it ranks as
//     the TPU kernel ranks a masked point with no select in the loop. The
//     argmax maps each thread's best value to an order-preserving unsigned
//     key, so a warp's argmax is two redux.sync instructions
//     (__reduce_max_sync on the key, __reduce_min_sync on the index among
//     the lanes that hold the maximum), the same total order as comparing
//     (value, index) pairs. One warp needs no barrier; with W > 1 warps,
//     lane 0 of each warp writes (key, index) to a slot, the slots
//     double-buffered by step parity, one __syncthreads, and every warp
//     reduces the W slots with the same two instructions. The winner's
//     coordinates come from a read-only copy of the cloud in shared memory
//     (12 bytes a point, one broadcast load a step): a register array is
//     never indexed with a runtime value, which would move it to local
//     memory.
//   - fps_kernel, one block of 1,024 threads a cloud. From 8,193 to 13,643
//     points (no workload of the port sends such clouds yet) the cloud, its
//     distance cache and its mask live in shared memory (17
//     bytes a point, all of the 227 KB a block may use but the warp
//     results): a pass over the points, a warp-shuffle argmax, one
//     __syncthreads, and a second shuffle argmax over the 32 warp results
//     that every warp repeats. Above a cluster's capacity (108,992 points)
//     the same body streams: the coordinates are read through L2 every
//     step and the cache lives in a device scratch buffer (n * 17 bytes a
//     step through one SM).
//   - fps_cluster_kernel, a thread-block cluster of CL blocks of 1,024
//     threads a cloud (2 <= CL <= 8, the portable size), for 13,644 to
//     108,992 points: each block keeps a contiguous slice of the cloud in
//     its own shared memory for the whole run (x, y, z planes, the cache,
//     the mask), so a 100,000-point cloud (CL = 8, 12,500 points a block)
//     is read from device memory once. A step: each thread updates its
//     points' cache and takes its best (value, index); a warp-shuffle
//     argmax; lane 0 of each warp writes the warp's best to shared memory;
//     one __syncthreads; warp 0 reduces the 32 to the block's best and its
//     lanes store it, with the winner's x, y, z, into slot [rank] of every
//     block's candidate buffer (distributed shared memory, remote stores);
//     one cluster barrier; then every warp reads the CL candidates from its
//     own shared memory and reduces them, so every thread knows the chosen
//     point and its coordinates with no read of device memory and no
//     second barrier. The candidate buffers alternate by step parity,
//     which makes one cluster barrier a step enough: a block writes buffer
//     s & 1 again only after the barrier of step s + 1, which every block
//     reaches after it has read its step-s candidates.
//     Why push and not pull: if every warp read all CL x 32 warp results
//     from the other blocks, a step would move 64 KB of remote reads into
//     each block (8 B x 32 lanes x CL x 32 warps), hundreds of ns through
//     the SM-to-SM network; pushing one candidate per block moves CL x 20
//     bytes out of each block and costs one block barrier instead.
//
// What bounds it on the H100: the chain of n_samples dependent steps. The
// bytes the function must move (n * 13 in, n_samples * 4 out) and its 9
// operations per point and step are far below any reachable time. In the
// register body a step is 12 instructions a point (3 subtractions, 3
// products, 2 sums, a minimum, a compare, 2 selects) issued by one SM's 4
// schedulers, plus two redux pairs and a barrier; in the cluster body the
// pass over a block's points from shared memory (about 12 a thread at
// 100,000 points), three shuffle reductions, a block barrier and a cluster
// barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 3.4e38f;
constexpr int kSmemPerBlock = 232448;  // the most a block of sm_90 may use
// fps_kernel's static shared memory: the warp results [2][kWarps], values
// and indices; the rest of kSmemPerBlock is its dynamic shared memory
constexpr int kBlockStatic = 2 * kWarps * 8;

struct Best {
  float v;
  int i;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ Best warp_best(Best x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_xor_sync(0xffffffffu, x.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, x.i, off);
    x = better(x, o);
  }
  return x;
}

// ---------------------------------------------------------------------------
// the register body
// ---------------------------------------------------------------------------

// (threads, points a thread) of each instantiation, smallest first; the
// plan takes the first with threads x points >= n
struct RegisterShape {
  int threads;
  int points;
};
constexpr RegisterShape kRegisterShapes[] = {
    {32, 16}, {128, 16}, {256, 16}, {512, 16}};
constexpr int kRegisterShapeCount =
    sizeof(kRegisterShapes) / sizeof(kRegisterShapes[0]);

// An order-preserving map of a float onto an unsigned key: a negative float
// has all its bits flipped, a positive one only its sign bit, so key(a) <
// key(b) exactly when a < b, except that -0.0 maps below +0.0. The values
// ranked here are cached distances, sums of squares, which are never -0.0
// ((-0.0) * (-0.0) is +0.0, and so is +0.0 + +0.0), -kBig for a masked
// point, and -inf for a thread or warp with no point, which maps below
// every point.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int T, int P>
__global__ void __launch_bounds__(T)
fps_register_kernel(const float* __restrict__ points,   // (B, n, 3)
                    const uint8_t* __restrict__ mask,   // (B, n)
                    int32_t n, int32_t n_samples, int32_t start,
                    int32_t* __restrict__ out) {        // (B, n_samples)
  constexpr int W = T / 32;
  extern __shared__ float cloud[];  // x, y, z planes: the winners' copy
  __shared__ uint32_t wkey[2][W];
  __shared__ uint32_t widx[2][W];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const float* pts = points + b * n * 3;
  const uint8_t* msk = mask + b * n;
  int32_t* o = out + b * n_samples;
  float* sx = cloud;
  float* sy = sx + n;
  float* sz = sy + n;

  float x[P], y[P], z[P], dist[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = tid + j * T;
    x[j] = 0.0f;
    y[j] = 0.0f;
    z[j] = 0.0f;
    // a masked point, or a slot past the cloud, ranks at -kBig for good:
    // min(-kBig, d) is -kBig for every distance d >= 0. A slot past the
    // cloud ties with masked points but has a larger index than all of
    // them, so it is never chosen.
    dist[j] = -kBig;
    if (i < n) {
      x[j] = pts[3 * i];
      y[j] = pts[3 * i + 1];
      z[j] = pts[3 * i + 2];
      sx[i] = x[j];
      sy[i] = y[j];
      sz[i] = z[j];
      if (msk[i]) dist[j] = kBig;
    }
  }
  if (tid == 0) o[0] = start;
  __syncthreads();

  float lx = sx[start];
  float ly = sy[start];
  float lz = sz[start];
  for (int s = 1; s < n_samples; ++s) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float dx = __fsub_rn(x[j], lx);
      const float dy = __fsub_rn(y[j], ly);
      const float dz = __fsub_rn(z[j], lz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      dist[j] = fminf(dist[j], d);
    }
    // the thread's argmax as a tree over its slots (depth log2 P, not a
    // chain of P dependent compares): each node joins two runs of slots,
    // the left one of lower indices, and takes the right only when it is
    // strictly larger, so a tie keeps the lower index
    float bv[P];
    int bj[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      bv[j] = dist[j];
      bj[j] = j;
    }
#pragma unroll
    for (int w = 1; w < P; w *= 2) {
#pragma unroll
      for (int j = 0; j + w < P; j += 2 * w) {
        if (bv[j + w] > bv[j]) {
          bv[j] = bv[j + w];
          bj[j] = bj[j + w];
        }
      }
    }
    const uint32_t key = order_key(bv[0]);
    uint32_t top = __reduce_max_sync(0xffffffffu, key);
    uint32_t win = __reduce_min_sync(
        0xffffffffu, key == top ? static_cast<uint32_t>(tid + bj[0] * T)
                                : 0xffffffffu);
    if constexpr (W > 1) {
      const int buf = s & 1;
      if (lane == 0) {
        wkey[buf][warp] = top;
        widx[buf][warp] = win;
      }
      __syncthreads();
      // a slot past the warps holds key 0, below every warp's key
      const uint32_t k2 = lane < W ? wkey[buf][lane] : 0u;
      const uint32_t i2 = lane < W ? widx[buf][lane] : 0xffffffffu;
      top = __reduce_max_sync(0xffffffffu, k2);
      win = __reduce_min_sync(0xffffffffu, k2 == top ? i2 : 0xffffffffu);
    }
    lx = sx[win];
    ly = sy[win];
    lz = sz[win];
    if (tid == 0) o[s] = static_cast<int32_t>(win);
  }
}

// ---------------------------------------------------------------------------
// the shared-memory and streaming body
// ---------------------------------------------------------------------------

// the whole cloud in dynamic shared memory: the cache, then x, y, z planes
// and the mask
__host__ __device__ inline bool cloud_fits(int n) {
  return static_cast<int64_t>(n) * 17 <= kSmemPerBlock - kBlockStatic;
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ points,   // (B, n, 3)
           const uint8_t* __restrict__ mask,   // (B, n)
           float* __restrict__ scratch,        // (B, n) or null
           int32_t n, int32_t n_samples, int32_t start,
           int32_t* __restrict__ out) {        // (B, n_samples)
  extern __shared__ float smem[];
  __shared__ float wv[2][kWarps];
  __shared__ int wi[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const float* pts = points + b * n * 3;
  const uint8_t* msk = mask + b * n;
  int32_t* o = out + b * n_samples;

  float* dist = smem;
  const float* px = pts;
  const float* py = pts + 1;
  const float* pz = pts + 2;
  int stride = 3;
  if (cloud_fits(n)) {
    float* sx = smem + n;
    float* sy = sx + n;
    float* sz = sy + n;
    uint8_t* sm = reinterpret_cast<uint8_t*>(sz + n);
    for (int i = tid; i < n; i += kThreads) {
      sx[i] = pts[3 * i];
      sy[i] = pts[3 * i + 1];
      sz[i] = pts[3 * i + 2];
      sm[i] = msk[i];
    }
    px = sx;
    py = sy;
    pz = sz;
    msk = sm;
    stride = 1;
  } else {
    dist = scratch + b * n;
  }
  for (int i = tid; i < n; i += kThreads) dist[i] = kBig;
  if (tid == 0) o[0] = start;
  __syncthreads();

  int last = start;
  for (int s = 1; s < n_samples; ++s) {
    const float lx = px[static_cast<int64_t>(last) * stride];
    const float ly = py[static_cast<int64_t>(last) * stride];
    const float lz = pz[static_cast<int64_t>(last) * stride];
    // -inf, so that the first point a thread sees replaces it even when
    // every point is masked (all tie at -kBig and index 0 wins)
    Best best = {-__int_as_float(0x7f800000), 0x7fffffff};
    for (int i = tid; i < n; i += kThreads) {
      const float dx = __fsub_rn(px[static_cast<int64_t>(i) * stride], lx);
      const float dy = __fsub_rn(py[static_cast<int64_t>(i) * stride], ly);
      const float dz = __fsub_rn(pz[static_cast<int64_t>(i) * stride], lz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float dm = fminf(dist[i], d);
      dist[i] = dm;
      const float v = msk[i] ? dm : -kBig;
      if (v > best.v) {  // i rises, so a tie keeps the lower index
        best.v = v;
        best.i = i;
      }
    }
    best = warp_best(best);
    const int buf = s & 1;
    if (lane == 0) {
      wv[buf][warp] = best.v;
      wi[buf][warp] = best.i;
    }
    __syncthreads();
    Best all = {wv[buf][lane], wi[buf][lane]};
    all = warp_best(all);
    last = all.i;
    if (tid == 0) o[s] = last;
  }
}

// ---------------------------------------------------------------------------
// the cluster body
// ---------------------------------------------------------------------------

// a block's best (value, index) and the point's coordinates, as pushed into
// every block of the cluster
struct Cand {
  float v;
  int i;
  float x, y, z;
};

constexpr int kMaxCluster = 8;  // the portable cluster size
// dynamic shared memory ahead of the slice: the candidate buffers
// [2][kMaxCluster], then the warp results [2][kWarps], values and indices
constexpr int kClusterHeader =
    2 * kMaxCluster * static_cast<int>(sizeof(Cand)) + 2 * kWarps * 8;

__global__ void __launch_bounds__(kThreads, 1)
fps_cluster_kernel(const float* __restrict__ points,   // (B, n, 3)
                   const uint8_t* __restrict__ mask,   // (B, n)
                   int32_t n, int32_t per_block, int32_t n_samples,
                   int32_t start,
                   int32_t* __restrict__ out) {        // (B, n_samples)
  extern __shared__ __align__(16) unsigned char cluster_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x / cl;
  const float* pts = points + b * n * 3;
  const uint8_t* msk = mask + b * n;
  int32_t* o = out + b * n_samples;

  Cand* cand = reinterpret_cast<Cand*>(cluster_smem);
  float* wv = reinterpret_cast<float*>(cand + 2 * kMaxCluster);
  int* wi = reinterpret_cast<int*>(wv + 2 * kWarps);
  float* sx = reinterpret_cast<float*>(cluster_smem + kClusterHeader);
  float* sy = sx + per_block;
  float* sz = sy + per_block;
  float* dist = sz + per_block;
  uint8_t* sm = reinterpret_cast<uint8_t*>(dist + per_block);

  // this block's slice, points [lo, lo + count); the last may be short or
  // empty
  const int lo = min(rank * per_block, n);
  const int count = min(per_block, n - lo);
  for (int i = tid; i < count; i += kThreads) {
    const int64_t g = lo + i;
    sx[i] = pts[3 * g];
    sy[i] = pts[3 * g + 1];
    sz[i] = pts[3 * g + 2];
    sm[i] = msk[g];
    dist[i] = kBig;
  }
  if (rank == 0 && tid == 0) o[0] = start;
  float lx = pts[3 * static_cast<int64_t>(start)];
  float ly = pts[3 * static_cast<int64_t>(start) + 1];
  float lz = pts[3 * static_cast<int64_t>(start) + 2];
  // every block runs, and holds its slice, before any block stores into
  // another's shared memory
  cluster.sync();

  for (int s = 1; s < n_samples; ++s) {
    // -inf, so that the first point a thread sees replaces it even when
    // every point is masked; a thread or a block with no point keeps
    // (-inf, INT_MAX), which loses to every point
    Best best = {-__int_as_float(0x7f800000), 0x7fffffff};
    for (int i = tid; i < count; i += kThreads) {
      const float dx = __fsub_rn(sx[i], lx);
      const float dy = __fsub_rn(sy[i], ly);
      const float dz = __fsub_rn(sz[i], lz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float dm = fminf(dist[i], d);
      dist[i] = dm;
      const float v = sm[i] ? dm : -kBig;
      if (v > best.v) {  // i rises, so a tie keeps the lower index
        best.v = v;
        best.i = lo + i;
      }
    }
    best = warp_best(best);
    const int buf = s & 1;
    if (lane == 0) {
      wv[buf * kWarps + warp] = best.v;
      wi[buf * kWarps + warp] = best.i;
    }
    __syncthreads();
    if (warp == 0) {
      Best blk = {wv[buf * kWarps + lane], wi[buf * kWarps + lane]};
      blk = warp_best(blk);
      if (lane < cl) {  // lane r stores into block r
        Cand c = {blk.v, blk.i, 0.0f, 0.0f, 0.0f};
        if (blk.i != 0x7fffffff) {
          c.x = sx[blk.i - lo];
          c.y = sy[blk.i - lo];
          c.z = sz[blk.i - lo];
        }
        *cluster.map_shared_rank(cand + buf * kMaxCluster + rank, lane) = c;
      }
    }
    cluster.sync();
    const Cand* got = cand + buf * kMaxCluster;
    Best all = {-__int_as_float(0x7f800000), 0x7fffffff};
    if (lane < cl) {
      all.v = got[lane].v;
      all.i = got[lane].i;
    }
    all = warp_best(all);
    const Cand& w = got[all.i / per_block];  // the block that owns it
    lx = w.x;
    ly = w.y;
    lz = w.z;
    if (rank == 0 && tid == 0) o[s] = all.i;
  }
  // no block leaves while another may still touch its shared memory
  cluster.sync();
}

}  // namespace

// The launch plan comes from ops/cuda/pointnet.py::fps_plan.
//   - per_thread > 0: the register body, threads x per_thread one of
//     kRegisterShapes and at least n, smem_bytes >= 12 n for the copy of
//     the cloud;
//   - cluster == 0, per_thread == 0: the one-block body, with the cloud in
//     smem_bytes of dynamic shared memory when n <= 13,643, or, when it
//     does not fit, streaming with the cache in scratch, (B, n) floats,
//     and no dynamic shared memory;
//   - cluster >= 1: the cluster body, CL = cluster blocks a cloud,
//     per_block points each.
// A plan the body cannot run is refused with cudaErrorInvalidValue, a
// launch the card refuses with its error; nothing falls back to another
// body.
namespace {

cudaError_t cluster_config(int cluster, int smem_bytes, int grid,
                           void* stream, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaFuncSetAttribute(
      fps_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem_bytes;
  cfg->stream = static_cast<cudaStream_t>(stream);
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

bool cluster_plan_ok(int n, int cluster, int per_block, int smem_bytes) {
  return cluster >= 1 && cluster <= kMaxCluster && per_block >= 1 &&
         static_cast<int64_t>(cluster) * per_block >= n &&
         smem_bytes >= kClusterHeader + 17 * per_block &&
         smem_bytes <= kSmemPerBlock;
}

// the register body's instantiation for (threads, per_thread), if there is
// one, on b clouds of n points
template <int I = 0>
cudaError_t launch_registers(const void* points, const void* mask, int b,
                             int n, int n_samples, int start, int threads,
                             int per_thread, int smem_bytes, void* out,
                             void* stream) {
  if constexpr (I == kRegisterShapeCount) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int T = kRegisterShapes[I].threads;
    constexpr int P = kRegisterShapes[I].points;
    if (threads != T || per_thread != P) {
      return launch_registers<I + 1>(points, mask, b, n, n_samples, start,
                                     threads, per_thread, smem_bytes, out,
                                     stream);
    }
    constexpr int static_bytes = 2 * (T / 32) * 8;  // the warp slots
    if (n > T * P || smem_bytes < 12 * n ||
        smem_bytes > kSmemPerBlock - static_bytes) {
      return cudaErrorInvalidValue;
    }
    cudaError_t err = cudaFuncSetAttribute(
        fps_register_kernel<T, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    fps_register_kernel<T, P>
        <<<b, T, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(points),
            static_cast<const uint8_t*>(mask), n, n_samples, start,
            static_cast<int32_t*>(out));
    return cudaGetLastError();
  }
}

}  // namespace

// how many clusters of this plan the card can hold at once (0: it cannot
// place one), or minus the CUDA error
extern "C" int fps_max_active_clusters(int cluster, int per_block,
                                       int smem_bytes) {
  if (!cluster_plan_ok(1, cluster, per_block, smem_bytes)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(cluster, smem_bytes, cluster, nullptr,
                                   &attr, &cfg);
  int count = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&count, fps_cluster_kernel, &cfg);
  }
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

extern "C" int fps_launch(const void* points, const void* mask, void* scratch,
                          int b, int n, int n_samples, int start, int cluster,
                          int per_block, int smem_bytes, int threads,
                          int per_thread, void* out, void* stream) {
  if (b <= 0 || n_samples <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 0 || start < 0 || start >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (per_thread > 0) {
    if (cluster > 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_registers(points, mask, b, n, n_samples,
                                             start, threads, per_thread,
                                             smem_bytes, out, stream));
  }
  if (cluster > 0) {
    if (!cluster_plan_ok(n, cluster, per_block, smem_bytes)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t err = cluster_config(cluster, smem_bytes, b * cluster, stream,
                                     &attr, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel,
                             static_cast<const float*>(points),
                             static_cast<const uint8_t*>(mask),
                             static_cast<int32_t>(n),
                             static_cast<int32_t>(per_block),
                             static_cast<int32_t>(n_samples),
                             static_cast<int32_t>(start),
                             static_cast<int32_t*>(out));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  // the two cases the plan gives this body: the cloud in shared memory, or
  // the cache in device scratch
  const bool in_smem = cloud_fits(n);
  if (threads != kThreads || (in_smem && smem_bytes < n * 17) ||
      smem_bytes > kSmemPerBlock - kBlockStatic ||
      (!in_smem && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<b, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(mask),
      static_cast<float*>(scratch), n, n_samples, start,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
