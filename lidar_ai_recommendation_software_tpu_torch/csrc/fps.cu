// fps: farthest-point sampling of B clouds, one thread block per cloud.
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
//   - masked points still update their cache, compete with -3.4e38 and are
//     never chosen while a valid point is left; with fewer valid points than
//     samples the indices repeat;
//   - ties go to the lowest index: the reductions compare (value, index)
//     pairs.
// The TPU's (rows, 128) coordinate planes and its masked-reduce read of the
// last point are workarounds of that machine; here the point is indexed.
//
// Design for Hopper: the n_samples steps depend on each other, so one cloud
// cannot use more than the threads that share one barrier cheaply: a block of
// 1,024 threads. The distance cache lives in shared memory for the whole run
// when it fits (n <= 51,200), and so do the coordinates and the mask when
// they fit beside it (n <= 12,047: the serving and training shapes), in which
// case a step touches no device memory at all. Above that the coordinates,
// and above 51,200 points the cache too, are re-read through L2 every step
// (the cache then lives in a scratch buffer the wrapper allocates). A step is
// one pass over the points, a warp-shuffle argmax, one __syncthreads, and a
// second shuffle argmax over the 32 warp results that every warp repeats, so
// all threads know the chosen index without a second barrier. The indices
// leave the chip once.
//
// What bounds it on the H100: the chain of n_samples dependent steps, each a
// block-wide barrier and, for large clouds, n * 17 bytes through one SM's L2
// port. The bytes the function must move (n * 13 in, n_samples * 4 out) and
// its 9 operations per point and step are far below any reachable time; a
// thread-block cluster with the cache in distributed shared memory is the
// redesign for the 100,000-point layer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 3.4e38f;
constexpr int kSmemBudget = 200 * 1024;  // of the 227 KB a block may use

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

// bytes of dynamic shared memory: the cache, then x, y, z planes and the mask
__host__ __device__ inline bool cache_fits(int n) {
  return static_cast<int64_t>(n) * 4 <= kSmemBudget;
}
__host__ __device__ inline bool cloud_fits(int n) {
  return static_cast<int64_t>(n) * 17 <= kSmemBudget;
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

  float* dist = cache_fits(n) ? smem : scratch + b * n;
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

}  // namespace

// floats of scratch the kernel needs per cloud of n points (0 when the
// distance cache fits in shared memory)
extern "C" int fps_scratch_floats(int n) { return cache_fits(n) ? 0 : n; }

extern "C" int fps_launch(const void* points, const void* mask, void* scratch,
                          int b, int n, int n_samples, int start, void* out,
                          void* stream) {
  if (b <= 0 || n_samples <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 0 || start < 0 || start >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!cache_fits(n) && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t bytes = 0;
  if (cloud_fits(n)) {
    bytes = static_cast<size_t>(n) * 17;
  } else if (cache_fits(n)) {
    bytes = static_cast<size_t>(n) * 4;
  }
  bytes = (bytes + 15) / 16 * 16;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBudget + 16);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<b, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(mask),
      static_cast<float*>(scratch), n, n_samples, start,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
