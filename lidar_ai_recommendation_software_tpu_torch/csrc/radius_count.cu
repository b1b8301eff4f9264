// radius_count: number of valid people within radius r (inclusive) of each
// density-cell centre.
//
// Replaces the TPU kernel lidar_ai_recommendation_software_tpu/ops/pallas/
// kernels.py::radius_count (_radius_count_kernel). It computes the same
// counts, bit for bit: the squared distance is formed as dx*dx + dy*dy with
// every product and sum rounded on its own (__fmul_rn / __fadd_rn), so no
// fused multiply-add moves a person who sits exactly at the radius across
// it, and the comparison is d2 <= r2. The caller passes r2 as the TPU kernel
// forms it: r * r in double precision, rounded once to float.
//
// Design for Hopper: one thread per cell centre holds its centre and its
// count in registers; the block stages people through shared memory in
// tiles (x, y and mask), so each person is read from device memory once per
// block. The people capacity is a padded bucket whose valid entries form a
// prefix, so the loop stops at the live extent nv (last valid index + 1),
// which the caller computes on the device and the kernel reads from device
// memory; it never goes through the host.
//
// What bounds it on the H100: at the pipeline's sizes (about 9e3 centres x
// 5e3 people = 5e7 pair tests) a launch is a few microseconds of work and
// launch overhead dominates. At C*K around 1e9 pair tests it is bound by the
// compare loop (about 6 floating-point and integer operations per pair), not
// by device memory: the inputs are (C + K) * 12 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // centres per block
constexpr int kTile = kThreads;  // people staged per shared-memory tile,
                                 // one per thread

__global__ void __launch_bounds__(kThreads)
radius_count_kernel(const float* __restrict__ centers,  // (C, 2)
                    const float* __restrict__ people,   // (K, 2)
                    const uint8_t* __restrict__ pmask,  // (K,)
                    const int32_t* __restrict__ nv_ptr, // ()
                    float r2, int32_t c, int32_t k,
                    int32_t* __restrict__ out) {        // (C,)
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ uint8_t sm[kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  float cx = 0.0f, cy = 0.0f;
  if (i < c) {
    cx = centers[2 * i];
    cy = centers[2 * i + 1];
  }
  int nv = *nv_ptr;
  nv = nv < k ? nv : k;

  int32_t count = 0;
  for (int base = 0; base < nv; base += kTile) {
    const int j = base + threadIdx.x;  // each thread stages one person
    if (j < nv) {
      sx[threadIdx.x] = people[2 * j];
      sy[threadIdx.x] = people[2 * j + 1];
      sm[threadIdx.x] = pmask[j];
    }
    __syncthreads();
    const int len = min(kTile, nv - base);
    for (int t = 0; t < len; ++t) {
      const float dx = __fsub_rn(cx, sx[t]);
      const float dy = __fsub_rn(cy, sy[t]);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      count += (d2 <= r2) & (sm[t] != 0);
    }
    __syncthreads();
  }
  if (i < c) out[i] = count;
}

}  // namespace

extern "C" int radius_count_launch(const void* centers, const void* people,
                                   const void* pmask, const void* nv,
                                   float r2, int c, int k, void* out,
                                   void* stream) {
  if (c > 0) {
    const int blocks = (c + kThreads - 1) / kThreads;
    radius_count_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(centers), static_cast<const float*>(people),
        static_cast<const uint8_t*>(pmask), static_cast<const int32_t*>(nv),
        r2, c, k, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
