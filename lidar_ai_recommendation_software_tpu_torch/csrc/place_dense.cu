// place_dense: monotone scatter of at most one row per dense slot, with
// occupancy.
//
//   out[c, id] = channels[c, j]   for the one valid row j with ids[j] == id
//   occ[id]    = 1                for those slots, 0 elsewhere; out is 0 there
//
// Replaces the TPU kernel lidar_ai_recommendation_software_tpu/ops/pallas/
// fill.py::place_dense (_place_kernel), which places rows with one-hot
// products of three bf16 pieces of every value over a tile schedule. None of
// that carries over: a GPU thread stores a float where it belongs, so the
// placement is exact by construction. As the TPU wrapper does, ids are
// clipped into [0, K' - 1] before they are used (K' = k rounded up to the
// lane count), so an id past the end lands in the last slot and a negative
// one in slot 0. The contract is the caller's: ids non-decreasing and at most
// one valid row per clipped id (two valid rows of one slot race).
//
// Design for Hopper: the launch function starts two kernels on the stream.
// The first writes zeros to the whole (C + 1, K') result, so the wrapper
// allocates with torch.empty and every slot is written by this source. The
// second runs one thread per row; a valid row stores its C values and its
// occupancy. Rows are read coalesced (ids, valid), channels only at valid
// rows.
//
// What bounds it on the H100: bytes. ids (4 n), valid (n) and the C channels
// (4 C n at most) are read once and (C + 1) K' floats are written; there is
// no arithmetic. At the centroid pack's shapes (n = 3.1M rows, C = 7,
// K' = 393,216) most rows are invalid, so the channel reads touch one
// 32-byte sector per segment end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
place_zero_kernel(float* __restrict__ out, int64_t total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < total) out[i] = 0.0f;
}

__global__ void __launch_bounds__(kThreads)
place_rows_kernel(const int32_t* __restrict__ ids,      // (n,)
                  const uint8_t* __restrict__ valid,    // (n,)
                  const float* __restrict__ channels,   // (C, n)
                  int32_t n, int32_t nch, int32_t kp,
                  float* __restrict__ out) {            // (C + 1, kp)
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n || valid[j] == 0) return;
  int32_t slot = ids[j];
  slot = slot < 0 ? 0 : (slot > kp - 1 ? kp - 1 : slot);
  for (int c = 0; c < nch; ++c) {
    out[static_cast<int64_t>(c) * kp + slot] =
        channels[static_cast<int64_t>(c) * n + j];
  }
  out[static_cast<int64_t>(nch) * kp + slot] = 1.0f;
}

}  // namespace

extern "C" int place_dense_launch(const void* ids, const void* valid,
                                  const void* channels, int n, int nch,
                                  int kp, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(nch + 1) * kp;
  if (total > 0) {
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    place_zero_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<float*>(out), total);
  }
  if (n > 0 && kp > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    place_rows_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(ids), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(channels), n, nch, kp,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
