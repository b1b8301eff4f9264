// place_dense: monotone scatter of at most one row per dense slot, with
// occupancy.
//
//   out[c, id] = channels[c, j]   for the one valid row j with ids[j] == id
//   occ[id]    = 1                for those slots, 0 elsewhere; out is 0 there
//
// Replaces the TPU kernel lidar_ai_recommendation_software_tpu/ops/pallas/
// fill.py:398 place_dense (body _place_kernel at :364), which places rows
// with one-hot products of three bf16 pieces of every value over a tile
// schedule. None of that carries over: a GPU thread stores a float where it
// belongs, so the placement is exact by construction. As the TPU wrapper
// does, ids are clipped into [0, K' - 1] before they are used (K' = k
// rounded up to the lane count), so an id past the end lands in the last
// slot and a negative one in slot 0. The contract is the caller's: ids
// non-decreasing and at most one valid row per clipped id (two valid rows
// of one slot race).
//
// What bounds it on the H100: bytes, and the latency of sparse reads. valid
// (n bytes) is read whole; ids and the C channels only at valid rows, and at
// the centroid pack's shapes (n = 3.1M rows, C = 7, K' = 393,216, 133,253
// valid rows about 24 apart) each of those values sits alone in its own
// 32-byte sector; the (C + 1) K' result is written once. A thread a row
// would leave a warp of 32 rows with about 1.4 valid rows and each valid
// thread with a chain of C + 1 dependent trips to memory.
//
// Design for Hopper, one launch:
//   - the zeros: the launch's first blocks (two an SM) write the whole
//     result with 16-byte stores, then each adds one to a counter. The row
//     blocks issue their loads first and wait on that counter only before
//     their first store, so the reads are in flight while the zeros are
//     written, and no second launch waits for the first. The zeros cannot
//     be left to the row blocks: a slot's zero and its value would come
//     from different blocks wherever a run of one id crosses a block, and a
//     slot-tiled pass would hand a whole run, or a whole gap between ids,
//     to one block. The last block to finish sets the counters back to 0;
//   - the rows: a warp takes 512 rows, 16 a lane, read as one 16-byte load
//     of valid; a prefix of the lanes' counts over the warp lists the valid
//     rows in shared memory. Then the lanes spread over the (channel, valid
//     row) pairs, occupancy included, 8 a lane in registers: every load of
//     a batch, and the ids of the valid rows, are issued before any store
//     waits on one. Consecutive lanes take consecutive valid rows of one
//     channel, whose slots are consecutive, so the stores coalesce;
//   - the time grows with n and the valid rows, not with the length of a
//     run: a warp whose 512 rows hold no valid row leaves after its load of
//     valid (the scan's unlabelled rows are one run into the last slot).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneRows = 16;                 // one 16-byte load of valid
constexpr int kWarpRows = 32 * kLaneRows;     // rows a warp
constexpr int kBlockRows = kWarps * kWarpRows;
constexpr int kBatch = 8;                     // loads in flight a lane
constexpr int kZeroBlocks = 264;              // two an SM

// Zero blocks finished in this launch, and blocks finished; the last block
// of a launch sets both back to 0 for the next one. (So two launches must
// not run at once on one card.)
__device__ unsigned int g_zeros_done = 0;
__device__ unsigned int g_blocks_done = 0;

// blocks [0, zero_blocks): the zeros, 16-byte stores striding over the result
__device__ __forceinline__ void zeros(float* __restrict__ out, int64_t total,
                                      int zero_blocks) {
  const int64_t quads = total / 4;
  float4* out4 = reinterpret_cast<float4*>(out);
  const int64_t stride = static_cast<int64_t>(zero_blocks) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < quads; i += stride) {
    out4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (blockIdx.x == 0 && threadIdx.x < total - 4 * quads) {
    out[4 * quads + threadIdx.x] = 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(&g_zeros_done, 1u);
  }
}

// until every zero block of this launch is done (lane 0 of a warp waits;
// the zero blocks have the lowest indices, so they run first). A wait past
// about two seconds traps rather than hangs.
__device__ __forceinline__ void await_zeros(int zero_blocks) {
  if ((threadIdx.x & 31) == 0) {
    const long long t0 = clock64();
    while (*reinterpret_cast<volatile unsigned int*>(&g_zeros_done) <
           static_cast<unsigned int>(zero_blocks)) {
      __nanosleep(256);
      if (clock64() - t0 > (1ll << 32)) __trap();
    }
    __threadfence();
  }
  __syncwarp();
}

// blocks [zero_blocks, ...): 512 rows a warp
__device__ __forceinline__ void rows(const int32_t* __restrict__ ids,
                                     const uint8_t* __restrict__ valid,
                                     const float* __restrict__ channels,
                                     int32_t n, int32_t nch, int32_t kp,
                                     float* __restrict__ out, int zero_blocks,
                                     uint16_t* row_of, int32_t* slot_of) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x - zero_blocks) *
                       kBlockRows + warp * kWarpRows;
  if (base >= n) return;
  row_of += warp * kWarpRows;
  slot_of += warp * kWarpRows;

  // this lane's 16 rows as bits
  const int64_t r0 = base + lane * kLaneRows;
  uint32_t bits = 0;
  if (r0 + kLaneRows <= n && (reinterpret_cast<uintptr_t>(valid) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(valid + r0);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if ((words[w] >> (8 * b)) & 0xffu) bits |= 1u << (4 * w + b);
      }
    }
  } else {
    for (int i = 0; i < kLaneRows && r0 + i < n; ++i) {
      if (valid[r0 + i]) bits |= 1u << i;
    }
  }

  // list the warp's valid rows in order: an exclusive prefix of the counts
  const int count = __popc(bits);
  int incl = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  if (total == 0) return;
  for (int at = incl - count; bits; bits &= bits - 1, ++at) {
    row_of[at] = static_cast<uint16_t>(lane * kLaneRows + __ffs(bits) - 1);
  }
  __syncwarp();

  // pair p: channel p / total (nch: the occupancy) of valid row p % total
  const int pairs = total * (nch + 1);
  for (int b0 = 0; b0 < pairs; b0 += 32 * kBatch) {
    float val[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int p = b0 + q * 32 + lane;
      val[q] = 1.0f;
      if (p < pairs) {
        const int c = p / total;
        if (c < nch) {
          val[q] = channels[static_cast<int64_t>(c) * n + base +
                            row_of[p - c * total]];
        }
      }
    }
    if (b0 == 0) {
#pragma unroll 4
      for (int i = lane; i < total; i += 32) {
        const int32_t s = ids[base + row_of[i]];
        slot_of[i] = s < 0 ? 0 : (s > kp - 1 ? kp - 1 : s);
      }
      await_zeros(zero_blocks);  // the loads above stay in flight
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int p = b0 + q * 32 + lane;
      if (p < pairs) {
        const int c = p / total;
        out[static_cast<int64_t>(c) * kp + slot_of[p - c * total]] = val[q];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
place_dense_kernel(const int32_t* __restrict__ ids,      // (n,)
                   const uint8_t* __restrict__ valid,    // (n,)
                   const float* __restrict__ channels,   // (C, n)
                   int32_t n, int32_t nch, int32_t kp, int zero_blocks,
                   float* __restrict__ out) {            // (C + 1, kp)
  __shared__ uint16_t row_of[kWarps * kWarpRows];  // valid rows, in order
  __shared__ int32_t slot_of[kWarps * kWarpRows];  // and their slots
  if (static_cast<int>(blockIdx.x) < zero_blocks) {
    zeros(out, static_cast<int64_t>(nch + 1) * kp, zero_blocks);
  } else {
    rows(ids, valid, channels, n, nch, kp, out, zero_blocks, row_of,
         slot_of);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&g_blocks_done, 1u) == gridDim.x - 1) {
      g_zeros_done = 0;
      g_blocks_done = 0;
      __threadfence();
    }
  }
}

}  // namespace

// Shapes the kernels take: n >= 0 rows, nch >= 0 channels, kp > 0 slots, and
// a result 16-byte aligned; anything else returns cudaErrorInvalidValue and
// the wrapper raises. The plan is mirrored by ops/cuda/place.py::place_plan.
extern "C" int place_dense_launch(const void* ids, const void* valid,
                                  const void* channels, int n, int nch,
                                  int kp, void* out, void* stream) {
  if (n < 0 || nch < 0 || kp <= 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(nch + 1) * kp;
  const int64_t quad_blocks = (total / 4 + kThreads - 1) / kThreads;
  const int zero_blocks = static_cast<int>(
      quad_blocks < 1 ? 1 : (quad_blocks < kZeroBlocks ? quad_blocks
                                                       : kZeroBlocks));
  const int row_blocks = (n + kBlockRows - 1) / kBlockRows;
  place_dense_kernel<<<zero_blocks + row_blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(channels), n, nch, kp, zero_blocks,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
