// sa_mlp_pool: the set-abstraction layer's shared 3-layer MLP with ReLU over
// the (M * K, Cin) grouped rows, fused with the max over each centroid's
// valid neighbours.
//
// Replaces the TPU kernel lidar_ai_recommendation_software_tpu/ops/pallas/
// kernels.py::sa_mlp_pool (_sa_mlp_kernel). The semantics kept:
//   - per layer, relu(x @ W + b): the products summed in float32 in a fixed
//     order (input channel 0 first), the bias added after the sum, in
//     float32;
//   - compute type bf16: the operands of every product, activations and
//     weights of each layer, are rounded to bf16 (round to nearest even) and
//     multiplied and summed in float32;
//   - the pool is the max over the valid neighbours only, and 0 for a
//     centroid with none. (The TPU kernel adds -1e9 to invalid rows because
//     its compiler cannot broadcast a boolean; activations are >= 0 after
//     the ReLU, so a masked max that starts at 0 gives the same numbers.)
// M need not be a multiple of the tile: the ragged edge is masked here.
//
// Design for Hopper: one block takes a tile of centroids (as many as fit
// 128 rows: 4 at K = 32). It stages the three weight matrices and biases in
// shared memory once (rounded once in bf16 mode), then the tile's rows, and
// runs the three layers between two activation buffers in shared memory;
// only the (M, Cout) maxima reach device memory, which is what the TPU
// kernel is for. A warp computes 64 rows x 8 output columns at a time: each
// lane owns two rows and 8 accumulators, reads its two activations (row
// stride odd, so the 32 lanes hit 32 banks) and the 8 weights as two
// 16-byte broadcasts per input channel. Plain FP32 fused multiply-adds;
// the tensor cores (wgmma on bf16 tiles) are a later redesign.
//
// What bounds it on the H100: operations. Per row 2 * (Cin*H1 + H1*H2 +
// H2*Cout) FP32 operations against (Cin * 4 + 1) bytes read; at the
// 100,000-point layer (131,072 rows, 3-32-32-64) that is 0.83 GFLOP
// against 1.7 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 128;         // rows of one tile
constexpr int kSmemLimit = 227 * 1024;

template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// out[r, :h] = relu(in[r, :cin] @ w + b) for r < rows; kRound rounds the
// result for the next layer's products
template <bool kRound>
__device__ void layer(const float* __restrict__ in, int ldi, int cin,
                      const float* __restrict__ w,
                      const float* __restrict__ bias, int h,
                      float* __restrict__ out, int ldo, int rows) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ngroups = (rows + 63) / 64;
  const int nstrips = h / 8;
  for (int item = warp; item < ngroups * nstrips; item += kWarps) {
    const int grp = item / nstrips;
    const int j0 = (item % nstrips) * 8;
    const int r0 = grp * 64 + lane;
    const int r1 = r0 + 32;
    // rows past the tile read the last row and are not stored
    const float* a0 = in + (r0 < rows ? r0 : rows - 1) * ldi;
    const float* a1 = in + (r1 < rows ? r1 : rows - 1) * ldi;
    float acc0[8], acc1[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc0[q] = acc1[q] = 0.0f;
    for (int c = 0; c < cin; ++c) {
      const float x0 = a0[c];
      const float x1 = a1[c];
      const float4 wa = *reinterpret_cast<const float4*>(w + c * h + j0);
      const float4 wb = *reinterpret_cast<const float4*>(w + c * h + j0 + 4);
      const float wq[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        acc0[q] = fmaf(x0, wq[q], acc0[q]);
        acc1[q] = fmaf(x1, wq[q], acc1[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float bq = bias[j0 + q];
      const float v0 = operand<kRound>(fmaxf(__fadd_rn(acc0[q], bq), 0.0f));
      const float v1 = operand<kRound>(fmaxf(__fadd_rn(acc1[q], bq), 0.0f));
      if (r0 < rows) out[r0 * ldo + j0 + q] = v0;
      if (r1 < rows) out[r1 * ldo + j0 + q] = v1;
    }
  }
}

struct Layout {
  int w1, w2, w3, b1, b2, b3, buf_a, buf_b, valid, floats, lda, ldb;
};

__host__ __device__ inline Layout layout(int rows, int cin, int h1, int h2,
                                         int cout) {
  Layout l;
  l.lda = (cin > h2 ? cin : h2) | 1;   // odd strides: no bank conflicts
  l.ldb = (h1 > cout ? h1 : cout) | 1;
  int at = 0;
  l.w1 = at; at += (cin * h1 + 3) / 4 * 4;   // 16-byte aligned rows of 8
  l.w2 = at; at += h1 * h2;
  l.w3 = at; at += h2 * cout;
  l.b1 = at; at += h1;
  l.b2 = at; at += h2;
  l.b3 = at; at += cout;
  l.buf_a = at; at += rows * l.lda;
  l.buf_b = at; at += rows * l.ldb;
  l.valid = at; at += rows;
  l.floats = at;
  return l;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
sa_mlp_pool_kernel(const float* __restrict__ grouped,  // (M, K, Cin)
                   const uint8_t* __restrict__ valid,  // (M, K)
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ w3, const float* __restrict__ b3,
                   int m, int k, int cin, int h1, int h2, int cout, int tm,
                   float* __restrict__ out) {          // (M, Cout)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * tm;
  const int cents = (m - m0 < tm) ? m - m0 : tm;  // centroids of this tile
  const int rows = cents * k;
  const Layout l = layout(tm * k, cin, h1, h2, cout);
  float* sw1 = smem + l.w1;
  float* sw2 = smem + l.w2;
  float* sw3 = smem + l.w3;
  float* sb1 = smem + l.b1;
  float* sb2 = smem + l.b2;
  float* sb3 = smem + l.b3;
  float* buf_a = smem + l.buf_a;
  float* buf_b = smem + l.buf_b;
  int* sval = reinterpret_cast<int*>(smem + l.valid);

  for (int i = tid; i < cin * h1; i += kThreads) sw1[i] = operand<kBf16>(w1[i]);
  for (int i = tid; i < h1 * h2; i += kThreads) sw2[i] = operand<kBf16>(w2[i]);
  for (int i = tid; i < h2 * cout; i += kThreads) sw3[i] = operand<kBf16>(w3[i]);
  for (int i = tid; i < h1; i += kThreads) sb1[i] = b1[i];
  for (int i = tid; i < h2; i += kThreads) sb2[i] = b2[i];
  for (int i = tid; i < cout; i += kThreads) sb3[i] = b3[i];
  const float* g = grouped + static_cast<int64_t>(m0) * k * cin;
  for (int i = tid; i < rows * cin; i += kThreads) {
    buf_a[(i / cin) * l.lda + (i % cin)] = operand<kBf16>(g[i]);
  }
  const uint8_t* v = valid + static_cast<int64_t>(m0) * k;
  for (int i = tid; i < rows; i += kThreads) sval[i] = v[i];
  __syncthreads();

  layer<kBf16>(buf_a, l.lda, cin, sw1, sb1, h1, buf_b, l.ldb, rows);
  __syncthreads();
  layer<kBf16>(buf_b, l.ldb, h1, sw2, sb2, h2, buf_a, l.lda, rows);
  __syncthreads();
  layer<false>(buf_a, l.lda, h2, sw3, sb3, cout, buf_b, l.ldb, rows);
  __syncthreads();

  for (int i = tid; i < cents * cout; i += kThreads) {
    const int t = i / cout;
    const int j = i % cout;
    float best = 0.0f;  // activations are >= 0; no valid neighbour gives 0
    for (int kk = 0; kk < k; ++kk) {
      const int r = t * k + kk;
      if (sval[r]) best = fmaxf(best, buf_b[r * l.ldb + j]);
    }
    out[static_cast<int64_t>(m0 + t) * cout + j] = best;
  }
}

template <bool kBf16>
cudaError_t launch(const void* grouped, const void* valid, const void* w1,
                   const void* b1, const void* w2, const void* b2,
                   const void* w3, const void* b3, int m, int k, int cin,
                   int h1, int h2, int cout, int tm, size_t bytes,
                   void* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sa_mlp_pool_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (err != cudaSuccess) return err;
  const int blocks = (m + tm - 1) / tm;
  sa_mlp_pool_kernel<kBf16><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const float*>(grouped), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3), m, k, cin,
      h1, h2, cout, tm, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// Widths the kernel takes: K <= 128 neighbours, H1, H2 and Cout multiples of
// 8, and a tile that fits the block's shared memory. Anything else returns
// cudaErrorInvalidValue and the wrapper raises.
extern "C" int sa_mlp_pool_launch(const void* grouped, const void* valid,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* w3, const void* b3, int m, int k,
                                  int cin, int h1, int h2, int cout, int bf16,
                                  void* out, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  if (k <= 0 || k > kMaxRows || cin <= 0 || h1 <= 0 || h2 <= 0 || cout <= 0 ||
      h1 % 8 || h2 % 8 || cout % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tm = kMaxRows / k;
  const size_t bytes =
      static_cast<size_t>(layout(tm * k, cin, h1, h2, cout).floats) * 4;
  if (bytes > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<true>(grouped, valid, w1, b1, w2, b2, w3, b3, m, k, cin,
                          h1, h2, cout, tm, bytes, out, s)
           : launch<false>(grouped, valid, w1, b1, w2, b2, w3, b3, m, k, cin,
                           h1, h2, cout, tm, bytes, out, s);
  return static_cast<int>(err);
}
