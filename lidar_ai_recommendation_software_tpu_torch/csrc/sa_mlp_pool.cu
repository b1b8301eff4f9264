// sa_mlp_pool: the set-abstraction layer's shared 3-layer MLP with ReLU over
// the (M * K, Cin) grouped rows, fused with the max over each centroid's
// valid neighbours.
//
// Replaces the TPU kernel lidar_ai_recommendation_software_tpu/ops/pallas/
// kernels.py:166 sa_mlp_pool (body _sa_mlp_kernel at :136). The semantics
// kept:
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
// M need not be a multiple of the tile: the ragged edge is masked here. No
// atomics: two runs are bit-identical.
//
// What bounds it on the H100: operations. Per row 2 * (Cin*H1 + H1*H2 +
// H2*Cout) FP32 operations against (Cin * 4 + 1) bytes read: the served
// model's second layer (128 x 32 rows, 67-64-64-128) is 0.14 GFLOP, 2.0 us
// at 67 TFLOP/s; float32 stays on the CUDA cores (TF32 keeps three digits).
// At the served shapes the work is small, so the time is made of how many
// SMs a launch fills, a block's fixed cost (launch, staging, barriers) and
// each warp's chain of dependent shared-memory loads. At the 100,000-point
// layer it is the shared-memory loads: each input channel step of a warp
// item reads its activations and two 16-byte weight broadcasts.
//
// Design for Hopper:
//   - a block takes a tile of 32 rows: 32 / K centroids, or one at K >= 32.
//     So the served model's second layer runs 128 blocks, and a block's
//     shared memory (the weights and two activation buffers of the tile)
//     lets several blocks share an SM. When a launch has 1,056 such tiles
//     or more (8 blocks an SM), a tile takes up to 128 rows and a warp item
//     two pieces of 32 rows, so each weight broadcast feeds twice the
//     multiply-adds and the weights are staged a quarter as often;
//   - staging by cp.async in three groups: the tile's rows with W1 and b1,
//     then W2 and b2, then W3 and b3; layer 1 starts once the first group
//     has landed, while the others are still in flight. (With bf16 operands
//     each thread rounds the values it copied itself once they land.) The
//     block's shared-memory limit is set once per instantiation;
//   - a warp item is one or two 32-row pieces, a row a lane, by 8 output
//     columns: per input channel one activation load a piece (row strides
//     odd: the 32 lanes hit 32 banks), two 16-byte weight broadcasts and 8
//     fused multiply-adds a piece. The model's two width sets are template
//     parameters (loops unrolled by 4: a whole unroll of the 67-wide loop
//     spills); one generic body takes every other shape;
//   - layer 3's output never reaches shared memory: a warp owns 8 output
//     columns of the whole tile, walks its pieces in order, and takes each
//     centroid's masked max across its lanes in registers. When K is a
//     multiple of 32 a piece is one centroid's, and halving exchanges
//     reduce the 8 columns in 9 shuffles; otherwise a segmented max with
//     __shfl_down_sync, whose running max is carried from one piece to the
//     next (any K <= 128). A masked row gives 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPiece = 32;            // rows of a piece of a warp item
constexpr int kMaxRows = 128;         // rows of a tile, and the largest K
// Past kSplitBlocks tiles of 32 rows (8 blocks an SM), a tile takes up to
// kMaxRows rows, and a warp item kWideRows pieces of them.
constexpr int kSplitBlocks = 1056;
constexpr int kWideRows = 2;
constexpr int kSmemPerBlock = 232448;

template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// n floats from src to dst (16-byte aligned) in 16-byte copies where src is
// 16-byte aligned too, else 4-byte ones. With kRound (after the copies have
// landed), each thread rounds to bf16 the floats it copied itself.
template <bool kRound>
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  const int tid = threadIdx.x;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    head = n & ~3;
    for (int i = 4 * tid; i < head; i += 4 * kThreads) {
      if (kRound) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[i + q] = operand<true>(dst[i + q]);
      } else {
        cp_async16(dst + i, src + i);
      }
    }
  }
  for (int i = head + tid; i < n; i += kThreads) {
    if (kRound) {
      dst[i] = operand<true>(dst[i]);
    } else {
      cp_async4(dst + i, src + i);
    }
  }
}

// acc[i][q] = sum over c of x[i][c] * w[c * ldw + q] for the kR rows x[i]
// and 8 columns q; channel 0 first
template <int kCin, int kR>
__device__ __forceinline__ void dot8(const float* const (&x)[kR], int cin_rt,
                                     const float* __restrict__ w, int ldw,
                                     float (&acc)[kR][8]) {
  const int cin = kCin ? kCin : cin_rt;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.0f;
  }
#pragma unroll(kCin && kCin < 8 ? kCin : 4)
  for (int c = 0; c < cin; ++c) {
    float xc[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) xc[i] = x[i][c];
    const float4 wa = *reinterpret_cast<const float4*>(w + c * ldw);
    const float4 wb = *reinterpret_cast<const float4*>(w + c * ldw + 4);
    const float wq[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(xc[i], wq[q], acc[i][q]);
    }
  }
}

// the rows of pieces first .. first + kR - 1 this lane takes (rows past the
// tile read its last row and are not stored)
template <int kR>
__device__ __forceinline__ void piece_rows(const float* in, int ldi, int first,
                                           int rows, const float* (&x)[kR]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = (first + i) * kPiece + lane;
    x[i] = in + (r < rows ? r : rows - 1) * ldi;
  }
}

// out[r, :h] = relu(in[r, :cin] @ w + b) for r < rows; kRound rounds the
// result for the next layer's products. A warp item: kR pieces by 8 columns.
template <int kCin, int kH, int kR, bool kRound>
__device__ __forceinline__ void dense(const float* __restrict__ in, int ldi,
                                      int cin, const float* __restrict__ w,
                                      const float* __restrict__ bias,
                                      int h_rt, float* __restrict__ out,
                                      int ldo, int rows) {
  const int h = kH ? kH : h_rt;
  const int lane = threadIdx.x & 31;
  const int strips = h / 8;
  const int groups = ((rows + kPiece - 1) / kPiece + kR - 1) / kR;
  for (int item = threadIdx.x >> 5; item < groups * strips; item += kWarps) {
    const int first = item / strips * kR;
    const int j0 = item % strips * 8;
    const float* x[kR];
    piece_rows<kR>(in, ldi, first, rows, x);
    float acc[kR][8];
    dot8<kCin, kR>(x, cin, w + j0, h, acc);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = (first + i) * kPiece + lane;
      if (r < rows) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          out[r * ldo + j0 + q] = operand<kRound>(
              fmaxf(__fadd_rn(acc[i][q], bias[j0 + q]), 0.0f));
        }
      }
    }
  }
}

// The max of v[q] over the warp's 32 lanes, by halving exchanges: lane l
// ends with column (l >> 2) & 7 of it (bit 4 of l picks the half, bit 3 the
// quarter, bit 2 the column), 9 shuffles for 8 columns.
__device__ __forceinline__ float warp_max8(const float (&v)[8], int& col) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float h4[4], h2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float o = __shfl_xor_sync(all, b4 ? v[i] : v[i + 4], 16);
    h4[i] = fmaxf(b4 ? v[i + 4] : v[i], o);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float o = __shfl_xor_sync(all, b3 ? h4[i] : h4[i + 2], 8);
    h2[i] = fmaxf(b3 ? h4[i + 2] : h4[i], o);
  }
  float t = fmaxf(b2 ? h2[1] : h2[0],
                  __shfl_xor_sync(all, b2 ? h2[0] : h2[1], 4));
  t = fmaxf(t, __shfl_xor_sync(all, t, 2));
  t = fmaxf(t, __shfl_xor_sync(all, t, 1));
  col = (b4 ? 4 : 0) + (b3 ? 2 : 0) + (b2 ? 1 : 0);
  return t;
}

// The last layer and the pool: out[t, :cout] = max over the valid rows r of
// centroid t of relu(in[r, :h2] @ w + b), 0 if none. A warp owns 8 output
// columns of the whole tile and walks its pieces in order, kR at a time.
template <int kH2, int kCout, int kR>
__device__ __forceinline__ void pool(const float* __restrict__ in, int ldi,
                                     int h2, const float* __restrict__ w,
                                     const float* __restrict__ bias,
                                     int cout_rt,
                                     const uint8_t* __restrict__ valid, int k,
                                     int rows, float* __restrict__ out) {
  const unsigned all = 0xffffffffu;
  const int cout = kCout ? kCout : cout_rt;
  const int lane = threadIdx.x & 31;
  const int pieces = (rows + kPiece - 1) / kPiece;
  const bool whole = k % kPiece == 0;  // every piece inside one centroid
  for (int s = threadIdx.x >> 5; s < cout / 8; s += kWarps) {
    const int j0 = s * 8;
    // the max so far of the centroid that goes on into the next piece:
    // lane l's column (whole pieces), or all 8 (carry, any K)
    float run = 0.0f;
    float carry[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) carry[q] = 0.0f;
    for (int first = 0; first < pieces; first += kR) {
      const float* x[kR];
      piece_rows<kR>(in, ldi, first, rows, x);
      float acc[kR][8];
      dot8<kH2, kR>(x, h2, w + j0, cout, acc);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int base = (first + i) * kPiece;
        if (base >= rows) break;
        const int r = base + lane;
        const bool live = r < rows && valid[r];
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          v[q] = live ? fmaxf(__fadd_rn(acc[i][q], bias[j0 + q]), 0.0f)
                      : 0.0f;
        }
        if (whole) {
          int col;
          run = fmaxf(run, warp_max8(v, col));
          if ((base + kPiece) % k == 0) {  // the centroid's last piece
            if ((lane & 3) == 0) {
              out[static_cast<int64_t>(base / k) * cout + j0 + col] = run;
            }
            run = 0.0f;
          }
          continue;
        }
        // segmented max down the lanes of one centroid: lane i ends with
        // the max of lanes i to `last`, the centroid's last lane here
        const int cent = r / k;
        const int end = min((cent + 1) * k, rows) - 1 - base;
        const int last = end < kPiece - 1 ? end : kPiece - 1;
#pragma unroll
        for (int off = 1; off < kPiece; off <<= 1) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float o = __shfl_down_sync(all, v[q], off);
            if (lane + off <= last) v[q] = fmaxf(v[q], o);
          }
        }
        if (lane == 0 && r % k != 0) {  // lane 0's centroid began before
#pragma unroll
          for (int q = 0; q < 8; ++q) v[q] = fmaxf(v[q], carry[q]);
        }
        // the first lane of the centroid that holds lane 31 carries its max
        const int tail = max((base + kPiece - 1) / k * k - base, 0);
#pragma unroll
        for (int q = 0; q < 8; ++q) carry[q] = __shfl_sync(all, v[q], tail);
        const bool head = r < rows && (lane == 0 || r % k == 0);
        if (head && (cent + 1) * k <= base + kPiece) {  // its last row
          float4* o = reinterpret_cast<float4*>(
              out + static_cast<int64_t>(cent) * cout + j0);
          o[0] = make_float4(v[0], v[1], v[2], v[3]);
          o[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }
  }
}

struct Layout {
  int w1, w2, w3, b1, b2, b3, x, a1, ld1, ld2, floats;
};

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

// floats of shared memory, every region 16-byte aligned: the weights and
// biases, the tile's rows (where layer 2 later writes), layer 1's output
__host__ __device__ inline Layout layout(int rows, int cin, int h1, int h2,
                                         int cout) {
  Layout l;
  l.ld1 = h1 | 1;  // odd strides: a warp's 32 rows hit 32 banks
  l.ld2 = h2 | 1;
  int at = 0;
  l.w1 = at; at += up4(cin * h1);
  l.w2 = at; at += up4(h1 * h2);
  l.w3 = at; at += up4(h2 * cout);
  l.b1 = at; at += up4(h1);
  l.b2 = at; at += up4(h2);
  l.b3 = at; at += up4(cout);
  l.x = at; at += up4(rows * (cin > l.ld2 ? cin : l.ld2));
  l.a1 = at; at += up4(rows * l.ld1);
  l.floats = at;
  return l;
}

// The tile: 32 rows (32 / K centroids, or one at K >= 32), a warp item one
// piece; when that gives kSplitBlocks blocks or more, up to kMaxRows rows
// (kMaxRows / K centroids, or one) and a warp item kWideRows pieces.
struct Tile {
  int centroids, wide;
};

__host__ inline Tile tile_plan(int m, int k) {
  const int narrow = k >= kPiece ? 1 : kPiece / k;
  if ((m + narrow - 1) / narrow < kSplitBlocks) return Tile{narrow, 0};
  return Tile{k >= kMaxRows ? 1 : kMaxRows / k, 1};
}

struct Args {
  const float* grouped;   // (M, K, Cin)
  const uint8_t* valid;   // (M, K)
  const float *w1, *b1, *w2, *b2, *w3, *b3;
  int m, k, cin, h1, h2, cout, tm;
  float* out;             // (M, Cout)
};

template <int kCin, int kH1, int kH2, int kCout, int kR, bool kBf16>
__global__ void __launch_bounds__(kThreads) sa_mlp_pool_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cin = kCin ? kCin : a.cin;
  const int h1 = kH1 ? kH1 : a.h1;
  const int h2 = kH2 ? kH2 : a.h2;
  const int cout = kCout ? kCout : a.cout;
  const int m0 = blockIdx.x * a.tm;
  const int rows = (a.m - m0 < a.tm ? a.m - m0 : a.tm) * a.k;
  const Layout l = layout(a.tm * a.k, cin, h1, h2, cout);
  const float* g = a.grouped + static_cast<int64_t>(m0) * a.k * cin;

  stage<false>(smem + l.x, g, rows * cin);
  stage<false>(smem + l.w1, a.w1, cin * h1);
  stage<false>(smem + l.b1, a.b1, h1);
  cp_commit();
  stage<false>(smem + l.w2, a.w2, h1 * h2);
  stage<false>(smem + l.b2, a.b2, h2);
  cp_commit();
  stage<false>(smem + l.w3, a.w3, h2 * cout);
  stage<false>(smem + l.b3, a.b3, cout);
  cp_commit();

  cp_wait<2>();
  if (kBf16) {
    stage<true>(smem + l.x, g, rows * cin);
    stage<true>(smem + l.w1, a.w1, cin * h1);
  }
  __syncthreads();
  dense<kCin, kH1, kR, kBf16>(smem + l.x, cin, cin, smem + l.w1,
                              smem + l.b1, h1, smem + l.a1, l.ld1, rows);
  cp_wait<1>();
  if (kBf16) stage<true>(smem + l.w2, a.w2, h1 * h2);
  __syncthreads();
  dense<kH1, kH2, kR, kBf16>(smem + l.a1, l.ld1, h1, smem + l.w2,
                             smem + l.b2, h2, smem + l.x, l.ld2, rows);
  cp_wait<0>();
  if (kBf16) stage<true>(smem + l.w3, a.w3, h2 * cout);
  __syncthreads();
  pool<kH2, kCout, kR>(smem + l.x, l.ld2, h2, smem + l.w3, smem + l.b3, cout,
                   a.valid + static_cast<int64_t>(m0) * a.k, a.k, rows,
                   a.out + static_cast<int64_t>(m0) * cout);
}

template <int kCin, int kH1, int kH2, int kCout, int kR, bool kBf16>
cudaError_t launch(const Args& a, size_t bytes, cudaStream_t stream) {
  auto* kernel = sa_mlp_pool_kernel<kCin, kH1, kH2, kCout, kR, kBf16>;
  static int ready_on = -1;  // the device whose shared-memory limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != ready_on) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlock);
    if (err != cudaSuccess) return err;
    ready_on = dev;
  }
  kernel<<<(a.m + a.tm - 1) / a.tm, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int kCin, int kH1, int kH2, int kCout>
cudaError_t widths(const Args& a, bool wide, bool bf16, size_t bytes,
                   cudaStream_t s) {
  if (wide) {
    return bf16 ? launch<kCin, kH1, kH2, kCout, kWideRows, true>(a, bytes, s)
                : launch<kCin, kH1, kH2, kCout, kWideRows, false>(a, bytes, s);
  }
  return bf16 ? launch<kCin, kH1, kH2, kCout, 1, true>(a, bytes, s)
              : launch<kCin, kH1, kH2, kCout, 1, false>(a, bytes, s);
}

cudaError_t dispatch(const Args& a, bool wide, bool bf16, size_t bytes,
                     cudaStream_t s) {
  if (a.cin == 3 && a.h1 == 32 && a.h2 == 32 && a.cout == 64) {
    return widths<3, 32, 32, 64>(a, wide, bf16, bytes, s);
  }
  if (a.cin == 67 && a.h1 == 64 && a.h2 == 64 && a.cout == 128) {
    return widths<67, 64, 64, 128>(a, wide, bf16, bytes, s);
  }
  return widths<0, 0, 0, 0>(a, wide, bf16, bytes, s);
}

}  // namespace

// Widths the kernel takes: K <= 128 neighbours, H1, H2 and Cout multiples of
// 8, and a tile whose layout fits the block's shared memory (the plan is
// mirrored by ops/cuda/pointnet.py::sa_plan). Anything else returns
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
  const Tile tile = tile_plan(m, k);
  const int tm = tile.centroids;
  const size_t bytes =
      static_cast<size_t>(layout(tm * k, cin, h1, h2, cout).floats) * 4;
  if (bytes > static_cast<size_t>(kSmemPerBlock)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(grouped),
               static_cast<const uint8_t*>(valid),
               static_cast<const float*>(w1), static_cast<const float*>(b1),
               static_cast<const float*>(w2), static_cast<const float*>(b2),
               static_cast<const float*>(w3), static_cast<const float*>(b3),
               m, k, cin, h1, h2, cout, tm, static_cast<float*>(out)};
  return static_cast<int>(dispatch(a, tile.wide, bf16 != 0, bytes,
                                   static_cast<cudaStream_t>(stream)));
}
