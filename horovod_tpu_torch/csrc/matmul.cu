// The FSDP unshard epilogue's product for Hopper (sm_90a):
// y[M, N] = x[M, K] @ w[K, N], both operands upcast to f32, the sum over
// K taken in f32, y written in x's type (f32 or bf16).
//
// Replaces horovod_tpu/ops/pallas_collectives.py::_matmul_kernel, whose
// output tile feeds the activation all-gather of fused_matmul_allgather.
// The TPU kernel walks K in panels of 512 along a sequential grid axis and
// carries the f32 sum in scratch; here each CUDA block owns one 128 x 128
// output tile and loops over K inside the block, the sum held in
// registers.
//
// Operations bound it (2 M N K of them, against M K + K N + M N elements
// moved once).  This version runs them on the CUDA cores in f32, which is
// the function the reference computes: TF32 or bf16 tensor cores would
// compute a lower-precision one.  Design: 256 threads, each owning an 8 x 8
// grid of outputs strided by 16 rows and 16 columns (so a warp's shared
// memory reads and its stores of y fall on neighbouring addresses);
// K is staged through shared memory 8 deep, converted to f32 on the way
// in.  Ragged M, N and K edges are masked in the loads and the stores, so
// no padded copy of x or w is made.  Tensor cores in f32-faithful form
// (3xTF32 splitting), wider loads and double buffering are later work.
//
// Plain C entry point, loaded with ctypes: launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;      // output rows and columns of a block
constexpr int kDepth = 8;       // K elements staged per step
constexpr int kSide = 16;       // threads along each side of the tile
constexpr int kPer = kTile / kSide;  // outputs a thread owns along a side

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
matmul_tiles(const TX* __restrict__ x, const TW* __restrict__ w,
             TX* __restrict__ y, int M, int N, int K) {
  __shared__ float xs[kDepth][kTile];   // x tile, transposed
  __shared__ float ws[kDepth][kTile];
  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kDepth) {
    // kTile * kDepth elements of each operand, 4 a thread.
    for (int e = tid; e < kTile * kDepth; e += kThreads) {
      const int r = e / kDepth, kk = e % kDepth;
      const int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < M && gk < K)
                      ? to_f32(x[static_cast<int64_t>(gr) * K + gk]) : 0.f;
    }
    for (int e = tid; e < kTile * kDepth; e += kThreads) {
      const int kk = e / kTile, c = e % kTile;
      const int gk = k0 + kk, gc = col0 + c;
      ws[kk][c] = (gk < K && gc < N)
                      ? to_f32(w[static_cast<int64_t>(gk) * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[kPer], b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = xs[kk][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = ws[kk][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int gr = row0 + ty + kSide * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int gc = col0 + tx + kSide * j;
      if (gc < N) y[static_cast<int64_t>(gr) * N + gc] = from_f32<TX>(acc[i][j]);
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* y, int M, int N, int K,
            cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  matmul_tiles<TX, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), M, N, K);
}

}  // namespace

// x [M, K], w [K, N], y [M, N] in x's type; x_bf16 / w_bf16 say whether
// each operand is bf16 (else f32).
extern "C" int hvd_matmul(const void* x, const void* w, void* y, int M, int N,
                          int K, int x_bf16, int w_bf16, void* stream) {
  if (M > 0 && N > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (x_bf16 && w_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, M, N, K, st);
    else if (x_bf16)
      launch<__nv_bfloat16, float>(x, w, y, M, N, K, st);
    else if (w_bf16)
      launch<float, __nv_bfloat16>(x, w, y, M, N, K, st);
    else
      launch<float, float>(x, w, y, M, N, K, st);
  }
  return static_cast<int>(cudaGetLastError());
}
