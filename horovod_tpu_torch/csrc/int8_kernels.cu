// The int8 wire's three kernels for Hopper (sm_90a): blockwise quantize,
// dequantize, and dequantize-accumulate over contributors.
//
// Replaces horovod_tpu/ops/pallas_collectives.py::_quant_kernel,
// ::_dequant_kernel and ::_dequant_accum_kernel.  The results must be
// bitwise equal to the reference wire (horovod_tpu/ops/quantization.py),
// so every rounding step is spelled out with an intrinsic: __fmul_rn,
// __fdiv_rn and __fadd_rn are never contracted into an FMA and the
// division is correctly rounded.  Do not build with --use_fast_math.
//
// All three are bound by device memory: each element is read once and
// written once with a handful of operations in between, far below the
// card's balance point.  The grids follow the rows of b <= 1024
// elements (quantize: one CUDA block per row, which reduces the row's
// absmax in shared memory; the others: one thread per element), with
// neighbouring threads on neighbouring addresses, so the accesses are
// coalesced and no thread divides an index to find its scale.  Wider
// accesses (16 bytes a thread) are later work.
//
// Non-finite values follow the reference: a NaN anywhere in a row makes
// its absmax and its scale NaN (jnp.max and jnp.maximum carry NaN, where
// fmaxf would drop it), and a payload that is NaN after the division
// becomes 0, as XLA converts NaN to an integer.  Either way the row
// dequantizes to NaN, so a non-finite gradient stays non-finite across
// the wire.
//
// Plain C entry points, loaded with ctypes.  Each launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// np.float32(1 / 127): the scale is absmax * (1/127), a multiply, as in
// quantization._INV127.
constexpr float kInv127 = 0x1.020408p-7f;
constexpr float kEps = 1e-30f;
constexpr int kThreads = 256;

// max that carries NaN from either side, as jnp.max / jnp.maximum.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One CUDA block per row of b elements: absmax, scale, then the int8 row.
__global__ void __launch_bounds__(kThreads)
quantize_rows(const float* __restrict__ x, int8_t* __restrict__ q,
              float* __restrict__ s, int b) {
  __shared__ float part[kThreads / 32];
  const int64_t row = blockIdx.x;
  const float* xr = x + row * b;
  int8_t* qr = q + row * b;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float amax = 0.f;
  for (int i = threadIdx.x; i < b; i += kThreads)
    amax = nan_max(fabsf(xr[i]), amax);
  amax = warp_max(amax);
  if (lane == 0) part[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = lane < kThreads / 32 ? part[lane] : 0.f;
    amax = warp_max(amax);
    if (lane == 0) part[0] = nan_max(__fmul_rn(amax, kInv127), kEps);
  }
  __syncthreads();
  const float scale = part[0];

  for (int i = threadIdx.x; i < b; i += kThreads) {
    // round half to even, as jnp.round.  NaN (from a NaN row, or from
    // Inf / Inf) becomes 0: the clamp's fmaxf alone would make it -127.
    const float r = rintf(__fdiv_rn(xr[i], scale));
    qr[i] = r != r ? int8_t{0}
                   : static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if (threadIdx.x == 0) s[row] = scale;
}

// Grid (rows, ceil(b / kThreads)), one element a thread:
// out[row, i] = q[row, i] * s[row].
__global__ void __launch_bounds__(kThreads)
dequantize_rows(const int8_t* __restrict__ q, const float* __restrict__ s,
                float* __restrict__ out, int b) {
  const int64_t row = blockIdx.x;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i < b)
    out[row * b + i] = __fmul_rn(static_cast<float>(q[row * b + i]), s[row]);
}

// q [n, m, b], s [n, m] -> out [m, b]; grid (m, ceil(b / kThreads)), one
// element a thread: the f32 sum over contributors, taken one by one in
// rank order from 0.0f.  Only that order matches the reference's
// jnp.sum(axis=0) bit for bit.
__global__ void __launch_bounds__(kThreads)
dequantize_accumulate_rows(const int8_t* __restrict__ q,
                           const float* __restrict__ s,
                           float* __restrict__ out, int n, int64_t m, int b) {
  const int64_t row = blockIdx.x;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= b) return;
  float acc = 0.f;
  for (int c = 0; c < n; ++c) {
    const int64_t r = c * m + row;
    acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(q[r * b + i]), s[r]));
  }
  out[row * b + i] = acc;
}

dim3 col_grid(int64_t rows, int b) {
  return dim3(static_cast<unsigned int>(rows), (b + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int hvd_quantize_blocks(const void* x, void* q, void* s,
                                   int64_t rows, int b, void* stream) {
  if (rows > 0)
    quantize_rows<<<static_cast<unsigned int>(rows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(s), b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvd_dequantize_blocks(const void* q, const void* s, void* out,
                                     int64_t rows, int b, void* stream) {
  if (rows > 0)
    dequantize_rows<<<col_grid(rows, b), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<float*>(out), b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvd_dequantize_accumulate(const void* q, const void* s,
                                         void* out, int n, int64_t m, int b,
                                         void* stream) {
  if (m > 0)
    dequantize_accumulate_rows<<<col_grid(m, b), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<float*>(out), n, m, b);
  return static_cast<int>(cudaGetLastError());
}
