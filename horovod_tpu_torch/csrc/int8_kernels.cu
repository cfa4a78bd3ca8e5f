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
// card's balance point.  What each design does about it:
//
// - quantize_rows: one CUDA block per row of b <= 1024 elements, which
//   reduces the row's absmax in shared memory, neighbouring threads on
//   neighbouring addresses.
// - Dequantize (B4) and dequantize-accumulate (B3) have two routes each,
//   chosen by the wrapper from the block size and the pointers
//   (int8_kernels._dequant_route):
//   * vector (dequantize_rows_vec4, dequantize_accumulate_vec4): a thread
//     owns groups of 4 elements, a 4-byte char4 load (per contributor)
//     and a 16-byte float4 store.  Neighbouring threads take
//     neighbouring groups, so a warp loads 128 contiguous bytes and
//     stores 512, every sector whole.  A thread issues all its loads
//     (B4: kGroups groups; B3: one group's bytes and scales of up to 8
//     contributors, unrolled) before its first store or add, so many
//     bytes are in flight per thread.  The grid is flat over the
//     output's rows * b / 4 groups; a group's row (for its scale) comes
//     from an exact multiply-high division.  It needs b % 4 == 0 (a
//     group never straddles two rows), q 4-byte and out 16-byte aligned,
//     and fewer than 2^31 groups.
//   * scalar (dequantize_rows, dequantize_accumulate_rows): one element a
//     thread on a (rows, ceil(b / 256)) grid.  It takes what the vector
//     route cannot: any b on the wire (a ragged bucket, a small leaf) and
//     views that start inside a buffer at any byte.
//   Both routes compute every element with the same rounded operations
//   in the same order, so they give the same bits.
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
// Threads a block of the vector routes (128 measured a few percent
// faster than 256 or 512 for B3 on the H100), and groups of 4 elements a
// thread of the vector dequantize owns.
constexpr int kVecThreads = 128;
constexpr int kGroups = 4;

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

// n / d for every n < 2^31 and a divisor d >= 1 fixed at launch, as a
// multiply-high, an add and a shift (Granlund and Montgomery's round-up
// method): shift = ceil(log2 d), m = 2^32 (2^shift - d) / d + 1.
struct FastDiv {
  uint32_t m;
  uint32_t shift;

  __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
    return (__umulhi(n, m) + n) >> shift;
  }
};

FastDiv make_fastdiv(uint32_t d) {
  uint32_t shift = 0;
  while ((uint64_t{1} << shift) < d) ++shift;
  const uint64_t m =
      ((uint64_t{1} << 32) * ((uint64_t{1} << shift) - d)) / d + 1;
  return FastDiv{static_cast<uint32_t>(m), shift};
}

__device__ __forceinline__ float4 scaled(char4 v, float s) {
  return make_float4(__fmul_rn(static_cast<float>(v.x), s),
                     __fmul_rn(static_cast<float>(v.y), s),
                     __fmul_rn(static_cast<float>(v.z), s),
                     __fmul_rn(static_cast<float>(v.w), s));
}

__device__ __forceinline__ void accumulate(float4& acc, char4 v, float s) {
  const float4 p = scaled(v, s);
  acc.x = __fadd_rn(acc.x, p.x);
  acc.y = __fadd_rn(acc.y, p.y);
  acc.z = __fadd_rn(acc.z, p.z);
  acc.w = __fadd_rn(acc.w, p.w);
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

// Scalar route.  Grid (rows, ceil(b / kThreads)), one element a thread:
// out[row, i] = q[row, i] * s[row].
__global__ void __launch_bounds__(kThreads)
dequantize_rows(const int8_t* __restrict__ q, const float* __restrict__ s,
                float* __restrict__ out, int b) {
  const int64_t row = blockIdx.x;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i < b)
    out[row * b + i] = __fmul_rn(static_cast<float>(q[row * b + i]), s[row]);
}

// Vector route.  Flat grid over `groups` groups of 4 elements, kGroups a
// thread, kVecThreads apart: every load, then every store.  per_row divides
// a group index by b / 4, giving the group's row.
__global__ void __launch_bounds__(kVecThreads)
dequantize_rows_vec4(const char4* __restrict__ q, const float* __restrict__ s,
                     float4* __restrict__ out, int64_t groups,
                     FastDiv per_row) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * (kVecThreads * kGroups) + threadIdx.x;
  char4 v[kGroups];
  float sc[kGroups];
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    const int64_t g = base + u * kVecThreads;
    if (g < groups) {
      v[u] = q[g];
      sc[u] = s[per_row(static_cast<uint32_t>(g))];
    }
  }
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    const int64_t g = base + u * kVecThreads;
    if (g < groups) out[g] = scaled(v[u], sc[u]);
  }
}

// Scalar route.  q [n, m, b], s [n, m] -> out [m, b]; grid (m, ceil(b /
// kThreads)), one element a thread: the f32 sum over contributors, taken
// one by one in rank order from 0.0f.  Only that order matches the
// reference's jnp.sum(axis=0) bit for bit.
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

// Adds contributors c0 .. c0 + C - 1 of group g (row `row`) to acc in
// rank order: every load of the chunk first, then the adds.
template <int C>
__device__ __forceinline__ void accumulate_chunk(
    float4& acc, const char4* __restrict__ q, const float* __restrict__ s,
    int c0, int64_t m, int64_t groups, int64_t g, int64_t row) {
  char4 v[C];
  float sc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    v[j] = q[(c0 + j) * groups + g];
    sc[j] = s[(c0 + j) * m + row];
  }
#pragma unroll
  for (int j = 0; j < C; ++j) accumulate(acc, v[j], sc[j]);
}

// Vector route of the accumulate.  Contributor c's group g is
// q[c * groups + g] (q is [n, m, b] as groups of 4), its scale
// s[c * m + row].  A thread owns one group and takes the contributors in
// chunks of 8 while 8 remain, then one chunk each of 4, 2 and 1 for the
// rest: no load waits on a predicate, and a world of up to 8 ranks has
// all its loads in flight at once (a predicate on a runtime n in front
// of every load made n = 8 40% slower on the H100).  Each of the four
// sums runs in rank order from 0.0f, as in the scalar route.
__global__ void __launch_bounds__(kVecThreads)
dequantize_accumulate_vec4(const char4* __restrict__ q,
                           const float* __restrict__ s,
                           float4* __restrict__ out, int n, int64_t m,
                           int64_t groups, FastDiv per_row) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kVecThreads +
                    threadIdx.x;
  if (g >= groups) return;
  const int64_t row = per_row(static_cast<uint32_t>(g));
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int c0 = 0;
  for (; c0 + 8 <= n; c0 += 8)
    accumulate_chunk<8>(acc, q, s, c0, m, groups, g, row);
  if (n - c0 >= 4) {
    accumulate_chunk<4>(acc, q, s, c0, m, groups, g, row);
    c0 += 4;
  }
  if (n - c0 >= 2) {
    accumulate_chunk<2>(acc, q, s, c0, m, groups, g, row);
    c0 += 2;
  }
  if (n - c0 >= 1) accumulate_chunk<1>(acc, q, s, c0, m, groups, g, row);
  out[g] = acc;
}

dim3 col_grid(int64_t rows, int b) {
  return dim3(static_cast<unsigned int>(rows), (b + kThreads - 1) / kThreads);
}

unsigned int flat_grid(int64_t groups, int per_thread) {
  const int64_t per_block = int64_t{kVecThreads} * per_thread;
  return static_cast<unsigned int>((groups + per_block - 1) / per_block);
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

// vector != 0 takes the vector route, else the scalar one.  The wrapper
// (int8_kernels._dequant_route) owns that choice and passes vector != 0
// only when b % 4 == 0, q is 4-byte and out 16-byte aligned, and the
// output holds fewer than 2^31 groups of 4 (per_row divides in 32 bits);
// nothing here checks it again.
extern "C" int hvd_dequantize_blocks(const void* q, const void* s, void* out,
                                     int64_t rows, int b, int vector,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || b <= 0) return static_cast<int>(cudaGetLastError());
  if (vector) {
    const int64_t groups = rows * (b / 4);
    dequantize_rows_vec4<<<flat_grid(groups, kGroups), kVecThreads, 0, st>>>(
        static_cast<const char4*>(q), static_cast<const float*>(s),
        static_cast<float4*>(out), groups, make_fastdiv(b / 4));
  } else {
    dequantize_rows<<<col_grid(rows, b), kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<float*>(out), b);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvd_dequantize_accumulate(const void* q, const void* s,
                                         void* out, int n, int64_t m, int b,
                                         int vector, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || b <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (vector) {
    const int64_t groups = m * (b / 4);
    dequantize_accumulate_vec4<<<flat_grid(groups, 1), kVecThreads, 0, st>>>(
        static_cast<const char4*>(q), static_cast<const float*>(s),
        static_cast<float4*>(out), n, m, groups, make_fastdiv(b / 4));
  } else {
    dequantize_accumulate_rows<<<col_grid(m, b), kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<float*>(out), n, m, b);
  }
  return static_cast<int>(cudaGetLastError());
}
