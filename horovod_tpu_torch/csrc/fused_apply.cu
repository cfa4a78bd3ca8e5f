// The sharded optimizer's fused all-gather + apply kernels for Hopper
// (sm_90a): dequantize the gathered int8 gradient and apply the SGD or
// the Adam leaf update in one pass.
//
// Replaces horovod_tpu/ops/pallas_collectives.py::_sgd_kernel and
// ::_adam_kernel (both launched through _apply_gridded).  The gradient
// must dequantize to the same bits as the int8 all-gather's (q * s in
// f32), and each update step must round where the reference rounds, so
// every operation is spelled with an intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn): nvcc never contracts those into an
// FMA.  Do not build with --use_fast_math.  The constants (lr, b1, 1 - b1,
// b2, 1 - b2, eps and the bias corrections) arrive as f32 values that the
// caller computed in double and rounded once, as the reference's Python
// floats are: f32(1 - 0.9) is not 1 - f32(0.9).
//
// Both kernels are bound by device memory: per element, SGD reads 1 B of
// payload and 4 B of parameter and writes 4 B; Adam reads 13 B and writes
// 12 B, with a dozen operations in between.  The reference lays p, mu and
// nu out as padded block rows to walk them beside the payload; here each
// thread indexes the flat leaves directly, so no padded copy is made:
// row r of the gathered payload [n * m, b] is contributor c = r / m's
// block r % m, its element col is leaf element c * k + (r % m) * b + col,
// and a column past k on a contributor's last block is wire padding with
// no leaf element.  Grid (n * m, ceil(b / kThreads)), one element a
// thread, neighbouring threads on neighbouring addresses.
//
// A NaN gradient row has a NaN scale and a 0 payload, so g is NaN and NaN
// flows into p, mu and nu, as in the reference.
//
// Plain C entry points, loaded with ctypes.  Each launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The flat leaf index of element col of gathered row `row`, or -1 where
// that element is wire padding.
__device__ __forceinline__ int64_t leaf_index(int64_t row, int col,
                                              int64_t m, int b, int64_t k) {
  const int64_t c = row / m;
  const int64_t j = (row - c * m) * b + col;
  return (col < b && j < k) ? c * k + j : -1;
}

__device__ __forceinline__ float dequant(const int8_t* q, const float* s,
                                         int64_t row, int col, int b) {
  return __fmul_rn(static_cast<float>(q[row * b + col]), s[row]);
}

// out = p - lr * g
__global__ void __launch_bounds__(kThreads)
sgd_rows(const int8_t* __restrict__ q, const float* __restrict__ s,
         const float* __restrict__ p, float* __restrict__ out, int64_t m,
         int b, int64_t k, float lr) {
  const int64_t row = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  const int64_t i = leaf_index(row, col, m, b, k);
  if (i < 0) return;
  const float g = dequant(q, s, row, col, b);
  out[i] = __fsub_rn(p[i], __fmul_rn(lr, g));
}

struct AdamConsts {
  float lr, b1, one_minus_b1, b2, one_minus_b2, eps, bc1, bc2;
};

// m' = b1 m + (1 - b1) g;  v' = b2 v + (1 - b2) g g;
// p' = p - lr ((m' / bc1) / (sqrt(v' / bc2) + eps))
__global__ void __launch_bounds__(kThreads)
adam_rows(const int8_t* __restrict__ q, const float* __restrict__ s,
          const float* __restrict__ p, const float* __restrict__ mu,
          const float* __restrict__ nu, float* __restrict__ p_out,
          float* __restrict__ mu_out, float* __restrict__ nu_out, int64_t m,
          int b, int64_t k, AdamConsts c) {
  const int64_t row = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  const int64_t i = leaf_index(row, col, m, b, k);
  if (i < 0) return;
  const float g = dequant(q, s, row, col, b);
  const float m_new =
      __fadd_rn(__fmul_rn(c.b1, mu[i]), __fmul_rn(c.one_minus_b1, g));
  const float v_new = __fadd_rn(__fmul_rn(c.b2, nu[i]),
                                __fmul_rn(c.one_minus_b2, __fmul_rn(g, g)));
  const float update =
      __fdiv_rn(__fdiv_rn(m_new, c.bc1),
                __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, c.bc2)), c.eps));
  p_out[i] = __fsub_rn(p[i], __fmul_rn(c.lr, update));
  mu_out[i] = m_new;
  nu_out[i] = v_new;
}

dim3 row_grid(int64_t rows, int b) {
  return dim3(static_cast<unsigned int>(rows), (b + kThreads - 1) / kThreads);
}

}  // namespace

// q [n * m, b] int8, s [n * m] f32, p and out [n * k] f32.
extern "C" int hvd_sgd_apply(const void* q, const void* s, const void* p,
                             void* out, int64_t rows, int64_t m, int b,
                             int64_t k, float lr, void* stream) {
  if (rows > 0)
    sgd_rows<<<row_grid(rows, b), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<const float*>(p), static_cast<float*>(out), m, b, k, lr);
  return static_cast<int>(cudaGetLastError());
}

// As hvd_sgd_apply, with mu, nu and the three outputs all [n * k] f32.
extern "C" int hvd_adam_apply(const void* q, const void* s, const void* p,
                              const void* mu, const void* nu, void* p_out,
                              void* mu_out, void* nu_out, int64_t rows,
                              int64_t m, int b, int64_t k, float lr, float b1,
                              float one_minus_b1, float b2, float one_minus_b2,
                              float eps, float bc1, float bc2, void* stream) {
  const AdamConsts c{lr, b1, one_minus_b1, b2, one_minus_b2, eps, bc1, bc2};
  if (rows > 0)
    adam_rows<<<row_grid(rows, b), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<const float*>(p), static_cast<const float*>(mu),
        static_cast<const float*>(nu), static_cast<float*>(p_out),
        static_cast<float*>(mu_out), static_cast<float*>(nu_out), m, b, k, c);
  return static_cast<int>(cudaGetLastError());
}
