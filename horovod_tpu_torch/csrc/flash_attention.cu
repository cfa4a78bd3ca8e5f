// Flash-attention forward for Hopper (sm_90a): O and the row logsumexp.
//
// Replaces horovod_tpu/ops/pallas_attention.py::_fwd_kernel.  Same
// arithmetic: q is upcast to f32 and scaled, scores are f32 dot products,
// masked entries take -1e30, and the streaming softmax keeps a running
// max m, numerator and denominator with the exp(s - m_new) and
// exp(m - m_new) corrections; O = num / den in the input type and
// lse = m + log(den) in f32.
//
// What bounds it: at GPT-medium (B*H = 128, T = 1024, D = 64, causal, bf16)
// it moves 68 MB and does 17 GFLOP, about 254 operations a byte, just
// under the card's bf16 balance point (~295): on the tensor cores the two
// bounds are close (0.020 ms for the bytes, 0.017 ms for the operations).
// This first version does its products in f32 on the CUDA cores, whose
// 67 TFLOP/s put its own floor near 0.26 ms: operations bound it.  Its
// design is the simple one: one CUDA block per
// (batch*head, 64-query tile), one thread per query row holding its
// scaled q and its f32 accumulator in registers, and K/V tiles of 32 keys
// staged through shared memory as f32, where every thread of a warp reads
// the same element (a broadcast).  Causal key tiles past the query tile
// are skipped.  Scores never reach device memory.  wgmma and TMA are
// later work.
//
// Plain C entry point, loaded with ctypes.  It launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// q [bh, tq, D], k/v [bh, tk, D] -> o [bh, tq, D], lse [bh, tq].
template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          int tq, int tk, float scale, int causal) {
  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];
  __shared__ float ss[kBlockQ][kBlockK + 1];  // +1: no bank conflicts

  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int row = q0 + tid;
  const bool live = row < tq;
  const T* kb = k + bh * tk * D;
  const T* vb = v + bh * tk * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_f32(q[(bh * tq + row) * D + d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float den = 0.f;

  int n_tiles = (tk + kBlockK - 1) / kBlockK;
  if (causal) {
    // Tiles whose first key is past the tile's last query add nothing.
    const int last = (q0 + kBlockQ - 1) / kBlockK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    const int kn = tk - k0 < kBlockK ? tk - k0 : kBlockK;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBlockK * D; i += kBlockQ) {
      const int j = i / D;
      const int d = i - j * D;
      const bool ok = j < kn;
      ks[j][d] = ok ? to_f32(kb[static_cast<int64_t>(k0 + j) * D + d]) : 0.f;
      vs[j][d] = ok ? to_f32(vb[static_cast<int64_t>(k0 + j) * D + d]) : 0.f;
    }
    __syncthreads();

    float m_new = m;
    for (int j = 0; j < kn; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j][d], s);
      if (causal && k0 + j > row) s = kNegInf;
      ss[tid][j] = s;
      m_new = fmaxf(m_new, s);
    }
    const float corr = expf(m - m_new);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
    float l = 0.f;
    for (int j = 0; j < kn; ++j) {
      const float p = expf(ss[tid][j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    den = den * corr + l;
    m = m_new;
  }

  if (live) {
    T* orow = o + (bh * tq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f32<T>(acc[d] / den);
    lse[bh * tq + row] = m + logf(den);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int tq, int tk, int d, float scale, int causal,
           cudaStream_t stream) {
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, bh);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  float* lp = static_cast<float*>(lse);
  switch (d) {
    case 16:
      flash_fwd<T, 16><<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, lp, tq,
                                                     tk, scale, causal);
      break;
    case 32:
      flash_fwd<T, 32><<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, lp, tq,
                                                     tk, scale, causal);
      break;
    case 64:
      flash_fwd<T, 64><<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, lp, tq,
                                                     tk, scale, causal);
      break;
    case 128:
      flash_fwd<T, 128><<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, lp, tq,
                                                      tk, scale, causal);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16: 1 for bfloat16 inputs and output, 0 for float32.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk, int d,
                             float scale, int causal, int is_bf16,
                             void* stream) {
  if (bh == 0 || tq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d, scale,
                                 causal, st);
  return launch<float>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, st);
}
