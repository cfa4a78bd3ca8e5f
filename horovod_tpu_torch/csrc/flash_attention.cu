// Flash-attention forward for Hopper (sm_90a): O and the row logsumexp.
//
// Replaces horovod_tpu/ops/pallas_attention.py::_fwd_kernel.  Same
// algorithm: scores are f32 dot products of q and k, masked entries drop
// out of the softmax, and the streaming softmax keeps a running max m,
// numerator and denominator with the exp(s - m_new) and exp(m - m_new)
// corrections; O = num / den in the input type and lse = m + log(den) in
// f32.  Two kernels, chosen by the input type:
//
// flash_fwd_wgmma, bf16 inputs (the GPT step).  What bounds it: at
// GPT-medium (B*H = 128, T = 1024, D = 64, causal) it moves 68 MB and does
// 17 GFLOP, about 254 operations a byte, just under the card's bf16
// balance point (~295): the bytes bound (0.020 ms) and the operations
// bound (0.017 ms) are close.  Design: one CTA per (batch*head, 128 query
// rows), launched heaviest causal tile first; two consumer warpgroups of
// 64 rows and one producer warp.  The producer brings Q once and K/V tiles
// of 128 keys (64 at D = 128) by TMA into a two-stage ring guarded by
// mbarriers.  Each consumer computes S = Q K^T with wgmma from shared
// memory (bf16 products are exact in f32), masks by index where a tile
// crosses the causal diagonal or the ragged end of the keys (TMA fills
// out-of-range rows with zeros, which would score 0), updates the running
// max and the f32 denominator, rounds P to bf16 in registers and adds
// P V with wgmma, P as the register operand.  Rounding P to bf16 is the one
// change of function against the reference, which keeps P in f32: this
// kernel holds the bf16 limits (O within 3e-2 absolute and 1e-2 of the
// row's largest |O|, lse within 1e-4), the tolerance of the reference's
// own bf16 attention tests.  The scale is applied to S in f32 (folded with
// log2(e) into exp2); the reference scales q first, which for D = 64
// (scale 2^-3) is the same number and otherwise one f32 rounding away.
// Key tiles past the query tile are skipped, and a warpgroup skips the
// tiles that lie wholly past its own rows.  Scores never reach device
// memory; tail query rows are not stored.
//
// flash_fwd, f32 inputs: the first port's kernel, kept because the f32
// tolerance (2e-5) is beyond bf16 tensor cores.  One thread per query row
// with its scaled q and f32 accumulator in registers, K/V tiles of 32
// keys staged through shared memory as f32, f32 FMAs on the CUDA cores
// (67 TFLOP/s): operations bound it.
//
// Plain C entry point, loaded with ctypes.  It launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr float kNegInf = -1e30f;

// f32: q [bh, tq, D], k/v [bh, tk, D] -> o [bh, tq, D], lse [bh, tq].
template <int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int tq, int tk, float scale, int causal) {
  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];
  __shared__ float ss[kBlockQ][kBlockK + 1];  // +1: no bank conflicts

  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int row = q0 + tid;
  const bool live = row < tq;
  const float* kb = k + bh * tk * D;
  const float* vb = v + bh * tk * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? q[(bh * tq + row) * D + d] * scale : 0.f;
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
      ks[j][d] = ok ? kb[static_cast<int64_t>(k0 + j) * D + d] : 0.f;
      vs[j][d] = ok ? vb[static_cast<int64_t>(k0 + j) * D + d] : 0.f;
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
    float* orow = o + (bh * tq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / den;
    lse[bh * tq + row] = m + logf(den);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int tq, int tk, int d, float scale,
               int causal, cudaStream_t stream) {
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, bh);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  float* lp = static_cast<float*>(lse);
  switch (d) {
    case 16:
      flash_fwd<16><<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, lp, tq, tk,
                                                  scale, causal);
      break;
    case 32:
      flash_fwd<32><<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, lp, tq, tk,
                                                  scale, causal);
      break;
    case 64:
      flash_fwd<64><<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, lp, tq, tk,
                                                  scale, causal);
      break;
    case 128:
      flash_fwd<128><<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, lp, tq, tk,
                                                   scale, causal);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: wgmma and TMA ---------------------------------------------------

constexpr int kTcRows = 128;     // query rows of a CTA: two warpgroups of 64
constexpr int kTcThreads = 288;  // two consumer warpgroups + a producer warp
constexpr int kTcStages = 2;     // K/V tiles in flight

template <int D>
struct TcShape {
  static constexpr int kBN = D == 128 ? 64 : 128;        // keys a tile
  static constexpr int kSwizzle = D >= 64 ? 128 : 2 * D;  // bytes an atom row
  static constexpr int kAtomCols = kSwizzle / 2;          // bf16 an atom row
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kSteps = kAtomCols / 16;           // k16 steps an atom
  static constexpr int kQBytes = kTcRows * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;
  static constexpr int kTileBytes = kQBytes + kTcStages * 2 * kKVBytes;
  // tiles, their 1024-byte alignment, then 1 + 2 * kTcStages barriers
  static constexpr int kSmem = kTileBytes + 1024 + 8 * (1 + 2 * kTcStages);
};

template <int N>
__device__ __forceinline__ void mma_qk(float (&s)[N / 2], uint64_t a,
                                       uint64_t b, int acc);
template <>
__device__ __forceinline__ void mma_qk<64>(float (&s)[32], uint64_t a,
                                           uint64_t b, int acc) {
  hopper::wgmma_ss_n64<0>(s, a, b, acc);
}
template <>
__device__ __forceinline__ void mma_qk<128>(float (&s)[64], uint64_t a,
                                            uint64_t b, int acc) {
  hopper::wgmma_ss_n128<0>(s, a, b, acc);
}

template <int N>
__device__ __forceinline__ void mma_pv(float (&o)[N / 2], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t b);
template <>
__device__ __forceinline__ void mma_pv<16>(float (&o)[8], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t b) {
  hopper::wgmma_rs_n16<1>(o, a0, a1, a2, a3, b, 1);
}
template <>
__device__ __forceinline__ void mma_pv<32>(float (&o)[16], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t b) {
  hopper::wgmma_rs_n32<1>(o, a0, a1, a2, a3, b, 1);
}
template <>
__device__ __forceinline__ void mma_pv<64>(float (&o)[32], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t b) {
  hopper::wgmma_rs_n64<1>(o, a0, a1, a2, a3, b, 1);
}
template <>
__device__ __forceinline__ void mma_pv<128>(float (&o)[64], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t b) {
  hopper::wgmma_rs_n128<1>(o, a0, a1, a2, a3, b, 1);
}

// q, k, v through tensor maps over [bh, t, D] bf16 -> o [bh, tq, D] bf16,
// lse [bh, tq] f32.  Grid (bh, query tiles).
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int tq, int tk, float scale, int causal) {
  using S = TcShape<D>;
  constexpr int BN = S::kBN;
  constexpr int SW = S::kSwizzle;
  extern __shared__ char smem_raw[];
  char* const qs = hopper::aligned_smem(smem_raw);
  char* const kv = qs + S::kQBytes;  // stage s: K at 2s, V at 2s + 1
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(qs + S::kTileBytes);
  uint64_t* const full = q_full + 1;
  uint64_t* const empty = full + kTcStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heaviest first
  int n_tiles = (tk + BN - 1) / BN;
  if (causal) {
    // Key tiles whose first key is past the CTA's last query add nothing.
    const int last = min(q0 + kTcRows, tq) - 1;
    n_tiles = min(n_tiles, last / BN + 1);
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 8) {  // producer: one thread issues every copy
    if (threadIdx.x % 32 == 0) {
      hopper::mbar_arrive_expect_tx(q_full, S::kQBytes);
      for (int a = 0; a < S::kAtoms; ++a)
        hopper::tma_load_3d(qs + a * kTcRows * SW, &qmap, q_full,
                            a * S::kAtomCols, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kTcStages;
        hopper::mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * S::kKVBytes);
        char* const ks = kv + (2 * s) * S::kKVBytes;
        char* const vs = ks + S::kKVBytes;
        for (int a = 0; a < S::kAtoms; ++a) {
          hopper::tma_load_3d(ks + a * BN * SW, &kmap, &full[s],
                              a * S::kAtomCols, it * BN, bh);
          hopper::tma_load_3d(vs + a * BN * SW, &vmap, &full[s],
                              a * S::kAtomCols, it * BN, bh);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup g owns query rows row0 .. row0 + 63.
  const int g = warp / 4;
  const int t = threadIdx.x % 128;
  const int row0 = q0 + g * 64;
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
  float o_acc[D / 2];
  float s_acc[BN / 2];
  uint32_t p_bf[BN / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s_acc[i] = 0.f;
  // This thread's two rows (r and r + 8): running max of the raw scores
  // and its share of the f32 denominator.
  float m_run[2] = {-INFINITY, -INFINITY};
  float den[2] = {0.f, 0.f};

  hopper::mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kTcStages;
    const int k0 = it * BN;
    hopper::mbar_wait(&full[s], (it / kTcStages) & 1);
    if (!(causal && k0 > row0 + 63)) {
      const char* const ks = kv + (2 * s) * S::kKVBytes;
      const char* const vs = ks + S::kKVBytes;

      // S = Q K^T, both K-major.
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a = kk / S::kSteps, step = kk % S::kSteps;
        const uint64_t qd = hopper::smem_desc(
            qs + a * kTcRows * SW + g * 64 * SW + step * 32, 16, 8 * SW, SW);
        const uint64_t kd = hopper::smem_desc(ks + a * BN * SW + step * 32,
                                              16, 8 * SW, SW);
        mma_qk<BN>(s_acc, qd, kd, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s_acc);

      if ((causal && k0 + BN - 1 > row0) || k0 + BN > tk) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int r = row0 + hopper::acc_row(t, i);
          const int c = k0 + hopper::acc_col(t, i);
          if (c >= tk || (causal && c > r)) s_acc[i] = -INFINITY;
        }
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s_acc[i]);
      float corr[2], ms[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // The four threads of a quad hold one row's columns.
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 2));
        corr[h] = m_run[h] == mx[h] ? 1.f : exp2f((m_run[h] - mx[h]) * sl2);
        ms[h] = mx[h] == -INFINITY ? 0.f : mx[h] * sl2;
        m_run[h] = mx[h];
        den[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1;
        s_acc[i] = exp2f(fmaf(s_acc[i], sl2, -ms[h]));
        den[h] += s_acc[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int j = 0; j < BN / 4; ++j)
        p_bf[j] = hopper::pack_bf16(s_acc[2 * j], s_acc[2 * j + 1]);

      // O += P V: P from registers, V N-major (D contiguous).
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        const uint64_t vd =
            hopper::smem_desc(vs + c * 16 * SW, BN * SW, 8 * SW, SW);
        mma_pv<D>(o_acc, p_bf[4 * c], p_bf[4 * c + 1], p_bf[4 * c + 2],
                  p_bf[4 * c + 3], vd);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(o_acc);
      hopper::fence_regs(p_bf);
    }
    hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffff, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffff, den[h], 2);
  }
  const int64_t base = static_cast<int64_t>(bh) * tq;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = row0 + hopper::acc_row(t, i);
    if (r < tq) {
      const float dr = den[(i >> 1) & 1];
      const uint32_t pair = hopper::pack_bf16(o_acc[i] / dr, o_acc[i + 1] / dr);
      *reinterpret_cast<uint32_t*>(o + (base + r) * D + hopper::acc_col(t, i)) =
          pair;
    }
  }
  if (t % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + hopper::acc_row(t, 2 * h);
      if (r < tq) lse[base + r] = m_run[h] * scale + logf(den[h]);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int tq, int tk, float scale, int causal,
                 cudaStream_t stream) {
  using S = TcShape<D>;
  CUtensorMap qm, km, vm;
  int rc = hopper::make_tensor_map(&qm, q, D, tq, bh, D * 2,
                                   static_cast<uint64_t>(tq) * D * 2,
                                   S::kAtomCols, kTcRows, S::kSwizzle);
  if (rc == 0)
    rc = hopper::make_tensor_map(&km, k, D, tk, bh, D * 2,
                                 static_cast<uint64_t>(tk) * D * 2,
                                 S::kAtomCols, S::kBN, S::kSwizzle);
  if (rc == 0)
    rc = hopper::make_tensor_map(&vm, v, D, tk, bh, D * 2,
                                 static_cast<uint64_t>(tk) * D * 2,
                                 S::kAtomCols, S::kBN, S::kSwizzle);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem));
  if (rc != 0) return rc;
  const dim3 grid(bh, (tq + kTcRows - 1) / kTcRows);
  flash_fwd_wgmma<D><<<grid, kTcThreads, S::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      tq, tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int tq, int tk, int d, float scale,
                int causal, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_wgmma<16>(q, k, v, o, lse, bh, tq, tk, scale, causal,
                              stream);
    case 32:
      return launch_wgmma<32>(q, k, v, o, lse, bh, tq, tk, scale, causal,
                              stream);
    case 64:
      return launch_wgmma<64>(q, k, v, o, lse, bh, tq, tk, scale, causal,
                              stream);
    case 128:
      return launch_wgmma<128>(q, k, v, o, lse, bh, tq, tk, scale, causal,
                               stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// is_bf16: 1 for bfloat16 inputs and output (the wgmma kernel), 0 for
// float32 (the CUDA-core kernel).
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk, int d,
                             float scale, int causal, int is_bf16,
                             void* stream) {
  if (bh == 0 || tq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(q, k, v, o, lse, bh, tq, tk, d, scale, causal, st);
  return launch_f32(q, k, v, o, lse, bh, tq, tk, d, scale, causal, st);
}
