// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV from the
// forward's O and row logsumexp, bf16 on the tensor cores and f32 on the
// CUDA cores.
//
// It replaces no TPU kernel: the reference's backward
// (horovod_tpu/ops/pallas_attention.py::_flash_bwd) is plain jnp, and so
// is this kernel's plain version, ops/flash_attention.py::flash_bwd_plain,
// which CPU tensors still take.  It was added because that plain version
// was half of the GPT step: f32 products at the CUDA cores' rate over
// every key block, masked ones included.
//
// What bounds it.  Five products of 2*BH*T*Tk*D operations (S = Q K^T,
// dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K; half when causal)
// against Q, O, dO, dQ (T rows) and K, V, dK, dV (Tk rows) in bf16 plus
// the f32 lse and delta, each moved once.  At the GPT step (BH 256, T 1024,
// D 64, causal) that is 85.9 GFLOP, 86.9 us at 989 TFLOP/s, against 270 MB,
// 80.6 us at 3.35 TB/s: the two are close.  At BERT-Large (BH 2048,
// T = Tk = 128, D 64, non-causal) 21.5 GFLOP against 270 MB: bytes bound
// it, at 80.6 us.
//
// The split contract.  P and dS are never rounded to bf16 alone before the
// products that read them: each enters the tensor cores as a pair of bf16
// values, hi = bf16(x) and lo = bf16(x - hi), as csrc/matmul.cu splits its
// f32 operands, two products summed in the f32 accumulator.  The pair
// carries about 16 bits of mantissa, so the gradients' one rounding beyond
// the plain f32 version's is the bf16 rounding of dQ, dK and dV, which the
// plain version makes too.  This matters because the rows of dS sum to
// zero (sum_k P (dP - delta) = 0): dQ = dS K and dK = dS^T Q are sums that
// cancel, and a dS rounded to 8 bits would show in them.  S and dP are
// products of bf16 inputs, exact in f32.  P is recomputed in f32 as
// exp(S * scale - lse), the scores of masked pairs dropped; delta is
// rowsum(dO * O) - dlse in f32 from the saved bf16 O and dO, as the plain
// version computes it.
//
// Design: three launches and no atomics, so a call repeats bit for bit.
//  1. flash_bwd_delta: delta, 16-byte loads.
//  2. flash_bwd_dkdv: one CTA per (batch*head, 128 keys), two consumer
//     warpgroups of 64 keys and a producer warp.  K and V arrive once by
//     TMA; tiles of 64 queries (Q, dO, and their lse and delta) stream
//     through a two-stage ring.  Keys are the rows of every product: S^T =
//     K Q^T and dP^T = V dO^T with wgmma from shared memory, then P^T and
//     dS^T in registers become the A operands of dV += P^T dO and dK +=
//     dS^T Q (hi and lo each).  Causal: only the query tiles at or after
//     the key tile, the index mask only on tiles that cross the diagonal
//     or the ragged end.  The key tiles with the most query tiles launch
//     first.
//  3. flash_bwd_dq: one CTA per (batch*head, 128 queries), the forward's
//     layout: S = Q K^T and dP = dO V^T per key tile (64 keys, 128 at
//     D = 16), dQ += dS K with dS hi and lo from registers.  Causal: only
//     the key tiles at or before the diagonal, heaviest query tile first.
// Outputs are written once, in bf16; the only scratch is delta [BH, T].
//
// f32 inputs (flash_bwd_f32_delta, _dkdv, _dq): the same three passes on
// the CUDA cores, as the forward's f32 kernel, because the f32 limits are
// beyond bf16 tensor cores.  A row is held by D / 16 lanes of a warp, 16
// columns each, its dot products summed across them by shuffles; the
// streamed operand's tiles of 32 rows sit in shared memory.  Every product
// is an f32 FMA (67 TFLOP/s): operations bound it.
//
// Plain C entry point, loaded with ctypes.  It launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 288;  // two consumer warpgroups + a producer warp
constexpr int kStages = 2;     // tiles in flight
constexpr int kKeyRows = 128;  // dK/dV pass: keys a CTA
constexpr int kQueryTile = 64; // dK/dV pass: queries a step
constexpr int kQueryRows = 128;  // dQ pass: queries a CTA
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Geo {
  static constexpr int kSwizzle = D >= 64 ? 128 : 2 * D;  // bytes an atom row
  static constexpr int kAtomCols = kSwizzle / 2;          // bf16 an atom row
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kSteps = kAtomCols / 16;           // k16 steps an atom
};

// A K-major operand (D contiguous): 64 rows from row r0 of a tile of `rows`
// rows, the kk-th 16 columns.
template <int D>
__device__ __forceinline__ uint64_t kmajor(const char* tile, int rows, int r0,
                                           int kk) {
  using G = Geo<D>;
  const int a = kk / G::kSteps, step = kk % G::kSteps;
  return hopper::smem_desc(
      tile + (a * rows + r0) * G::kSwizzle + step * 32, 16,
      8 * G::kSwizzle, G::kSwizzle);
}

// An N-major B operand (D contiguous, the tile's rows the reduction): the
// c-th 16 rows of a tile of `rows` rows.
template <int D>
__device__ __forceinline__ uint64_t nmajor(const char* tile, int rows, int c) {
  using G = Geo<D>;
  return hopper::smem_desc(tile + c * 16 * G::kSwizzle, rows * G::kSwizzle,
                           8 * G::kSwizzle, G::kSwizzle);
}

// Loads `rows` rows of a [bh, t, D] tensor from row r of head bh, atom by
// atom, counted on `bar`.
template <int D>
__device__ __forceinline__ void load_tile(char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int r,
                                          int bh) {
  using G = Geo<D>;
  for (int a = 0; a < G::kAtoms; ++a)
    hopper::tma_load_3d(dst + a * rows * G::kSwizzle, map, bar,
                        a * G::kAtomCols, r, bh);
}

// S (+)= A B^T with both K-major, M = 64, N = 64 or 128.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int acc);
template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a,
                                           uint64_t b, int acc) {
  hopper::wgmma_ss_n64<0>(d, a, b, acc);
}
template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t a,
                                            uint64_t b, int acc) {
  hopper::wgmma_ss_n128<0>(d, a, b, acc);
}

// d += A B, A a 64 x 16 bf16 tile in registers, B N-major with N = D.
template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2], const uint32_t* a,
                                       uint64_t b);
template <>
__device__ __forceinline__ void mma_rs<16>(float (&d)[8], const uint32_t* a,
                                           uint64_t b) {
  hopper::wgmma_rs_n16<1>(d, a[0], a[1], a[2], a[3], b, 1);
}
template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16], const uint32_t* a,
                                           uint64_t b) {
  hopper::wgmma_rs_n32<1>(d, a[0], a[1], a[2], a[3], b, 1);
}
template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t* a,
                                           uint64_t b) {
  hopper::wgmma_rs_n64<1>(d, a[0], a[1], a[2], a[3], b, 1);
}
template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t* a,
                                            uint64_t b) {
  hopper::wgmma_rs_n128<1>(d, a[0], a[1], a[2], a[3], b, 1);
}

// An accumulator tile of N f32 columns as the A registers of its products:
// each pair of columns once rounded (hi) and its remainder rounded (lo).
template <int N>
__device__ __forceinline__ void split(const float (&x)[N / 2],
                                      uint32_t (&hi)[N / 4],
                                      uint32_t (&lo)[N / 4]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[j] = *reinterpret_cast<uint32_t*>(&h);
    lo[j] = hopper::pack_bf16(x[2 * j] - hf.x, x[2 * j + 1] - hf.y);
  }
}

// Stores a 64 x D accumulator tile as bf16 rows r0.. of out [rows, D],
// rows at or past `rows` left out.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2], int r0,
                                           int rows, int t) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = r0 + hopper::acc_row(t, i);
    if (r < rows)
      *reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(r) * D +
                                   hopper::acc_col(t, i)) =
          hopper::pack_bf16(acc[i], acc[i + 1]);
  }
}

// delta [rows] = rowsum(dO * O) - dlse in f32: d / 8 threads a row, each
// reading 8 bf16 of O and of dO in one 16-byte load.
__global__ void __launch_bounds__(256)
flash_bwd_delta(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ dlse, float* __restrict__ delta,
                int64_t rows, int d) {
  const int per_row = d / 8;  // 2 to 16: a row's threads share a warp
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int64_t row = idx / per_row;
  float acc = 0.f;
  if (row < rows) {
    const int64_t at = row * d + (idx % per_row) * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + at);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* const a2 =
        reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* const b2 =
        reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(a2[j]);
      const float2 y = __bfloat1622float2(b2[j]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  for (int off = per_row / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffff, acc, off);
  if (row < rows && idx % per_row == 0)
    delta[row] = dlse == nullptr ? acc : acc - dlse[row];
}

// ---- dK, dV ---------------------------------------------------------------

template <int D>
struct KvShape {
  static constexpr int kKBytes = kKeyRows * D * 2;    // K or V
  static constexpr int kQBytes = kQueryTile * D * 2;  // Q or dO tile
  static constexpr int kStageBytes = 2 * kQBytes;
  static constexpr int kTileBytes = 2 * kKBytes + kStages * kStageBytes;
  // tiles, then each stage's lse (times log2 e) and delta, then barriers
  static constexpr int kVecFloats = kStages * 2 * kQueryTile;
  static constexpr int kSmem =
      kTileBytes + 4 * kVecFloats + 1024 + 8 * (1 + 2 * kStages);
};

// q, dO through tensor maps over [bh, tq, D] (boxes of 64 rows), k, v over
// [bh, tk, D] (boxes of 128); lse and delta [bh, tq] f32 -> dk, dv
// [bh, tk, D] bf16.  Grid (bh, key tiles).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap domap,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int tq, int tk, float scale, int causal) {
  using S = KvShape<D>;
  extern __shared__ char smem_raw[];
  char* const ks = hopper::aligned_smem(smem_raw);
  char* const vs = ks + S::kKBytes;
  char* const ring = vs + S::kKBytes;  // stage s: Q, then dO
  float* const vec = reinterpret_cast<float*>(ks + S::kTileBytes);
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(vec + S::kVecFloats);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kKeyRows;  // the first key tile has most work
  const int n_qt = (tq + kQueryTile - 1) / kQueryTile;
  // Causal: query tiles that end before the first key add nothing.
  const int first = causal ? min(k0 / kQueryTile, n_qt) : 0;
  const int n_tiles = n_qt - first;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 8) {  // producer: lane 0 issues the copies, all write lse/delta
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * S::kKBytes);
      load_tile<D>(ks, &kmap, kv_full, kKeyRows, k0, bh);
      load_tile<D>(vs, &vmap, kv_full, kKeyRows, k0, bh);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int q0 = (first + it) * kQueryTile;
      hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      float* const lv = vec + s * 2 * kQueryTile;
      for (int j = lane; j < kQueryTile; j += 32) {
        const int q = q0 + j;
        const int64_t at = static_cast<int64_t>(bh) * tq + q;
        lv[j] = q < tq ? lse[at] * kLog2e : 0.f;
        lv[kQueryTile + j] = q < tq ? delta[at] : 0.f;
      }
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[s], S::kStageBytes);
        char* const qs = ring + s * S::kStageBytes;
        load_tile<D>(qs, &qmap, &full[s], kQueryTile, q0, bh);
        load_tile<D>(qs + S::kQBytes, &domap, &full[s], kQueryTile, q0, bh);
      } else {
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumers: warpgroup g owns keys kg .. kg + 63.
  const int g = warp / 4;
  const int t = threadIdx.x % 128;
  const int kg = k0 + g * 64;
  const float sl2 = scale * kLog2e;
  float dv_acc[D / 2], dk_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;
  float s_acc[kQueryTile / 2], dp_acc[kQueryTile / 2];
#pragma unroll
  for (int i = 0; i < kQueryTile / 2; ++i) s_acc[i] = dp_acc[i] = 0.f;
  uint32_t p_hi[kQueryTile / 4], p_lo[kQueryTile / 4];
  uint32_t ds_hi[kQueryTile / 4], ds_lo[kQueryTile / 4];

  hopper::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int q0 = (first + it) * kQueryTile;
    hopper::mbar_wait(&full[s], (it / kStages) & 1);
    if (kg < tk && !(causal && q0 + kQueryTile - 1 < kg)) {
      const char* const qs = ring + s * S::kStageBytes;
      const char* const dos = qs + S::kQBytes;
      const float* const lv = vec + s * 2 * kQueryTile;

      // S^T = K Q^T and dP^T = V dO^T: keys in rows, queries in columns.
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<kQueryTile>(s_acc, kmajor<D>(ks, kKeyRows, g * 64, kk),
                           kmajor<D>(qs, kQueryTile, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<kQueryTile>(dp_acc, kmajor<D>(vs, kKeyRows, g * 64, kk),
                           kmajor<D>(dos, kQueryTile, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s_acc);
      hopper::fence_regs(dp_acc);

      // P^T = exp(S^T * scale - lse), dS^T = P^T (dP^T - delta) * scale.
      const bool edge = (causal && q0 < kg + 63) || q0 + kQueryTile > tq;
#pragma unroll
      for (int i = 0; i < kQueryTile / 2; ++i) {
        const int c = hopper::acc_col(t, i);
        float p = exp2f(fmaf(s_acc[i], sl2, -lv[c]));
        if (edge) {
          const int q = q0 + c;
          if (q >= tq || (causal && kg + hopper::acc_row(t, i) > q)) p = 0.f;
        }
        s_acc[i] = p;
        dp_acc[i] = p * (dp_acc[i] - lv[kQueryTile + c]) * scale;
      }

      // dV += P^T dO, then dK += dS^T Q; dO and Q N-major.
      split<kQueryTile>(s_acc, p_hi, p_lo);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < kQueryTile / 16; ++c) {
        const uint64_t b = nmajor<D>(dos, kQueryTile, c);
        mma_rs<D>(dv_acc, p_hi + 4 * c, b);
        mma_rs<D>(dv_acc, p_lo + 4 * c, b);
      }
      hopper::wgmma_commit();
      split<kQueryTile>(dp_acc, ds_hi, ds_lo);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < kQueryTile / 16; ++c) {
        const uint64_t b = nmajor<D>(qs, kQueryTile, c);
        mma_rs<D>(dk_acc, ds_hi + 4 * c, b);
        mma_rs<D>(dk_acc, ds_lo + 4 * c, b);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(p_hi);
      hopper::fence_regs(p_lo);
      hopper::fence_regs(ds_hi);
      hopper::fence_regs(ds_lo);
    }
    hopper::mbar_arrive(&empty[s]);
  }

  const int64_t base = static_cast<int64_t>(bh) * tk * D;
  store_rows<D>(dk + base, dk_acc, kg, tk, t);
  store_rows<D>(dv + base, dv_acc, kg, tk, t);
}

// ---- dQ -------------------------------------------------------------------

template <int D>
struct QShape {
  static constexpr int kBK = D == 16 ? 128 : 64;         // keys a tile
  static constexpr int kQBytes = kQueryRows * D * 2;     // Q or dO
  static constexpr int kKBytes = kBK * D * 2;            // K or V tile
  static constexpr int kTileBytes = 2 * kQBytes + kStages * 2 * kKBytes;
  static constexpr int kSmem = kTileBytes + 1024 + 8 * (1 + 2 * kStages);
};

// q, dO through tensor maps over [bh, tq, D] (boxes of 128 rows), k, v over
// [bh, tk, D] (boxes of kBK); lse and delta [bh, tq] f32 -> dq [bh, tq, D]
// bf16.  Grid (bh, query tiles).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap domap,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int tq, int tk, float scale,
             int causal) {
  using S = QShape<D>;
  constexpr int BK = S::kBK;
  extern __shared__ char smem_raw[];
  char* const qs = hopper::aligned_smem(smem_raw);
  char* const dos = qs + S::kQBytes;
  char* const kv = dos + S::kQBytes;  // stage s: K at 2s, V at 2s + 1
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(qs + S::kTileBytes);
  uint64_t* const full = q_full + 1;
  uint64_t* const empty = full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQueryRows;  // heaviest first
  int n_tiles = (tk + BK - 1) / BK;
  if (causal) {
    // Key tiles whose first key is past the CTA's last query add nothing.
    const int last = min(q0 + kQueryRows, tq) - 1;
    n_tiles = min(n_tiles, last / BK + 1);
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 8) {  // producer: one thread issues every copy
    if (threadIdx.x % 32 == 0) {
      hopper::mbar_arrive_expect_tx(q_full, 2 * S::kQBytes);
      load_tile<D>(qs, &qmap, q_full, kQueryRows, q0, bh);
      load_tile<D>(dos, &domap, q_full, kQueryRows, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * S::kKBytes);
        char* const ks = kv + (2 * s) * S::kKBytes;
        load_tile<D>(ks, &kmap, &full[s], BK, it * BK, bh);
        load_tile<D>(ks + S::kKBytes, &vmap, &full[s], BK, it * BK, bh);
      }
    }
    return;
  }

  // Consumers: warpgroup g owns query rows row0 .. row0 + 63; this thread
  // rows r and r + 8 of them (h = 0, 1).
  const int g = warp / 4;
  const int t = threadIdx.x % 128;
  const int row0 = q0 + g * 64;
  const float sl2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + hopper::acc_row(t, 2 * h);
    const int64_t at = static_cast<int64_t>(bh) * tq + r;
    lse2[h] = r < tq ? lse[at] * kLog2e : 0.f;
    dl[h] = r < tq ? delta[at] : 0.f;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  float s_acc[BK / 2], dp_acc[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s_acc[i] = dp_acc[i] = 0.f;
  uint32_t ds_hi[BK / 4], ds_lo[BK / 4];

  hopper::mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = it * BK;
    hopper::mbar_wait(&full[s], (it / kStages) & 1);
    if (!(causal && k0 > row0 + 63)) {
      const char* const ks = kv + (2 * s) * S::kKBytes;
      const char* const vs = ks + S::kKBytes;

      // S = Q K^T and dP = dO V^T, all K-major.
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BK>(s_acc, kmajor<D>(qs, kQueryRows, g * 64, kk),
                   kmajor<D>(ks, BK, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BK>(dp_acc, kmajor<D>(dos, kQueryRows, g * 64, kk),
                   kmajor<D>(vs, BK, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s_acc);
      hopper::fence_regs(dp_acc);

      // dS = exp(S * scale - lse) (dP - delta) * scale, masked pairs 0.
      const bool edge = (causal && k0 + BK - 1 > row0) || k0 + BK > tk;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p = exp2f(fmaf(s_acc[i], sl2, -lse2[h]));
        if (edge) {
          const int c = k0 + hopper::acc_col(t, i);
          if (c >= tk || (causal && c > row0 + hopper::acc_row(t, i)))
            p = 0.f;
        }
        dp_acc[i] = p * (dp_acc[i] - dl[h]) * scale;
      }

      // dQ += dS K: dS hi and lo from registers, K N-major.
      split<BK>(dp_acc, ds_hi, ds_lo);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        const uint64_t b = nmajor<D>(ks, BK, c);
        mma_rs<D>(dq_acc, ds_hi + 4 * c, b);
        mma_rs<D>(dq_acc, ds_lo + 4 * c, b);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(dq_acc);
      hopper::fence_regs(ds_hi);
      hopper::fence_regs(ds_lo);
    }
    hopper::mbar_arrive(&empty[s]);
  }

  store_rows<D>(dq + static_cast<int64_t>(bh) * tq * D, dq_acc, row0, tq, t);
}

// ---- host -------------------------------------------------------------

int tensor_map(CUtensorMap* map, const void* base, int rows, int bh, int d,
               int box_rows) {
  const int sw = d >= 64 ? 128 : 2 * d;
  return hopper::make_tensor_map(map, base, d, rows, bh, d * 2,
                                 static_cast<uint64_t>(rows) * d * 2, sw / 2,
                                 box_rows, sw);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int bh, int tq, int tk, float scale, int causal,
           cudaStream_t stream) {
  using KV = KvShape<D>;
  using Q = QShape<D>;
  CUtensorMap qm, dom, km, vm;
  int rc = tensor_map(&qm, q, tq, bh, D, kQueryTile);
  if (rc == 0) rc = tensor_map(&dom, dout, tq, bh, D, kQueryTile);
  if (rc == 0) rc = tensor_map(&km, k, tk, bh, D, kKeyRows);
  if (rc == 0) rc = tensor_map(&vm, v, tk, bh, D, kKeyRows);
  if (rc == 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        flash_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        KV::kSmem));
  if (rc != 0) return rc;
  flash_bwd_dkdv<D><<<dim3(bh, (tk + kKeyRows - 1) / kKeyRows), kThreads,
                      KV::kSmem, stream>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), tq, tk, scale, causal);
  rc = static_cast<int>(cudaGetLastError());

  if (rc == 0) rc = tensor_map(&qm, q, tq, bh, D, kQueryRows);
  if (rc == 0) rc = tensor_map(&dom, dout, tq, bh, D, kQueryRows);
  if (rc == 0) rc = tensor_map(&km, k, tk, bh, D, Q::kBK);
  if (rc == 0) rc = tensor_map(&vm, v, tk, bh, D, Q::kBK);
  if (rc == 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Q::kSmem));
  if (rc != 0) return rc;
  flash_bwd_dq<D><<<dim3(bh, (tq + kQueryRows - 1) / kQueryRows), kThreads,
                    Q::kSmem, stream>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dq), tq, tk,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: CUDA cores ------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32Cols = 16;  // columns of a row a thread holds
constexpr int kF32Tile = 32;  // rows of the streamed operand a step

// A row is held by D / 16 adjacent lanes of one warp.  Lane c of a row
// holds the float4s c, c + kTpr, c + 2 kTpr, c + 3 kTpr, so the lanes of
// a row read consecutive 16-byte words of a shared row (no bank
// conflict) and the rows of a warp read the same words (a broadcast).
template <int D>
struct F32Shape {
  static constexpr int kTpr = D / kF32Cols;         // 1, 2, 4, 8
  static constexpr int kRows = kF32Threads / kTpr;  // 128, 64, 32, 16
};

template <int D>
__device__ __forceinline__ int f32_col(int c, int e) {
  return 4 * (c + F32Shape<D>::kTpr * e);
}

// Sums x over the lanes of a row; every lane of it gets the sum.
template <int D>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < F32Shape<D>::kTpr; off *= 2)
    x += __shfl_xor_sync(0xffffffff, x, off);
  return x;
}

// A lane's 16 columns of row `src` (a [*, D] row), zeros if !ok.
template <int D>
__device__ __forceinline__ void load_cols(float (&dst)[kF32Cols],
                                          const float* src, int c, bool ok) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 x = ok ? *reinterpret_cast<const float4*>(src + f32_col<D>(
                              c, e))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[4 * e] = x.x;
    dst[4 * e + 1] = x.y;
    dst[4 * e + 2] = x.z;
    dst[4 * e + 3] = x.w;
  }
}

template <int D>
__device__ __forceinline__ void store_cols(float* dst,
                                           const float (&src)[kF32Cols],
                                           int c) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    *reinterpret_cast<float4*>(dst + f32_col<D>(c, e)) =
        make_float4(src[4 * e], src[4 * e + 1], src[4 * e + 2],
                    src[4 * e + 3]);
}

// This lane's part of a . row, a the lane's columns, row a shared row.
template <int D>
__device__ __forceinline__ float dot_cols(const float (&a)[kF32Cols],
                                          const float* row, int c) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 b = *reinterpret_cast<const float4*>(row + f32_col<D>(c, e));
    s = fmaf(a[4 * e], b.x, s);
    s = fmaf(a[4 * e + 1], b.y, s);
    s = fmaf(a[4 * e + 2], b.z, s);
    s = fmaf(a[4 * e + 3], b.w, s);
  }
  return s;
}

// acc += x * row over the lane's columns.
template <int D>
__device__ __forceinline__ void axpy_cols(float (&acc)[kF32Cols], float x,
                                          const float* row, int c) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 b = *reinterpret_cast<const float4*>(row + f32_col<D>(c, e));
    acc[4 * e] = fmaf(x, b.x, acc[4 * e]);
    acc[4 * e + 1] = fmaf(x, b.y, acc[4 * e + 1]);
    acc[4 * e + 2] = fmaf(x, b.z, acc[4 * e + 2]);
    acc[4 * e + 3] = fmaf(x, b.w, acc[4 * e + 3]);
  }
}

// Rows [r0, r0 + kF32Tile) of a [*, D] tensor (from `base`, `n` of them
// valid) into a shared tile, zeros past n; all threads take part.
template <int D>
__device__ __forceinline__ void stage_rows(float (*tile)[D],
                                           const float* base, int n) {
  for (int i = threadIdx.x; i < kF32Tile * D / 4; i += kF32Threads) {
    const int r = i / (D / 4);
    const int col = 4 * (i - r * (D / 4));
    *reinterpret_cast<float4*>(&tile[r][col]) =
        r < n ? *reinterpret_cast<const float4*>(
                    base + static_cast<int64_t>(r) * D + col)
              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// delta [rows] = rowsum(dO * O) - dlse, f32.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_f32_delta(const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ dlse, float* __restrict__ delta,
                    int64_t rows) {
  using F = F32Shape<D>;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * kF32Threads + threadIdx.x;
  const int64_t row = idx / F::kTpr;
  const int c = threadIdx.x % F::kTpr;
  const bool live = row < rows;
  float a[kF32Cols];
  load_cols<D>(a, o + row * D, c, live);
  const float s = row_sum<D>(live ? dot_cols<D>(a, dout + row * D, c) : 0.f);
  if (live && c == 0) delta[row] = dlse == nullptr ? s : s - dlse[row];
}

// dK, dV: a thread holds 16 columns of one key's k, v and their
// accumulators; tiles of 32 queries (q, dO, lse, delta) stream through
// shared memory.  Causal: the query tiles before the CTA's first key are
// skipped and each pair is masked by index.  Grid (key tiles, bh).
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_f32_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int tq, int tk, float scale,
                   int causal) {
  using F = F32Shape<D>;
  __shared__ __align__(16) float qs[kF32Tile][D];
  __shared__ __align__(16) float dos[kF32Tile][D];
  __shared__ float ls[kF32Tile];
  __shared__ float dls[kF32Tile];

  const int64_t bh = blockIdx.y;
  const int k0 = blockIdx.x * F::kRows;
  const int c = threadIdx.x % F::kTpr;
  const int key = k0 + threadIdx.x / F::kTpr;
  const bool live = key < tk;
  const int64_t kv_at = (bh * tk + key) * D;
  float kr[kF32Cols], vr[kF32Cols], dkr[kF32Cols], dvr[kF32Cols];
  load_cols<D>(kr, k + kv_at, c, live);
  load_cols<D>(vr, v + kv_at, c, live);
#pragma unroll
  for (int e = 0; e < kF32Cols; ++e) dkr[e] = dvr[e] = 0.f;

  const int n_tiles = (tq + kF32Tile - 1) / kF32Tile;
  for (int t = causal ? k0 / kF32Tile : 0; t < n_tiles; ++t) {
    const int q0 = t * kF32Tile;
    const int qn = tq - q0 < kF32Tile ? tq - q0 : kF32Tile;
    __syncthreads();  // the previous tile is consumed
    stage_rows<D>(qs, q + (bh * tq + q0) * D, qn);
    stage_rows<D>(dos, dout + (bh * tq + q0) * D, qn);
    if (threadIdx.x < qn) {
      ls[threadIdx.x] = lse[bh * tq + q0 + threadIdx.x];
      dls[threadIdx.x] = delta[bh * tq + q0 + threadIdx.x];
    }
    __syncthreads();
    for (int i = 0; i < qn; ++i) {
      const float s = row_sum<D>(dot_cols<D>(kr, qs[i], c));
      const float dp = row_sum<D>(dot_cols<D>(vr, dos[i], c));
      const bool keep = live && !(causal && key > q0 + i);
      const float p = keep ? expf(s * scale - ls[i]) : 0.f;
      const float ds = p * (dp - dls[i]) * scale;
      axpy_cols<D>(dvr, p, dos[i], c);
      axpy_cols<D>(dkr, ds, qs[i], c);
    }
  }
  if (live) {
    store_cols<D>(dk + kv_at, dkr, c);
    store_cols<D>(dv + kv_at, dvr, c);
  }
}

// dQ: a thread holds 16 columns of one query's q, dO and dQ; tiles of 32
// keys (k, v) stream through shared memory.  Causal: the key tiles past
// the CTA's last query are skipped.  Grid (query tiles, bh).
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_f32_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int tq, int tk, float scale, int causal) {
  using F = F32Shape<D>;
  __shared__ __align__(16) float ks[kF32Tile][D];
  __shared__ __align__(16) float vs[kF32Tile][D];

  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * F::kRows;
  const int c = threadIdx.x % F::kTpr;
  const int row = q0 + threadIdx.x / F::kTpr;
  const bool live = row < tq;
  const int64_t at = (bh * tq + row) * D;
  float qr[kF32Cols], dor[kF32Cols], dqr[kF32Cols];
  load_cols<D>(qr, q + at, c, live);
  load_cols<D>(dor, dout + at, c, live);
#pragma unroll
  for (int e = 0; e < kF32Cols; ++e) dqr[e] = 0.f;
  const float l = live ? lse[bh * tq + row] : 0.f;
  const float dl = live ? delta[bh * tq + row] : 0.f;

  int n_tiles = (tk + kF32Tile - 1) / kF32Tile;
  if (causal) {
    const int last = (q0 + F::kRows - 1) / kF32Tile + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kF32Tile;
    const int kn = tk - k0 < kF32Tile ? tk - k0 : kF32Tile;
    __syncthreads();  // the previous tile is consumed
    stage_rows<D>(ks, k + (bh * tk + k0) * D, kn);
    stage_rows<D>(vs, v + (bh * tk + k0) * D, kn);
    __syncthreads();
    for (int j = 0; j < kn; ++j) {
      const float s = row_sum<D>(dot_cols<D>(qr, ks[j], c));
      const float dp = row_sum<D>(dot_cols<D>(dor, vs[j], c));
      const bool keep = live && !(causal && k0 + j > row);
      const float p = keep ? expf(s * scale - l) : 0.f;
      axpy_cols<D>(dqr, p * (dp - dl) * scale, ks[j], c);
    }
  }
  if (live) store_cols<D>(dq + at, dqr, c);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, const void* dlse,
               void* delta, void* dq, void* dk, void* dv, int bh, int tq,
               int tk, float scale, int causal, cudaStream_t stream) {
  using F = F32Shape<D>;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  const int64_t rows = static_cast<int64_t>(bh) * tq;
  flash_bwd_f32_delta<D>
      <<<static_cast<unsigned>((rows * F::kTpr + kF32Threads - 1) /
                               kF32Threads),
         kF32Threads, 0, stream>>>(static_cast<const float*>(o), dof,
                                   static_cast<const float*>(dlse), df, rows);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_f32_dkdv<D>
      <<<dim3((tk + F::kRows - 1) / F::kRows, bh), kF32Threads, 0, stream>>>(
          qf, kf, vf, dof, lf, df, static_cast<float*>(dk),
          static_cast<float*>(dv), tq, tk, scale, causal);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_f32_dq<D>
      <<<dim3((tq + F::kRows - 1) / F::kRows, bh), kF32Threads, 0, stream>>>(
          qf, kf, vf, dof, lf, df, static_cast<float*>(dq), tq, tk, scale,
          causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq [bh, tq, d]; k, v, dk, dv [bh, tk, d], bf16 if is_bf16
// (the tensor-core kernels), else f32 (the CUDA-core kernels); f32 lse
// and dlse (may be null) [bh, tq]; delta [bh, tq] f32 is scratch.
extern "C" int hvd_flash_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* lse, const void* dout,
                             const void* dlse, void* delta, void* dq,
                             void* dk, void* dv, int bh, int tq, int tk,
                             int d, float scale, int causal, int is_bf16,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh == 0 || tk == 0) return static_cast<int>(cudaGetLastError());
  if (tq == 0) {  // no queries: dK and dV are zero
    const size_t bytes = static_cast<size_t>(bh) * tk * d * (is_bf16 ? 2 : 4);
    cudaMemsetAsync(dk, 0, bytes, st);
    cudaMemsetAsync(dv, 0, bytes, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (!is_bf16) {
    switch (d) {
      case 16:
        return launch_f32<16>(q, k, v, o, lse, dout, dlse, delta, dq, dk, dv,
                              bh, tq, tk, scale, causal, st);
      case 32:
        return launch_f32<32>(q, k, v, o, lse, dout, dlse, delta, dq, dk, dv,
                              bh, tq, tk, scale, causal, st);
      case 64:
        return launch_f32<64>(q, k, v, o, lse, dout, dlse, delta, dq, dk, dv,
                              bh, tq, tk, scale, causal, st);
      case 128:
        return launch_f32<128>(q, k, v, o, lse, dout, dlse, delta, dq, dk,
                               dv, bh, tq, tk, scale, causal, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int64_t rows = static_cast<int64_t>(bh) * tq;
  const int64_t threads = rows * (d / 8);
  flash_bwd_delta<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                    st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(dlse),
      static_cast<float*>(delta), rows, d);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, dout, l, dl, dq, dk, dv, bh, tq, tk, scale,
                        causal, st);
    case 32:
      return launch<32>(q, k, v, dout, l, dl, dq, dk, dv, bh, tq, tk, scale,
                        causal, st);
    case 64:
      return launch<64>(q, k, v, dout, l, dl, dq, dk, dv, bh, tq, tk, scale,
                        causal, st);
    case 128:
      return launch<128>(q, k, v, dout, l, dl, dq, dk, dv, bh, tq, tk, scale,
                         causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
