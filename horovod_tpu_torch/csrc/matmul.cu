// The FSDP unshard epilogue's product for Hopper (sm_90a):
// y[M, N] = x[M, K] @ w[K, N], both operands upcast to f32, the sum over
// K taken in f32, y written in x's type (f32 or bf16).
//
// Replaces horovod_tpu/ops/pallas_collectives.py::_matmul_kernel, whose
// output tile feeds the activation all-gather of fused_matmul_allgather.
// The TPU kernel walks K in panels of 512 along a sequential grid axis and
// carries the f32 sum in scratch; here each CTA owns one 128 x 128 output
// tile and loops over K inside the block, the sum held in registers.
//
// f32 on bf16 tensor cores.  A pre-pass (split_pieces) writes every f32
// operand as three bf16 pieces, hi = bf16(v), mid = bf16(v - hi),
// lo = bf16(v - hi - mid): each subtraction is exact, and the three pieces
// carry f32's 24 bits.  A bf16 operand is one piece, exactly.  Products of
// bf16 pieces are exact in f32, so y = sum over the piece pairs (i, j) with
// i + j <= 2 of x_i w_j (3 products for a bf16 x, 6 for an f32 one; the
// dropped pairs are below 2^-24 of the product), taken smallest first.
// The tensor cores may add into their accumulator by truncation rather
// than round-to-nearest, so they sum only one 16-deep K step of the
// pieces from zero; each step's partial is then added to the running f32
// sum in registers with a rounded add.  The result is held, like the
// CUDA-core kernel it replaces, to the f64 product: at most twice the
// plain version's error plus 1e-6 of the product's largest |value|.
//
// Design: 128 x 128 output tiles, K panels of 64.  A producer warp brings
// each panel's pieces by TMA (x K-major, w N-major, both with the 128-byte
// swizzle; out-of-range rows and columns arrive as zeros, so ragged M, N
// and K need no padded copy of the operands) into a ring of 2-4 stages
// guarded by mbarriers; two consumer warpgroups of 64 rows run wgmma
// m64n128k16.  What bounds it: the products it runs, 2 M N K a pair, on
// the bf16 tensor cores (989 TFLOP/s); the bytes (x, w and y once) are far
// below that at the unshard shapes.
//
// Plain C entry point, loaded with ctypes: launches on the given stream,
// allocates nothing (the wrapper passes the pieces' scratch) and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 288;   // two consumer warpgroups + a producer warp
constexpr int kPieceBytes = kBM * kBK * 2;  // one piece of a panel: 16 KB
constexpr int kAtomBytes = kBK * 64 * 2;    // 64 K-rows of 64 N columns

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p,
                                                          float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(a, b);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// src [rows, cols] -> dst [pieces][rows][ld] bf16 (ld >= cols; the columns
// past cols are never read).  pieces is 1 (a copy into bf16) or 3.
template <typename T>
__global__ void split_pieces(const T* __restrict__ src,
                             __nv_bfloat16* __restrict__ dst, int rows,
                             int cols, int ld, int pieces) {
  const int64_t n = static_cast<int64_t>(rows) * cols;
  const int64_t plane = static_cast<int64_t>(rows) * ld;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = e / cols, c = e - r * cols;
    const float v = to_f32(src[e]);
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    __nv_bfloat16* out = dst + r * ld + c;
    out[0] = hi;
    if (pieces == 3) {
      float rest = v - __bfloat162float(hi);
      if (!isfinite(rest)) rest = 0.f;  // an infinite v is all in hi
      const __nv_bfloat16 mid = __float2bfloat16_rn(rest);
      out[plane] = mid;
      out[2 * plane] = __float2bfloat16_rn(rest - __bfloat162float(mid));
    }
  }
}

template <int PX, int PW>
struct Stages {
  static constexpr int kStageBytes = (PX + PW) * kPieceBytes;
  static constexpr int kCount =
      (200 * 1024) / kStageBytes < 4 ? (200 * 1024) / kStageBytes : 4;
  static constexpr int kSmem = kCount * kStageBytes + 1024 + 16 * kCount;
};

// x pieces through xmap ({K, M, PX}), w pieces through wmap ({N, K, PW}).
// Grid (N tiles, M tiles).
template <typename TX, int PX, int PW>
__global__ void __launch_bounds__(kThreads, 1)
matmul_wgmma(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap, TX* __restrict__ y,
             int M, int N, int K) {
  using St = Stages<PX, PW>;
  constexpr int kStages = St::kCount;
  extern __shared__ char smem_raw[];
  char* const tiles = hopper::aligned_smem(smem_raw);
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(tiles + kStages * St::kStageBytes);
  uint64_t* const empty = full + kStages;

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int n_k = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 8) {  // producer
    if (threadIdx.x % 32 == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        hopper::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], St::kStageBytes);
        char* const a = tiles + s * St::kStageBytes;
        char* const b = a + PX * kPieceBytes;
        for (int i = 0; i < PX; ++i)
          hopper::tma_load_3d(a + i * kPieceBytes, &xmap, &full[s], kt * kBK,
                              m0, i);
        for (int j = 0; j < PW; ++j)
          for (int h = 0; h < 2; ++h)
            hopper::tma_load_3d(b + j * kPieceBytes + h * kAtomBytes, &wmap,
                                &full[s], n0 + h * 64, kt * kBK, j);
      }
    }
    return;
  }

  // Consumers: warpgroup g owns output rows m0 + 64 g .. + 63.
  const int g = warp / 4;
  const int t = threadIdx.x % 128;
  float acc[kBN / 2], part[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = part[i] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    const char* const a = tiles + s * St::kStageBytes + g * 64 * 128;
    const char* const b = tiles + s * St::kStageBytes + PX * kPieceBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      hopper::wgmma_fence();
      int first = 1;
#pragma unroll
      for (int sum = 2; sum >= 0; --sum) {  // smallest products first
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          const int j = sum - i;
          if (j < 0 || j >= PW) continue;
          const uint64_t ad = hopper::smem_desc(
              a + i * kPieceBytes + kk * 32, 16, 8 * 128, 128);
          const uint64_t bd = hopper::smem_desc(
              b + j * kPieceBytes + kk * 16 * 128, kAtomBytes, 8 * 128, 128);
          hopper::wgmma_ss_n128<1>(part, ad, bd, !first);
          first = 0;
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(part);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    hopper::mbar_arrive(&empty[s]);
  }

  const bool pairs = (N % 2) == 0;  // two neighbours share an aligned store
#pragma unroll
  for (int i = 0; i < kBN / 2; i += 2) {
    const int r = m0 + g * 64 + hopper::acc_row(t, i);
    const int c = n0 + hopper::acc_col(t, i);
    if (r >= M || c >= N) continue;
    TX* const out = y + static_cast<int64_t>(r) * N + c;
    if (pairs) {
      store_pair<TX>(out, acc[i], acc[i + 1]);
    } else {
      out[0] = from_f32<TX>(acc[i]);
      if (c + 1 < N) out[1] = from_f32<TX>(acc[i + 1]);
    }
  }
}

template <typename T>
void split(const void* src, void* dst, int rows, int cols, int ld,
           int pieces, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(rows) * cols;
  const int64_t blocks = (n + 255) / 256;
  split_pieces<T><<<blocks < 4096 ? static_cast<int>(blocks) : 4096, 256, 0,
                    stream>>>(static_cast<const T*>(src),
                              static_cast<__nv_bfloat16*>(dst), rows, cols,
                              ld, pieces);
}

template <typename TX, int PX, int PW>
int launch(const void* xp, int ldx, const void* wp, int ldw, void* y, int M,
           int N, int K, cudaStream_t stream) {
  using St = Stages<PX, PW>;
  CUtensorMap xm, wm;
  int rc = hopper::make_tensor_map(&xm, xp, K, M, PX, ldx * 2ull,
                                   static_cast<uint64_t>(M) * ldx * 2, kBK,
                                   kBM, 128);
  if (rc == 0)
    rc = hopper::make_tensor_map(&wm, wp, N, K, PW, ldw * 2ull,
                                 static_cast<uint64_t>(K) * ldw * 2, 64, kBK,
                                 128);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      matmul_wgmma<TX, PX, PW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      St::kSmem));
  if (rc != 0) return rc;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  matmul_wgmma<TX, PX, PW><<<grid, kThreads, St::kSmem, stream>>>(
      xm, wm, static_cast<TX*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

int round8(int v) { return (v + 7) / 8 * 8; }

}  // namespace

// x [M, K], w [K, N], y [M, N] in x's type; x_bf16 / w_bf16 say whether
// each operand is bf16 (else f32).  xs / ws are the pieces' scratch, or
// null where the operand is bf16 with rows of a multiple of 16 bytes and a
// 16-byte aligned base, which TMA then reads as it is.  xs holds
// (x_bf16 ? 1 : 3) * M * round8(K) bf16, ws (w_bf16 ? 1 : 3) * K *
// round8(N).
extern "C" int hvd_matmul(const void* x, const void* w, void* y, int M, int N,
                          int K, int x_bf16, int w_bf16, void* xs, void* ws,
                          void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 0) {  // an empty sum
    cudaMemsetAsync(y, 0, static_cast<size_t>(M) * N * (x_bf16 ? 2 : 4), st);
    return static_cast<int>(cudaGetLastError());
  }
  const int px = x_bf16 ? 1 : 3, pw = w_bf16 ? 1 : 3;
  int ldx = K, ldw = N;
  const void* xp = x;
  const void* wp = w;
  if (xs != nullptr) {
    ldx = round8(K);
    if (x_bf16)
      split<__nv_bfloat16>(x, xs, M, K, ldx, px, st);
    else
      split<float>(x, xs, M, K, ldx, px, st);
    xp = xs;
  }
  if (ws != nullptr) {
    ldw = round8(N);
    if (w_bf16)
      split<__nv_bfloat16>(w, ws, K, N, ldw, pw, st);
    else
      split<float>(w, ws, K, N, ldw, pw, st);
    wp = ws;
  }
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, 1, 1>(xp, ldx, wp, ldw, y, M, N, K, st);
  if (x_bf16)
    return launch<__nv_bfloat16, 1, 3>(xp, ldx, wp, ldw, y, M, N, K, st);
  if (w_bf16) return launch<float, 3, 1>(xp, ldx, wp, ldw, y, M, N, K, st);
  return launch<float, 3, 3>(xp, ldx, wp, ldw, y, M, N, K, st);
}
