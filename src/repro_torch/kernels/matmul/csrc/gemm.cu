// Blocked GEMM for Hopper (sm_90a): C[m,n] = A[m,k] . B[k,n], f32 accumulate.
//
// Replaces the TPU kernel src/repro/kernels/matmul/matmul.py:45
// matmul_kernel (body _matmul_kernel, :28): grid (M/bm, N/bn, K/bk) with K
// innermost and an f32 VMEM accumulator, zero padding to block multiples,
// f32 or bf16 inputs, output cast to out_dtype.
//
// Bound on this card: operations. A GEMM does 2*m*n*k flops on
// (m*k + k*n) input and m*n output elements, so at the chain's sizes
// (m, n, k around 1000) it needs hundreds of flops per byte. This kernel
// uses no tensor cores, so its roof is the FP32 FFMA rate outside them:
// about 67 TFLOP/s on the H100 SXM and 51 on the PCIe card. bf16 inputs
// are converted to f32 on load and run at that same FFMA rate.
//
// Design (simple and right first; wgmma, TMA and a multistage pipeline are
// later work):
// * Each CTA of 256 threads owns one BM x BN output tile and walks K in BK
//   steps; the TPU's sequential K grid axis becomes this loop, and the
//   accumulator lives in registers, not in scratch memory.
// * A and B tiles are staged in shared memory as f32 (at most 34 KB, below
//   the 48 KB static limit, so no dynamic shared memory is needed). A is
//   stored transposed, with 4 floats of padding per row, so the staging
//   stores avoid most bank conflicts.
// * Each thread keeps a TM x TN register micro-tile (TM = BM/16,
//   TN = BN/16), with its rows and columns strided by 16 so that a warp's
//   shared-memory reads are broadcasts or consecutive words. The 8 x 8
//   micro-tile of the 128 x 128 tiles does 64 FFMA for every 16 shared
//   loads, enough to keep the FFMA pipes fed.
// * Ragged edges are masked: out-of-range elements load as 0 and are never
//   stored, which gives the reference's zero-padding result without a
//   padded copy. Any tile is therefore valid for any shape.
// * bf16 is converted only through the intrinsics (__bfloat162float,
//   __float2bfloat16).
//
// C interface for ctypes: repro_gemm(...) launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched), -1 for a tile that
// is not instantiated and -2 for a dtype pair it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsM = 16;  // threads along a tile's rows
constexpr int kThreadsN = 16;  // threads along a tile's columns
constexpr int kThreads = kThreadsM * kThreadsN;
constexpr int kPad = 4;        // floats of padding per row of the A stage

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int BM, int BN, int BK, typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b, TOut* __restrict__ c,
            int m, int n, int k, int64_t lda, int64_t ldb, int64_t ldc) {
  static_assert(BM % kThreadsM == 0 && BN % kThreadsN == 0, "tile not divisible");
  constexpr int TM = BM / kThreadsM;
  constexpr int TN = BN / kThreadsN;
  __shared__ float as[BK][BM + kPad];  // A tile, transposed: as[kk][row]
  __shared__ float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsN;
  const int ty = tid / kThreadsN;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
    // Stage the tiles; neighbouring threads read neighbouring addresses.
    for (int idx = tid; idx < BM * BK; idx += kThreads) {
      const int r = idx / BK, kk = idx % BK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? to_f32(a[gr * lda + gk]) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int kk = idx / BN, cc = idx % BN;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n) ? to_f32(b[gk * ldb + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float af[TM], bf[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) af[i] = as[kk][ty + i * kThreadsM];
#pragma unroll
      for (int j = 0; j < TN; ++j) bf[j] = bs[kk][tx + j * kThreadsN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + i * kThreadsM;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + j * kThreadsN;
      if (gc < n) c[gr * ldc + gc] = from_f32<TOut>(acc[i][j]);
    }
  }
}

template <int BM, int BN, int BK, typename TIn, typename TOut>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           int64_t lda, int64_t ldb, int64_t ldc, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<BM, BN, BK, TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), static_cast<TOut*>(c),
      m, n, k, lda, ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK>
int launch_tile(int in_dtype, int out_dtype, const void* a, const void* b, void* c,
                int m, int n, int k, int64_t lda, int64_t ldb, int64_t ldc,
                cudaStream_t s) {
  if (in_dtype == kF32 && out_dtype == kF32)
    return launch<BM, BN, BK, float, float>(a, b, c, m, n, k, lda, ldb, ldc, s);
  if (in_dtype == kF32 && out_dtype == kBF16)
    return launch<BM, BN, BK, float, __nv_bfloat16>(a, b, c, m, n, k, lda, ldb, ldc, s);
  if (in_dtype == kBF16 && out_dtype == kF32)
    return launch<BM, BN, BK, __nv_bfloat16, float>(a, b, c, m, n, k, lda, ldb, ldc, s);
  if (in_dtype == kBF16 && out_dtype == kBF16)
    return launch<BM, BN, BK, __nv_bfloat16, __nv_bfloat16>(a, b, c, m, n, k, lda, ldb,
                                                            ldc, s);
  return -2;
}

}  // namespace

extern "C" int repro_gemm(int bm, int bn, int bk, int in_dtype, int out_dtype,
                          const void* a, const void* b, void* c, int m, int n, int k,
                          long long lda, long long ldb, long long ldc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The instantiated tiles; kernels/matmul/matmul.py SUPPORTED_TILES lists
  // the same set (a CPU test holds the two equal).
#define REPRO_TILE(BM, BN, BK)                                                     \
  if (bm == BM && bn == BN && bk == BK)                                            \
    return launch_tile<BM, BN, BK>(in_dtype, out_dtype, a, b, c, m, n, k, lda, ldb, \
                                   ldc, s);
  REPRO_TILE(16, 16, 16)
  REPRO_TILE(32, 32, 32)
  REPRO_TILE(64, 64, 64)
  REPRO_TILE(128, 128, 8)
  REPRO_TILE(128, 128, 16)
#undef REPRO_TILE
  return -1;
}
