// The rate of mma.sync on this card, the ceiling of csrc/gemm.cu's products.
//
// Not a kernel of the port: chip_smoke.py (phase 4) builds and times it to
// say how far the GEMM's main loop is from what its instruction can do. The
// published tensor-core peaks (494.7 TFLOP/s TF32, 989 bf16 on the H100 SXM)
// are wgmma's; the warp-level mma.sync that gemm.cu issues runs below them.
//
// Each warp issues 16 independent mma.m16n8k8.tf32 (or m16n8k16.bf16) per
// loop step on operands held in registers, so nothing but the tensor core's
// issue rate bounds it. The sums are consumed so the loop is not removed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 16;  // independent accumulators per warp

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kTF32>
__global__ void mma_peak_kernel(float* out, int iters) {
  float acc[kChains][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  const uint32_t b[2] = {5u, threadIdx.x};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if constexpr (kTF32) {
        mma_tf32(acc[j], a, b);
      } else {
        mma_bf16(acc[j], a, b);
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 1.2345f) out[threadIdx.x] = s;  // never true; keeps the products
}

}  // namespace

// Launches blocks x threads, each warp issuing iters * 16 mma; flops =
// blocks * threads / 32 * iters * 16 * 2 * 16 * 8 * (8 for tf32, 16 for
// bf16). Returns cudaGetLastError().
extern "C" int repro_mma_peak(int tf32, int blocks, int threads, int iters, void* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tf32) {
    mma_peak_kernel<true><<<blocks, threads, 0, s>>>(static_cast<float*>(out), iters);
  } else {
    mma_peak_kernel<false><<<blocks, threads, 0, s>>>(static_cast<float*>(out), iters);
  }
  return static_cast<int>(cudaGetLastError());
}
