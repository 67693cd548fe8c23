// Blocked GEMM for Hopper (sm_90a) on the tensor cores:
// C[m,n] = A[m,k] . B[k,n], f32 accumulate, output cast to f32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/matmul/matmul.py:45
// matmul_kernel (body _matmul_kernel, :28): grid (M/bm, N/bn, K/bk) with K
// innermost and an f32 VMEM accumulator, zero padding to block multiples,
// f32 or bf16 inputs, output cast to out_dtype.
//
// Bound on this card: operations. A GEMM does 2*m*n*k flops on
// (m*k + k*n) input and m*n output elements, hundreds of flops per byte at
// the chain's sizes (m, n, k around 1000). Two roofs apply to f32 inputs:
// FFMA outside the tensor cores, 67 TFLOP/s on the H100 SXM, and 3xTF32 on
// them, three TF32 products at 494.7 TFLOP/s, that is 165 TFLOP/s of f32
// work. bf16 inputs run at the bf16 rate, 989 TFLOP/s.
//
// Products on the tensor cores (mma.sync, the warp-level instruction):
// * f32 in, 3xTF32. One TF32 product keeps 10 mantissa bits of each operand
//   and misses the reference's f32 tolerance 2e-4 * (1 + |p|) about 6x at
//   1000^3. So each operand x is split in registers, after its fragment is
//   read from shared memory, into hi = rna(x) and lo = rna(x - hi), rna
//   being cvt.rna.tf32.f32's rounding (round_tf32 below; hi's takes a
//   NaN guard, to_tf32), and each k8 step
//   issues three mma.m16n8k8.tf32 into one fragment: a_lo*b_hi, a_hi*b_lo,
//   then a_hi*b_hi (a_lo*b_lo is below f32's last bit). Both
//   roundings are explicit: the tensor core is not trusted to ignore low
//   mantissa bits. The split costs five ALU instructions an element, read
//   once per warp, against three mma per m16n8 fragment and k8 step.
// * The tensor core adds into its accumulator with truncation, not
//   rounding, so each k8 step's three f32 products of a fragment go into a
//   fresh one (C = 0) that is added to the f32 sum by FADD: accumulated in
//   the mma across K = 1024 of unit inputs, the sum drifted by 1.3e-3, 6x
//   the reference's tolerance where |C| is small. A fresh fragment per
//   stage instead held 64 more floats at 128 x 128 and spilled.
// * bf16 in: mma.m16n8k16.bf16 (m16n8k8 for the BK = 8 tile), fragments
//   read by ldmatrix, with .trans for B, which is [k, n] row-major.
//
// Why mma.sync and not wgmma: wgmma takes TF32 operands only K-major (its
// transpose bits exist for 16-bit types only), and the main path's B is
// [k, n] with n contiguous; the hi/lo split has to pass through registers
// anyway; and the census tiles 16^3 and 32^3 are below wgmma's 64 rows.
// mma.m16n8k8 fragments are loaded by each thread from shared memory in any
// layout, so one template serves all five tiles.
//
// Design:
// * One CTA per BM x BN output tile, 1 warp (16^3), 4 (32^3, 64^3) or 8
//   (128 x 128) warps, each owning a 16x16, 32x32 or 64x32 part of it as
//   m16 x n8 accumulator fragments held in registers (64 floats a thread
//   at 128 x 128).
// * A ring of S stages in dynamic shared memory (Tile::kStages: 2 at 16^3,
//   4 at 128x128x8, else 3; 105 KB at 64^3 f32, two CTAs an SM), filled by
//   cp.async: commit_group per K step, wait_group S-2 and one __syncthreads
//   before each step, so the next S-1 tiles load while one is computed.
//   Rows are padded so fragment reads are free of bank conflicts: f32 A by
//   4 and B by 8 floats; bf16 rows to an odd number of 16-byte lines, as
//   ldmatrix wants.
// * Copy width by layout (the wrapper's copy_bytes): 16-byte cp.async.cg
//   where the bases and row strides of A, B and C are multiples of 16
//   bytes; else 4-byte cp.async.ca, element by element for f32. A bf16 row
//   that is not 4-byte aligned (an odd width) is read with plain loads.
// * Ragged edges: src-size zero-fills the elements past m, n or k, so every
//   fragment of a partial tile, lo parts included, reads 0; the epilogue
//   stores only what lies inside C (pairs on the 16-byte path, single
//   elements on the 4-byte path). Any tile is valid for any shape.
//
// Where the trouble lay: a 16-byte cp.async at an address that is not
// 16-byte aligned faults at run time (the paper's anomaly_331 has rows of
// 3416 and 1352 bytes, fig3_75 of 300); without the explicit rounding,
// hi + lo is not x; the K tail (k = 8 against BK = 64) is a partial last
// stage whose zero fill must cover whole fragments; 128 x 128 must hold 64
// accumulators and the hi/lo fragments without spilling (the loader keeps
// one column a thread and steps down the rows, so the 4-byte path does not
// hold one address per copy); a stage ring above 48 KB launches only after
// cudaFuncSetAttribute, set here once per device and instantiation; and
// the f32 loop is bound by issue, the split's ALU work beside the mma, on
// an mma.sync path whose own TF32 rate is below wgmma's (csrc/mma_peak.cu
// measures it; PERF.md has the figures).
//
// C interface for ctypes: repro_gemm(...) launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched), -1 for a tile that
// is not instantiated, -2 for a dtype pair it does not take and -3 for a
// copy width other than 16 or 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

// Warps along M and N, and stages of the ring, per instantiated tile.
template <int BM, int BN, int BK>
struct Tile;
template <>
struct Tile<16, 16, 16> { static constexpr int kWarpsM = 1, kWarpsN = 1, kStages = 2; };
template <>
struct Tile<32, 32, 32> { static constexpr int kWarpsM = 2, kWarpsN = 2, kStages = 3; };
template <>
struct Tile<64, 64, 64> { static constexpr int kWarpsM = 2, kWarpsN = 2, kStages = 3; };
template <>
struct Tile<128, 128, 8> { static constexpr int kWarpsM = 2, kWarpsN = 4, kStages = 4; };
template <>
struct Tile<128, 128, 16> { static constexpr int kWarpsM = 2, kWarpsN = 4, kStages = 3; };

template <int BM, int BN, int BK, typename TIn>
struct Layout {
  using T = Tile<BM, BN, BK>;
  static constexpr bool kF32In = sizeof(TIn) == 4;
  static constexpr int kThreads = 32 * T::kWarpsM * T::kWarpsN;
  static constexpr int kStages = T::kStages;
  static constexpr int WM = BM / T::kWarpsM;  // rows of C per warp
  static constexpr int WN = BN / T::kWarpsN;  // columns of C per warp
  static constexpr int MT = WM / 16;          // m16 fragments per warp
  static constexpr int NT = WN / 8;           // n8 fragments per warp
  // Row pitches of the A and B stages, in elements.
  static constexpr int kPitchA = kF32In ? BK + 4 : ((BK / 8) % 2 ? BK : BK + 8);
  static constexpr int kPitchB = BN + 8;
  static constexpr int kStageElems = BM * kPitchA + BK * kPitchB;
  static constexpr int kSmemBytes = kStages * kStageElems * static_cast<int>(sizeof(TIn));
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile not a multiple of 16");
  static_assert(BK % 8 == 0, "BK not a multiple of 8");
  static_assert(kSmemBytes <= 227 * 1024, "stage ring above 227 KB");
};

// ------------------------------------------------------------- cp.async --
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies a ROWS x COLS tile of the row-major global matrix g (pitch ld)
// from (r0, c0) into shared memory s (pitch P). Each thread keeps one
// column of copies and steps down the rows. Elements at rows >= rmax or
// columns >= cmax are zero-filled (src-size), and their source address is g.
template <int ROWS, int COLS, int P, int kCopyBytes, int kThreads, typename T>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ g, int64_t ld, int r0,
                                          int c0, int rmax, int cmax, int tid) {
  constexpr int kChunk = kCopyBytes / static_cast<int>(sizeof(T));  // elements per copy
  constexpr int kPerRow = COLS / kChunk;                             // copies per row
  constexpr int kRowStep = kThreads / kPerRow;                       // rows per sweep
  constexpr int kSweeps = (ROWS + kRowStep - 1) / kRowStep;
  static_assert(COLS % kChunk == 0 && kThreads % kPerRow == 0, "copies do not tile the block");
  const int c = (tid % kPerRow) * kChunk;
  const int col_valid = min(max(cmax - (c0 + c), 0), kChunk);
  int r = tid / kPerRow;
  const T* src = g + static_cast<int64_t>(r0 + r) * ld + (c0 + c);
  T* dst = s + r * P + c;
#pragma unroll (kSweeps <= 8 ? kSweeps : 4)
  for (int it = 0; it < kSweeps; ++it) {
    if (ROWS % kRowStep == 0 || r < ROWS) {
      const int valid = r0 + r < rmax ? col_valid : 0;
      const T* from = valid > 0 ? src : g;
      if constexpr (kCopyBytes == 16) {
        cp_async_16(dst, from, valid * static_cast<int>(sizeof(T)));
      } else if constexpr (sizeof(T) == 4) {
        cp_async_4(dst, from, valid * 4);
      } else if ((reinterpret_cast<uintptr_t>(from) & 3) == 0) {
        cp_async_4(dst, from, valid * 2);
      } else {  // a bf16 row at an odd element offset: plain loads
        const unsigned short* h = reinterpret_cast<const unsigned short*>(from);
        const uint32_t lo = valid > 0 ? h[0] : 0u;
        const uint32_t hi = valid > 1 ? h[1] : 0u;
        *reinterpret_cast<uint32_t*>(dst) = lo | (hi << 16);
      }
    }
    r += kRowStep;
    src += kRowStep * ld;
    dst += kRowStep * P;
  }
}

// ------------------------------------------------------- tensor cores --
// cvt.rna.tf32.f32's rounding, written out: to nearest, ties away from zero,
// at 10 mantissa bits, the 13 bits below cleared. sm_90 has no TF32
// conversion instruction. Equal to cvt.rna for every finite x
// (tests/test_torch_matmul.py emulates both the same way).
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// round_tf32 with the NaN guard: an x whose exponent is all ones (inf or
// NaN) passes as it is; the float compare tests that in one instruction,
// where a test of the bits takes two. Without it the add carries a NaN
// with its top mantissa bits set (CUDA's canonical 0x7fffffff, what 0/0
// gives on the device) into the sign bit or out of bit 31, and the mask
// leaves +-0: the NaN vanished from the product.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  const uint32_t bits = __float_as_uint(x);
  if (!(fabsf(x) < __uint_as_float(0x7f800000u))) return bits;  // inf or NaN
  return round_tf32(x);
}

// x = hi + lo to about 22 bits, both exact TF32 values. Only hi takes the
// guard, so a split pays for one: for an inf or NaN x, x - hi is the
// device's canonical NaN, which round_tf32 turns into -0, so hi = x, lo = 0
// and a NaN reaches the sum through hi. An infinite operand still gives NaN
// through a cross term where the other operand's lo is 0, where f32 gives
// +-inf; a finite |x| within 2^-11 of FLT_MAX (from 0x7f7ff000 up) rounds hi
// to inf and lo to -inf, so it too gives NaN; and a NaN whose payload lies
// only in its 13 low bits is read by the tensor core as inf.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b: the same product with C = 0.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16_k16(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// One stage's products for the warp at (wm0, wn0) of the tile.
// Fragment layouts (PTX ISA, mma.m16n8k8 / m16n8k16): lane = 4 g + t;
// A element (g or g+8, t or t+4), B element (t or t+4, g), C elements
// (g or g+8, 2t and 2t+1).
// f32: each k8 step's three products of a fragment go into a fresh d (C
// = 0), which is added to acc by FADD. The tensor core adds into its C
// operand with truncation, so a K run of hundreds of mma into one
// accumulator drifts towards zero by about an ulp of the partial sum each
// time; d holds three.
template <class L, int BK>
__device__ __forceinline__ void stage_products(float (&acc)[L::MT][L::NT][4], const float* sa,
                                               const float* sb, int wm0, int wn0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t bhi[L::NT][2], blo[L::NT][2];
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
      const float* q = sb + (kk + t) * L::kPitchB + wn0 + j * 8 + g;
      split_tf32(q[0], bhi[j][0], blo[j][0]);
      split_tf32(q[4 * L::kPitchB], bhi[j][1], blo[j][1]);
    }
#pragma unroll
    for (int i = 0; i < L::MT; ++i) {
      uint32_t ahi[4], alo[4];
      const float* p = sa + (wm0 + i * 16 + g) * L::kPitchA + kk + t;
      split_tf32(p[0], ahi[0], alo[0]);
      split_tf32(p[8 * L::kPitchA], ahi[1], alo[1]);
      split_tf32(p[4], ahi[2], alo[2]);
      split_tf32(p[8 * L::kPitchA + 4], ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        float d[4];
        mma_tf32_first(d, alo, bhi[j]);
        mma_tf32(d, ahi, blo[j]);
        mma_tf32(d, ahi, bhi[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
      }
    }
  }
}

template <class L, int BK>
__device__ __forceinline__ void stage_products(float (&acc)[L::MT][L::NT][4],
                                               const __nv_bfloat16* sa, const __nv_bfloat16* sb,
                                               int wm0, int wn0, int lane) {
  if constexpr (BK == 8) {
    uint32_t af[L::MT][2], bf[L::NT];
#pragma unroll
    for (int i = 0; i < L::MT; ++i)
      ldmatrix_x2(af[i], sa + (wm0 + i * 16 + (lane & 15)) * L::kPitchA);
#pragma unroll
    for (int j = 0; j < L::NT; j += 2) {
      uint32_t r[2];
      ldmatrix_x2_trans(r, sb + (lane & 7) * L::kPitchB + wn0 + j * 8 + ((lane >> 3) & 1) * 8);
      bf[j] = r[0];
      bf[j + 1] = r[1];
    }
#pragma unroll
    for (int i = 0; i < L::MT; ++i) {
#pragma unroll
      for (int j = 0; j < L::NT; ++j) mma_bf16_k8(acc[i][j], af[i], bf[j]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[L::MT][4], bf[L::NT][2];
#pragma unroll
      for (int i = 0; i < L::MT; ++i)
        ldmatrix_x4(af[i], sa + (wm0 + i * 16 + (lane & 15)) * L::kPitchA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < L::NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sb + (kk + (lane & 15)) * L::kPitchB + wn0 + j * 8 + (lane >> 4) * 8);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < L::MT; ++i) {
#pragma unroll
        for (int j = 0; j < L::NT; ++j) mma_bf16_k16(acc[i][j], af[i], bf[j]);
      }
    }
  }
}

// ------------------------------------------------------------ epilogue --
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Columns c and c + 1 of row r, inside C only. Pairs only where the layout
// is 16-byte aligned (c is even there, so the pair is aligned).
template <bool kPairs, typename TOut>
__device__ __forceinline__ void store_row(TOut* __restrict__ c, int64_t ldc, int m, int n, int r,
                                          int col, float x, float y) {
  if (r >= m) return;
  TOut* p = c + static_cast<int64_t>(r) * ldc + col;
  if (kPairs && col + 1 < n) {
    store2(p, x, y);
  } else {
    if (col < n) store1(p, x);
    if (col + 1 < n) store1(p + 1, y);
  }
}

// --------------------------------------------------------------- kernel --
// One CTA an SM is all the bounds ask: without it ptxas held 128 x 128 x 8
// f32 to 128 registers and spilled; with it no instantiation spills.
template <int BM, int BN, int BK, typename TIn, typename TOut, int kCopyBytes>
__global__ void __launch_bounds__(Layout<BM, BN, BK, TIn>::kThreads, 1)
gemm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b, TOut* __restrict__ c,
            int m, int n, int k, int64_t lda, int64_t ldb, int64_t ldc) {
  using L = Layout<BM, BN, BK, TIn>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  TIn* const ring = reinterpret_cast<TIn*>(smem);  // stage s: A at s * kStageElems, then B

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / L::T::kWarpsN) * L::WM;
  const int wn0 = (warp % L::T::kWarpsN) * L::WN;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  auto load_stage = [&](int stage, int kt) {
    TIn* sa = ring + stage * L::kStageElems;
    TIn* sb = sa + BM * L::kPitchA;
    load_tile<BM, BK, L::kPitchA, kCopyBytes, L::kThreads>(sa, a, lda, row0, kt * BK, m, k, tid);
    load_tile<BK, BN, L::kPitchB, kCopyBytes, L::kThreads>(sb, b, ldb, kt * BK, col0, k, n, tid);
  };

  float acc[L::MT][L::NT][4];
#pragma unroll
  for (int i = 0; i < L::MT; ++i) {
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  const int k_tiles = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {  // prologue: the first S - 1 tiles in flight
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<S - 2>();  // tile kt has landed (this thread's copies) ...
    __syncthreads();         // ... everyone's, and stage (kt - 1) % S is free
    const int next = kt + S - 1;
    if (next < k_tiles) load_stage(next % S, next);
    cp_async_commit();
    const TIn* sa = ring + (kt % S) * L::kStageElems;
    stage_products<L, BK>(acc, sa, sa + BM * L::kPitchA, wm0, wn0, lane);
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < L::MT; ++i) {
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
      const int r = row0 + wm0 + i * 16 + g;
      const int col = col0 + wn0 + j * 8 + 2 * t;
      store_row<kCopyBytes == 16>(c, ldc, m, n, r, col, acc[i][j][0], acc[i][j][1]);
      store_row<kCopyBytes == 16>(c, ldc, m, n, r + 8, col, acc[i][j][2], acc[i][j][3]);
    }
  }
}

// --------------------------------------------------------------- launch --
template <int BM, int BN, int BK, typename TIn, typename TOut, int kCopyBytes>
int launch(const void* a, const void* b, void* c, int m, int n, int k, int64_t lda, int64_t ldb,
           int64_t ldc, cudaStream_t stream) {
  using L = Layout<BM, BN, BK, TIn>;
  auto kernel = gemm_kernel<BM, BN, BK, TIn, TOut, kCopyBytes>;
  if constexpr (L::kSmemBytes > 48 * 1024) {
    // Above 48 KB a launch is refused until the limit is raised, once per
    // device (up to 64) and instantiation.
    static std::atomic<uint64_t> raised{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (!(raised.load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 L::kSmemBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, L::kThreads, L::kSmemBytes, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), static_cast<TOut*>(c), m, n, k,
      lda, ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK, typename TIn, typename TOut>
int launch_width(int copy_bytes, const void* a, const void* b, void* c, int m, int n, int k,
                 int64_t lda, int64_t ldb, int64_t ldc, cudaStream_t s) {
  if (copy_bytes == 16)
    return launch<BM, BN, BK, TIn, TOut, 16>(a, b, c, m, n, k, lda, ldb, ldc, s);
  if (copy_bytes == 4)
    return launch<BM, BN, BK, TIn, TOut, 4>(a, b, c, m, n, k, lda, ldb, ldc, s);
  return -3;
}

template <int BM, int BN, int BK>
int launch_tile(int in_dtype, int out_dtype, int w, const void* a, const void* b, void* c,
                int m, int n, int k, int64_t lda, int64_t ldb, int64_t ldc, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (in_dtype == kF32 && out_dtype == kF32)
    return launch_width<BM, BN, BK, float, float>(w, a, b, c, m, n, k, lda, ldb, ldc, s);
  if (in_dtype == kF32 && out_dtype == kBF16)
    return launch_width<BM, BN, BK, float, bf16>(w, a, b, c, m, n, k, lda, ldb, ldc, s);
  if (in_dtype == kBF16 && out_dtype == kF32)
    return launch_width<BM, BN, BK, bf16, float>(w, a, b, c, m, n, k, lda, ldb, ldc, s);
  if (in_dtype == kBF16 && out_dtype == kBF16)
    return launch_width<BM, BN, BK, bf16, bf16>(w, a, b, c, m, n, k, lda, ldb, ldc, s);
  return -2;
}

}  // namespace

extern "C" int repro_gemm(int bm, int bn, int bk, int in_dtype, int out_dtype, int copy_bytes,
                          const void* a, const void* b, void* c, int m, int n, int k,
                          long long lda, long long ldb, long long ldc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The instantiated tiles; kernels/matmul/matmul.py SUPPORTED_TILES lists
  // the same set (a CPU test holds the two equal).
#define REPRO_TILE(BM, BN, BK)                                                              \
  if (bm == BM && bn == BN && bk == BK)                                                     \
    return launch_tile<BM, BN, BK>(in_dtype, out_dtype, copy_bytes, a, b, c, m, n, k, lda, \
                                   ldb, ldc, s);
  REPRO_TILE(16, 16, 16)
  REPRO_TILE(32, 32, 32)
  REPRO_TILE(64, 64, 64)
  REPRO_TILE(128, 128, 8)
  REPRO_TILE(128, 128, 16)
#undef REPRO_TILE
  return -1;
}
