// Mamba-2 SSD chunk scan for Hopper (sm_90a): f32 in and out, products on
// the tensor cores as 3xTF32.
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd.py:72 ssd_scan_kernel
// (body _ssd_kernel, :28). Per chunk of Q tokens of one (batch, head):
//   cum   = cumsum(logda)                                   [Q]
//   L     = exp(cum_i - cum_j) for i >= j, else 0           [Q, Q]
//   y     = ((C B^T) * L) xbar + exp(cum) * (C state^T)     [Q, p]
//   state = exp(cum_Q) * state + (exp(cum_Q - cum) * xbar)^T B   [p, n]
// with the [p, n] state carried from chunk to chunk. The TPU walks the
// chunks as its sequential grid axis with the state in VMEM.
//
// Bound on this card: operations. At mamba2-1.3b's widths (b 2, s 4096,
// h 64, p 64, n 128, one B/C group, Q = 256) the data needs 2.61e10 flops:
// C B^T's lower triangle once per (batch, chunk, group), (Q + 1) n a
// token, and per head (Q + 1) p for the decayed product with xbar and 4pn
// for y_inter and the chunk state. As 3xTF32 that is 7.82e10 tensor flops,
// 0.158 ms at the data sheet's 494.7 TFLOP/s (0.39 ms as FFMA at 67); the
// bytes (xbar, logda, B, C read once, y written once: 279 MB) take
// 0.083 ms.
//
// Design: the TPU's sequential chunk axis becomes five passes, as in the
// public mamba_ssm Triton kernels (_chunk_cumsum, _bmm_chunk, _chunk_state,
// _state_passing, _chunk_scan in state-spaces/mamba; cited, not copied):
//   1. cumsum: cum per (batch, head, chunk) in f64, one warp a chunk, into
//      scratch [b, h, s] (f64).
//   2. scores: C B^T once per (batch, chunk, group), 64 x 64 tiles on and
//      below the diagonal only, into scratch [b, nc, g, Q, qp] f32 (8.4 MB
//      at mamba2-1.3b, read from L2 by the group's heads).
//   3. chunk state: S_c = (exp(total - cum) * xbar)^T B for every (batch,
//      chunk, head), 2048 CTAs at mamba2-1.3b, into scratch
//      [b, nc + 1, h, p, ns] f32.
//   4. state passing, in place and sequential over chunks, parallel over
//      the p * n entries of each (batch, head): slot c becomes the state
//      before chunk c, slot nc the state after the last one.
//   5. chunk scan: y = ((C B^T) * L) xbar + exp(cum) * (C state_c^T) for
//      each (batch, chunk, head, 64-row tile), reading the state from before
//      its chunk; one K loop runs over n for y_inter and then over the
//      64-column blocks of y_intra up to each warp's diagonal. The tiles
//      with the longest rows are launched first.
// Passes 2, 3 and 5 are GEMM-shaped: a ring of 2 stages of 64-deep K tiles
// in dynamic shared memory (one barrier per 64 of K: 32-deep tiles in 3
// stages were slower), filled by cp.async (16-byte copies where rows
// are 16-byte aligned, else 4-byte; ragged edges zero-filled by src-size),
// and warp tiles of 32 x 32 m16n8k8 TF32 mma.sync fragments in registers,
// taken one k8 step at a time. The launch bounds hold the registers to 168
// a thread for CTAs of up to 128 threads (the chunk scan: 3 CTAs an SM,
// which its shared memory allows anyway) and to 128 above (the chunk state:
// 2 CTAs of 256 threads at p = 64; the chunk scan at p = 128 takes more);
// nothing spills.
//
// Numerics:
// * 3xTF32 (the GEMM's arithmetic, kernels/matmul/csrc/gemm.cu): each operand
//   split in registers into hi = rna(x) and lo = rna(x - hi), three
//   products a_lo*b_hi, a_hi*b_lo, a_hi*b_hi per fragment and k8 step into
//   a fresh fragment (C = 0), added to the f32 sum by FADD, because the
//   tensor core's accumulation truncates. One TF32 product misses the
//   reference's 3e-4 * (1 + |y|) some 64 times over at these widths.
// * cum and cum_i - cum_j are taken in f64 before the f32 exp: |cum| reaches
//   hundreds within a chunk, and an f32 cum would carry ulp(|cum|) into
//   every decay, near the tolerance at mamba2-1.3b.
// * cum_i - cum_j is positive above the diagonal (logda < 0) and its exp
//   overflows to inf at long chunks; inf * 0 would be NaN. The decay is
//   taken only where i >= j and is never multiplied by a 0/1 mask.
// * Where a warp's 64-column block of y_intra lies wholly below its rows,
//   the decay factors through the block's last column m:
//   exp(cum_i - cum_j) = exp(cum_i - cum_m) exp(cum_m - cum_j), both
//   exponents <= 0 and taken in f64. The column factor scales xbar before
//   its split and the row factor the products as they are added, so a warp
//   takes 20 exps a thread per block instead of 64, one per element.
//   Only the diagonal block takes exp(cum_i - cum_j) element by element.
//
// Traffic of the intermediates at mamba2-1.3b: the chunk states, 71 MB of
// f32, are written by pass 3, read and written in place by pass 4 and read
// by pass 5: four passes over HBM at most, about 0.08 ms, half the 3xTF32
// bound; much of it hits the 50 MB L2. The scores (8.4 MB), B and C (4 MB
// each) stay in L2 while the heads of a group read them. chip_smoke.py
// times each pass; state passing is kept a pass of its own.
//
// Layout: element (b, t, h, e) of xbar and y lies at
// b * stride_b + h * stride_h + t * stride_t + e, logda (b, t, h) likewise,
// and B and C (b, t, g, e) with g = h / heads_per_group, so the model
// layout runs without repeating B and C to heads and the head-flattened
// [bh, s, *] layout is the case h = 1.
//
// C interface for ctypes: repro_ssd_scan(...) launches the passes chosen by
// the bit mask `passes` (bit k is pass k + 1 above; the wrapper asks for all
// five, a timing harness for one at a time) on the given stream and returns
// the first nonzero cudaGetLastError() as an int (0 = launched), -1 for a
// head dim p that is not instantiated, -3 for n above kMaxN or a chunk above
// kMaxChunk and -4 for scratch pitches that are not multiples of 4. Every
// shape it accepts fits the card's shared memory (static_asserts below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 128;       // largest state dim n
constexpr int kMaxChunk = 4096;  // longest chunk Q
constexpr int kMaxP = 128;       // largest head dim instantiated below
constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory a CTA may use on Hopper
constexpr int kTile = 64;        // rows (tokens) of a scores / chunk-scan tile
constexpr int kKT = 64;          // depth of one K step
constexpr int kStages = 2;       // cp.async ring
constexpr int kPitchK = kKT + 4; // pitch of a tile stored [rows][kKT]
constexpr int kScoreThreads = 128;  // scores: 2 x 2 warps of 32 x 32
constexpr int kPassingThreads = 256;
// CTAs an SM that the launch bounds ask registers for: 384 threads' worth
// up to 128 threads a CTA (168 registers a thread), else 512 threads' worth
// (128 registers).
__host__ __device__ constexpr int min_ctas(int threads) {
  return threads <= 128 ? 384 / threads : 512 / threads;
}

// Warp tiles of 32 x 32 for the chunk state, whose output is P x kMaxN
// (16 x 32 at P = 16), and the chunk scan, whose output is 64 x P (32 x 16
// at P = 16).
template <int P>
struct StateWarps {
  static constexpr int kM = P >= 32 ? P / 32 : 1, kN = kMaxN / 32;
  static constexpr int kThreads = 32 * kM * kN, WM = P / kM, MT = WM / 16;
};
template <int P>
struct ScanWarps {
  static constexpr int kN = P >= 32 ? P / 32 : 1;
  static constexpr int kThreads = 64 * kN, WN = P / kN, NT = WN / 8;
  // 128 registers spill at P = 128 (256 threads): that one takes more.
  static constexpr int kMinCtas = kThreads <= 128 ? min_ctas(kThreads) : 1;
};

struct Params {
  int b, h, hg, s, chunk, n, nc;
  int ns;      // row pitch of the chunk states (n rounded up to 4)
  int qp;      // row pitch of the scores (Q rounded up to 4)
  int vec_x;   // xbar rows 16-byte aligned: 16-byte copies
  int vec_bc;  // B and C rows 16-byte aligned: 16-byte copies
  int64_t xb, xh, xs, lb, lh, ls, bb, bg, bs, yb, yh, ys;
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Dynamic shared memory of each pass, in bytes.
__host__ __device__ constexpr int scores_smem() { return kStages * 2 * kTile * kPitchK * 4; }
__host__ __device__ constexpr int state_stage(int p) {
  return kKT * (p + 8) + kKT * (kMaxN + 8);
}
__host__ __device__ constexpr int state_smem(int p, int chunk) {
  return kStages * state_stage(p) * 4 + round_up(chunk, kKT) * 4;
}
__host__ __device__ constexpr int scan_b_tile(int p) {
  return p * kPitchK > kKT * (p + 8) ? p * kPitchK : kKT * (p + 8);
}
__host__ __device__ constexpr int scan_stage(int p) {
  return kTile * kPitchK + scan_b_tile(p);
}
__host__ __device__ constexpr int scan_smem(int p, int chunk) {
  return kStages * scan_stage(p) * 4 + round_up(chunk, kTile) * 8;
}
static_assert(scores_smem() <= kSmemLimit, "the scores ring must fit the shared memory");
static_assert(state_smem(kMaxP, kMaxChunk) <= kSmemLimit,
              "the largest accepted shape must fit the shared memory (chunk state)");
static_assert(scan_smem(kMaxP, kMaxChunk) <= kSmemLimit,
              "the largest accepted shape must fit the shared memory (chunk scan)");

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

// Copies a ROWS x COLS tile whose element (0, 0) is g (row stride ld) into
// shared memory s (pitch SP). Elements at rows >= rmax or columns >= cmax
// are zero-filled (src-size 0, source address `valid`, which is readable).
// vec16: every row of g starts 16-byte aligned (COLS and SP multiples of 4).
template <int ROWS, int COLS, int SP, int kThreads>
__device__ __forceinline__ void load_tile(float* s, const float* g, int64_t ld, int rmax, int cmax,
                                          bool vec16, const float* valid, int tid) {
  static_assert(COLS % 4 == 0 && SP % 4 == 0, "16-byte copies need 4-float columns");
  if (vec16) {
    constexpr int kPerRow = COLS / 4;
    for (int idx = tid; idx < ROWS * kPerRow; idx += kThreads) {
      const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
      const int n = r < rmax ? min(max(cmax - c, 0), 4) : 0;
      cp_async_16(s + r * SP + c, n > 0 ? g + r * ld + c : valid, n * 4);
    }
  } else {
    for (int idx = tid; idx < ROWS * COLS; idx += kThreads) {
      const int r = idx / COLS, c = idx % COLS;
      const bool in = r < rmax && c < cmax;
      cp_async_4(s + r * SP + c, in ? g + r * ld + c : valid, in ? 4 : 0);
    }
  }
}

// ------------------------------------------------------- tensor cores --
// cvt.rna.tf32.f32's rounding, written out (as in gemm.cu): to nearest,
// ties away from zero, at 10 mantissa bits, the 13 bits below cleared.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// round_tf32 with the NaN guard: an x whose exponent is all ones (inf or
// NaN) passes as it is, so a NaN stays a NaN through the tensor core
// (gemm.cu's note says why).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  const uint32_t bits = __float_as_uint(x);
  if (!(fabsf(x) < __uint_as_float(0x7f800000u))) return bits;  // inf or NaN
  return round_tf32(x);
}

// x = hi + lo to about 22 bits, both exact TF32 values; for an inf or NaN x,
// hi = x and lo = 0 (gemm.cu's split, guarded the same way).
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

// acc += A[:, k0 : k0 + 8] . B[k0 : k0 + 8, :] for one warp's MT x NT
// fragments, as 3xTF32. a_at(row, k) and b_at(k, col) give the warp's
// operands (rows 0 .. 16 MT - 1, columns 0 .. 8 NT - 1). With row_scale,
// row g (+ 8) of fragment row i adds row_scale[i][0 (1)] times its product.
// Fragment layouts (PTX ISA, mma.m16n8k8): lane = 4 g + t; A element (g or
// g+8, t or t+4), B element (t or t+4, g), C elements (g or g+8, 2t and
// 2t+1).
template <int MT, int NT, class FA, class FB>
__device__ __forceinline__ void products_k8(float (&acc)[MT][NT][4], const FA& a_at,
                                            const FB& b_at, int k0, int lane,
                                            const float (*row_scale)[2] = nullptr) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_tf32(b_at(k0 + t, j * 8 + g), bhi[j][0], blo[j][0]);
    split_tf32(b_at(k0 + t + 4, j * 8 + g), bhi[j][1], blo[j][1]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    uint32_t ahi[4], alo[4];
    split_tf32(a_at(i * 16 + g, k0 + t), ahi[0], alo[0]);
    split_tf32(a_at(i * 16 + g + 8, k0 + t), ahi[1], alo[1]);
    split_tf32(a_at(i * 16 + g, k0 + t + 4), ahi[2], alo[2]);
    split_tf32(a_at(i * 16 + g + 8, k0 + t + 4), ahi[3], alo[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float d[4];
      mma_tf32_first(d, alo, bhi[j]);
      mma_tf32(d, ahi, blo[j]);
      mma_tf32(d, ahi, bhi[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = row_scale ? fmaf(row_scale[i][e >> 1], d[e], acc[i][j][e])
                                 : acc[i][j][e] + d[e];
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
}

// One K step of a warp: products_k8 one k8 at a time, so that only one
// k8's operands are live (the register budget of the launch bounds).
template <int MT, int NT, class FA, class FB>
__device__ __forceinline__ void products_kt(float (&acc)[MT][NT][4], const FA& a_at,
                                            const FB& b_at, int lane, int k_end = kKT) {
#pragma unroll 1
  for (int k0 = 0; k0 < k_end; k0 += 8) products_k8(acc, a_at, b_at, k0, lane);
}

// The K loop of passes 2, 3 and 5: `steps` K tiles through the ring,
// load(stage, step) issuing a tile's copies, compute(stage, step) its
// products once it has landed in every thread's view.
template <class Load, class Compute, class Start>
__device__ __forceinline__ void k_loop(int steps, const Load& load, const Compute& compute,
                                       const Start& start) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // prologue: the first kStages - 1 tiles in flight
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  start();  // the CTA's own loads, behind the tiles' (visible after the first barrier)
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies) ...
    __syncthreads();               // ... everyone's, and stage (kt - 1) % kStages is free
    const int next = kt + kStages - 1;
    if (next < steps) load(next % kStages, next);
    cp_async_commit();
    compute(kt % kStages, kt);
  }
  cp_async_wait<0>();
}

// Slot of the chunk-state scratch [b, nc + 1, h, p, ns] for (batch, chunk, head).
__device__ __forceinline__ int64_t slot(const Params& p, int bi, int c, int hi) {
  return (static_cast<int64_t>(bi) * (p.nc + 1) + c) * p.h + hi;
}

// ------------------------------------------------------ 1. cumsum pass --
// One warp per (batch, head, chunk): each lane sums a contiguous run of the
// chunk's logda, the lane totals are scanned with shuffles, and each lane
// writes its run's prefix sums.
__global__ void __launch_bounds__(256)
ssd_cumsum_kernel(const float* __restrict__ logda, double* __restrict__ cum, Params p) {
  using Cum = double;
  const int lane = threadIdx.x & 31;
  const int64_t task = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (task >= static_cast<int64_t>(p.b) * p.h * p.nc) return;
  const int c = static_cast<int>(task % p.nc);
  const int hi = static_cast<int>(task / p.nc % p.h);
  const int bi = static_cast<int>(task / (static_cast<int64_t>(p.nc) * p.h));
  const int Q = p.chunk;
  const float* lp = logda + bi * p.lb + hi * p.lh + static_cast<int64_t>(c) * Q * p.ls;
  double* out = cum + (static_cast<int64_t>(bi) * p.h + hi) * p.s + static_cast<int64_t>(c) * Q;
  const int run = (Q + 31) / 32;
  const int lo = min(Q, lane * run), hi_ = min(Q, lo + run);
  Cum total = 0;
  for (int t = lo; t < hi_; ++t) total += static_cast<Cum>(lp[t * p.ls]);
  Cum incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Cum up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  Cum run_sum = incl - total;
  for (int t = lo; t < hi_; ++t) {
    run_sum += static_cast<Cum>(lp[t * p.ls]);
    out[t] = run_sum;
  }
}

// ------------------------------------------------------ 2. scores pass --
// One CTA per (batch, chunk, group) and 64 x 64 tile (it, jt) with jt <= it:
// scores[i, j] = C_i . B_j over n, 2 x 2 warps of 32 x 32.
__global__ void __launch_bounds__(kScoreThreads, min_ctas(kScoreThreads))
ssd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ scores, Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp >> 1) * 32, wn0 = (warp & 1) * 32;
  const int gcount = p.h / p.hg;
  const int gi = blockIdx.x % gcount;
  const int c = blockIdx.x / gcount % p.nc;
  const int bi = blockIdx.x / gcount / p.nc;
  int it = 0;  // tile pair blockIdx.y = it (it + 1) / 2 + jt
  while ((it + 1) * (it + 2) / 2 <= static_cast<int>(blockIdx.y)) ++it;
  const int jt = blockIdx.y - it * (it + 1) / 2;
  const int Q = p.chunk, i0 = it * kTile, j0 = jt * kTile;
  const int64_t base = bi * p.bb + gi * p.bg + static_cast<int64_t>(c) * Q * p.bs;
  const float* ci = cm + base + i0 * p.bs;
  const float* bj = bm + base + j0 * p.bs;

  auto load = [&](int stage, int step) {
    float* sa = smem + stage * 2 * kTile * kPitchK;
    const int e0 = step * kKT;
    load_tile<kTile, kKT, kPitchK, kScoreThreads>(sa, ci + e0, p.bs, Q - i0, p.n - e0, p.vec_bc,
                                                  cm, tid);
    load_tile<kTile, kKT, kPitchK, kScoreThreads>(sa + kTile * kPitchK, bj + e0, p.bs, Q - j0,
                                                  p.n - e0, p.vec_bc, bm, tid);
  };
  float acc[2][4][4];
  zero(acc);
  auto compute = [&](int stage, int) {
    const float* sa = smem + stage * 2 * kTile * kPitchK + wm0 * kPitchK;
    const float* sb = smem + stage * 2 * kTile * kPitchK + (kTile + wn0) * kPitchK;
    auto a_at = [&](int r, int k) { return sa[r * kPitchK + k]; };
    auto b_at = [&](int k, int col) { return sb[col * kPitchK + k]; };
    products_kt(acc, a_at, b_at, lane);
  };
  k_loop((p.n + kKT - 1) / kKT, load, compute, [] {});

  float* out = scores + ((static_cast<int64_t>(bi) * p.nc + c) * gcount + gi) * Q * p.qp;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = i0 + wm0 + i * 16 + g + (e >> 1) * 8;
        const int col = j0 + wn0 + j * 8 + 2 * t + (e & 1);
        if (r < Q && col < Q) out[static_cast<int64_t>(r) * p.qp + col] = acc[i][j][e];
      }
    }
  }
}

// ------------------------------------------------- 3. chunk-state pass --
// One CTA per (batch, chunk, head): S[p, e] = sum_t xbar[t, p] w_t B[t, e]
// with w_t = exp(total - cum_t), K = Q in steps of 64; warps of 32 columns
// over the P x kMaxN output.
template <int P>
__global__ void __launch_bounds__(StateWarps<P>::kThreads, min_ctas(StateWarps<P>::kThreads))
ssd_chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                       const double* __restrict__ cum, float* __restrict__ states, Params p) {
  using W = StateWarps<P>;
  constexpr int kXP = P + 8, kBP = kMaxN + 8;  // pitches of the xbar and B tiles
  extern __shared__ __align__(16) float smem[];
  float* w = smem + kStages * state_stage(P);  // [round_up(Q, kKT)]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / W::kN) * W::WM, wn0 = (warp % W::kN) * 32;
  const int hi = blockIdx.x % p.h;
  const int c = blockIdx.x / p.h % p.nc;
  const int bi = blockIdx.x / p.h / p.nc;
  const int Q = p.chunk;
  const int64_t t0 = static_cast<int64_t>(c) * Q;
  const float* xp = x + bi * p.xb + hi * p.xh + t0 * p.xs;
  const float* bp = bm + bi * p.bb + (hi / p.hg) * p.bg + t0 * p.bs;
  const double* cp = cum + (static_cast<int64_t>(bi) * p.h + hi) * p.s + t0;

  auto load = [&](int stage, int step) {
    float* sx = smem + stage * state_stage(P);
    const int k0 = step * kKT;
    load_tile<kKT, P, kXP, W::kThreads>(sx, xp + k0 * p.xs, p.xs, Q - k0, P, p.vec_x, x, tid);
    load_tile<kKT, kMaxN, kBP, W::kThreads>(sx + kKT * kXP, bp + k0 * p.bs, p.bs, Q - k0, p.n,
                                            p.vec_bc, bm, tid);
  };
  float acc[W::MT][4][4];
  zero(acc);
  auto compute = [&](int stage, int step) {
    if (wn0 >= p.n) return;  // this warp's columns lie past n
    const float* sx = smem + stage * state_stage(P) + wm0;
    const float* sb = smem + stage * state_stage(P) + kKT * kXP + wn0;
    const float* ws = w + step * kKT;
    auto a_at = [&](int r, int k) { return sx[k * kXP + r] * ws[k]; };
    auto b_at = [&](int k, int col) { return sb[k * kBP + col]; };
    products_kt(acc, a_at, b_at, lane);
  };
  k_loop((Q + kKT - 1) / kKT, load, compute, [&] {
    const double total = cp[Q - 1];
    for (int t = tid; t < round_up(Q, kKT); t += W::kThreads)
      w[t] = t < Q ? expf(static_cast<float>(total - cp[t])) : 0.f;
  });

  float* s_out = states + slot(p, bi, c, hi) * P * p.ns;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < W::MT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm0 + i * 16 + g + (e >> 1) * 8;
        const int col = wn0 + j * 8 + 2 * t + (e & 1);
        if (col < p.ns) s_out[r * p.ns + col] = acc[i][j][e];
      }
    }
  }
}

// ----------------------------------------------- 4. state-passing pass --
// Per (batch, head), sequential over chunks and parallel over the P * ns
// entries (four a thread): slot c <- the state before chunk c, and
// state <- exp(total_c) * state + S_c; slot nc <- the state after the last.
__global__ void __launch_bounds__(kPassingThreads)
ssd_state_passing_kernel(const double* __restrict__ cum, float* __restrict__ states, int pdim,
                         Params p) {
  const int bi = blockIdx.x / p.h, hi = blockIdx.x % p.h;
  const int64_t e = (static_cast<int64_t>(blockIdx.y) * kPassingThreads + threadIdx.x) * 4;
  const int64_t size = static_cast<int64_t>(pdim) * p.ns;
  if (e >= size) return;
  const int64_t step = static_cast<int64_t>(p.h) * size;  // from one chunk's slot to the next
  float4* sp = reinterpret_cast<float4*>(states + slot(p, bi, 0, hi) * size + e);
  const double* cum_end = cum + (static_cast<int64_t>(bi) * p.h + hi) * p.s + p.chunk - 1;
  float4 state = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s_next = *sp;
  for (int c = 0; c < p.nc; ++c) {
    float* here = reinterpret_cast<float*>(sp) + c * step;
    const float4 s_c = s_next;  // the next chunk's load is issued before this store
    if (c + 1 < p.nc) s_next = *reinterpret_cast<const float4*>(here + step);
    *reinterpret_cast<float4*>(here) = state;
    const float decay = expf(static_cast<float>(cum_end[static_cast<int64_t>(c) * p.chunk]));
    state.x = fmaf(decay, state.x, s_c.x);
    state.y = fmaf(decay, state.y, s_c.y);
    state.z = fmaf(decay, state.z, s_c.z);
    state.w = fmaf(decay, state.w, s_c.w);
  }
  *reinterpret_cast<float4*>(reinterpret_cast<float*>(sp) + p.nc * step) = state;
}

// --------------------------------------------------- 5. chunk-scan pass --
// One CTA per (batch, chunk, head, 64-row tile), 2 x P / 32 warps of 32
// rows x 32 columns (16 at P = 16). K steps 0 .. ky - 1: y_inter =
// C . state^T over n; then acc *= exp(cum_i); then K steps over
// j < min(Q, i0 + 64): y_intra = (scores * L) . xbar. A warp skips the
// steps that lie wholly above its rows' diagonal.
template <int P>
__global__ void __launch_bounds__(ScanWarps<P>::kThreads, ScanWarps<P>::kMinCtas)
ssd_chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ cm,
                      const double* __restrict__ cum, const float* __restrict__ scores,
                      const float* __restrict__ states, float* __restrict__ y, Params p) {
  using W = ScanWarps<P>;
  constexpr int MT = 2, NT = W::NT, kThreads = W::kThreads;
  constexpr int kXP = P + 8;  // pitch of the xbar tile
  extern __shared__ __align__(16) float smem[];
  double* cum_s = reinterpret_cast<double*>(smem + kStages * scan_stage(P));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / W::kN) * 32, wn0 = (warp % W::kN) * W::WN;
  const int hi = blockIdx.x % p.h;
  const int c = blockIdx.x / p.h % p.nc;
  const int bi = blockIdx.x / p.h / p.nc;
  const int Q = p.chunk;
  const int it = gridDim.y - 1 - blockIdx.y;  // the longest rows first
  const int i0 = it * kTile;
  const int jmax = min(Q, i0 + kTile);
  const int gi = hi / p.hg, gcount = p.h / p.hg;
  const int64_t t0 = static_cast<int64_t>(c) * Q;
  const float* xp = x + bi * p.xb + hi * p.xh + t0 * p.xs;
  const float* ci = cm + bi * p.bb + gi * p.bg + (t0 + i0) * p.bs;
  const float* sc = scores + ((static_cast<int64_t>(bi) * p.nc + c) * gcount + gi) * Q * p.qp +
                    static_cast<int64_t>(i0) * p.qp;
  const float* state_before = states + slot(p, bi, c, hi) * P * p.ns;
  const double* cp = cum + (static_cast<int64_t>(bi) * p.h + hi) * p.s + t0;

  const int ky = (p.n + kKT - 1) / kKT;
  const int steps = ky + (jmax + kKT - 1) / kKT;
  auto load = [&](int stage, int step) {
    float* sa = smem + stage * scan_stage(P);
    float* sb = sa + kTile * kPitchK;
    if (step < ky) {  // C rows of the tile and the state, over n
      const int e0 = step * kKT;
      load_tile<kTile, kKT, kPitchK, kThreads>(sa, ci + e0, p.bs, Q - i0, p.n - e0, p.vec_bc, cm,
                                               tid);
      load_tile<P, kKT, kPitchK, kThreads>(sb, state_before + e0, p.ns, P, p.n - e0, true, states,
                                           tid);
    } else {  // scores rows of the tile and xbar, over j
      const int j0 = (step - ky) * kKT;
      load_tile<kTile, kKT, kPitchK, kThreads>(sa, sc + j0, p.qp, Q - i0, jmax - j0, true, scores,
                                               tid);
      load_tile<kKT, P, kXP, kThreads>(sb, xp + j0 * p.xs, p.xs, Q - j0, P, p.vec_x, x, tid);
    }
  };
  float acc[MT][NT][4];
  zero(acc);
  const int g = lane >> 2, t = lane & 3;
  auto compute = [&](int stage, int step) {
    const float* sa = smem + stage * scan_stage(P) + wm0 * kPitchK;
    const float* sb = smem + stage * scan_stage(P) + kTile * kPitchK;
    if (step < ky) {
      auto a_at = [&](int r, int k) { return sa[r * kPitchK + k]; };
      auto b_at = [&](int k, int col) { return sb[(wn0 + col) * kPitchK + k]; };
      products_kt(acc, a_at, b_at, lane);
      return;
    }
    const int j0 = (step - ky) * kKT;
    if (j0 == 0) {  // y_inter is complete: scale its rows by exp(cum_i)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = expf(static_cast<float>(cum_s[i0 + wm0 + i * 16 + g + (e >> 1) * 8]));
#pragma unroll
          for (int j = 0; j < NT; ++j) acc[i][j][e] *= d;
        }
      }
    }
    const int row0 = i0 + wm0;
    if (j0 > row0 + 31) return;  // wholly above this warp's diagonal
    if (j0 + kKT <= row0) {
      // Wholly below it: with m = j0 + kKT - 1, exp(cum_i - cum_j) =
      // exp(cum_i - cum_m) exp(cum_m - cum_j), both exponents <= 0 and taken
      // in f64; the column factor scales xbar, the row factor the products.
      const double cum_m = cum_s[j0 + kKT - 1];
      float row_scale[MT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          row_scale[i][h2] = expf(static_cast<float>(cum_s[row0 + i * 16 + g + 8 * h2] - cum_m));
      }
      auto a_at = [&](int r, int k) { return sa[r * kPitchK + k]; };
#pragma unroll 1
      for (int k0 = 0; k0 < kKT; k0 += 8) {
        const float c0 = expf(static_cast<float>(cum_m - cum_s[j0 + k0 + t]));
        const float c4 = expf(static_cast<float>(cum_m - cum_s[j0 + k0 + t + 4]));
        auto b_at = [&](int k, int col) { return sb[k * kXP + wn0 + col] * (k & 4 ? c4 : c0); };
        products_k8(acc, a_at, b_at, k0, lane, row_scale);
      }
      return;
    }
    auto a_at = [&](int r, int k) {  // the diagonal block
      const int i = row0 + r, j = j0 + k;
      // exp only on and below the diagonal: above it, it may be inf.
      return j <= i ? sa[r * kPitchK + k] * expf(static_cast<float>(cum_s[i] - cum_s[j])) : 0.f;
    };
    auto b_at = [&](int k, int col) { return sb[k * kXP + wn0 + col]; };
    products_kt(acc, a_at, b_at, lane, min(kKT, row0 + 32 - j0));  // k8 slabs up to the diagonal
  };
  k_loop(steps, load, compute, [&] {
    for (int t = tid; t < i0 + kTile; t += kThreads) cum_s[t] = t < Q ? cp[t] : 0.0;
  });

  float* yp = y + bi * p.yb + hi * p.yh + t0 * p.ys;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = i0 + wm0 + i * 16 + g + (e >> 1) * 8;
        const int col = wn0 + j * 8 + 2 * t + (e & 1);
        if (r < Q) yp[r * p.ys + col] = acc[i][j][e];
      }
    }
  }
}

// --------------------------------------------------------------- launch --
template <class Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int P>
int launch(const float* x, const float* logda, const float* bm, const float* cm, float* y,
           double* cum, float* scores, float* states, const Params& p, int passes,
           cudaStream_t stream) {
  static_assert(P <= kMaxP, "kMaxP bounds the shared memory of every instantiation");
  const int Q = p.chunk, tiles = (Q + kTile - 1) / kTile;
  const int64_t bh = static_cast<int64_t>(p.b) * p.h;
  int err = 0;
  if (passes & 1) {
    ssd_cumsum_kernel<<<static_cast<unsigned>((bh * p.nc + 7) / 8), 256, 0, stream>>>(logda, cum,
                                                                                      p);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & 2) {
    if ((err = set_smem(ssd_scores_kernel, scores_smem()))) return err;
    const dim3 grid(static_cast<unsigned>(p.b * p.nc * (p.h / p.hg)), tiles * (tiles + 1) / 2);
    ssd_scores_kernel<<<grid, kScoreThreads, scores_smem(), stream>>>(bm, cm, scores, p);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & 4) {
    auto kernel = ssd_chunk_state_kernel<P>;
    if ((err = set_smem(kernel, state_smem(P, Q)))) return err;
    const unsigned ctas = static_cast<unsigned>(bh * p.nc);
    kernel<<<ctas, StateWarps<P>::kThreads, state_smem(P, Q), stream>>>(x, bm, cum, states, p);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & 8) {
    const int per_cta = kPassingThreads * 4;
    const dim3 grid(static_cast<unsigned>(bh), (P * p.ns + per_cta - 1) / per_cta);
    ssd_state_passing_kernel<<<grid, kPassingThreads, 0, stream>>>(cum, states, P, p);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & 16) {
    auto kernel = ssd_chunk_scan_kernel<P>;
    if ((err = set_smem(kernel, scan_smem(P, Q)))) return err;
    const dim3 grid(static_cast<unsigned>(bh * p.nc), tiles);
    kernel<<<grid, ScanWarps<P>::kThreads, scan_smem(P, Q), stream>>>(x, cm, cum, scores, states,
                                                                    y, p);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  return 0;
}

}  // namespace

extern "C" int repro_ssd_scan(
    int pdim, const void* x, const void* logda, const void* bm, const void* cm, void* y,
    void* cum, void* scores, void* states,
    int b, int h, int hg, int s, int chunk, int n, int ns, int qp, int vec_x, int vec_bc,
    int passes,
    long long xb, long long xh, long long xs, long long lb, long long lh, long long ls,
    long long bb, long long bg, long long bs, long long yb, long long yh, long long ys,
    void* stream) {
  const Params p{b, h, hg, s, chunk, n, s / chunk, ns, qp, vec_x, vec_bc,
                 xb, xh, xs, lb, lh, ls, bb, bg, bs, yb, yh, ys};
  const float* xf = static_cast<const float*>(x);
  const float* lf = static_cast<const float*>(logda);
  const float* bf = static_cast<const float*>(bm);
  const float* cf = static_cast<const float*>(cm);
  float* yf = static_cast<float*>(y);
  double* cum_d = static_cast<double*>(cum);
  float* sc = static_cast<float*>(scores);
  float* st = static_cast<float*>(states);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (n > kMaxN || chunk > kMaxChunk) return -3;
  if (ns % 4 || ns < n || qp % 4 || qp < chunk) return -4;
  // The instantiated head dims (none above kMaxP); kernels/ssd/ssd.py
  // HEAD_DIMS lists the same set (a CPU test holds the two equal).
#define REPRO_HEAD_DIM(P) \
  if (pdim == P) return launch<P>(xf, lf, bf, cf, yf, cum_d, sc, st, p, passes, strm);
  REPRO_HEAD_DIM(16)
  REPRO_HEAD_DIM(32)
  REPRO_HEAD_DIM(64)
  REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
  return -1;
}
