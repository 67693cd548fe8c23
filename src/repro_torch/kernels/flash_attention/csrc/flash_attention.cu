// Flash attention (forward) for Hopper (sm_90a): online softmax over kv
// tiles, f32 running max / normaliser / accumulator.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:103
// flash_attention_kernel (body _flash_kernel, :32): scale 1/sqrt(d) unless
// given, optional tanh logit softcap, causal with q_offset = skv - sq (only
// when causal), optional sliding window kv_pos > q_pos - window, kv blocks
// that no query of the tile can see skipped, rows that see no key (l == 0)
// written as 0, f32 or bf16 in and out.
//
// Bound on this card: operations. Causal attention at a model's widths
// (s = 4096, d = 128) does about 2 * 2 * d flops per live (query, key) pair
// on O(s * d) bytes, thousands of flops per byte. Two kernels, chosen by
// dtype:
// * bf16: flash_bf16_kernel, both products on the tensor cores (wgmma), K
//   and V by TMA, a producer warpgroup beside two consumer warpgroups. Its
//   roof is the tensor cores' 989 TFLOP/s; the softcap's tanh and every
//   score's exp run on the MUFU units (about 16 results per clock per SM)
//   and are not counted in that roof.
// * f32: flash_f32_kernel, both products as 3xTF32 on the tensor cores
//   (mma.sync m16n8k8): each f32 operand x is split into TF32 parts
//   hi + lo and a product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, which
//   carries f32 inputs to about 2^-20 and computes the f32 function far
//   inside the reference's 2e-3 (one TF32 product for Q K^T does not). Its
//   roof is three TF32 products at the sheet's 494.7 TFLOP/s, 165 TFLOP/s
//   of f32 work (mma.sync itself reaches about 320 TFLOP/s TF32 on this
//   card, PERF.md), against FFMA's 67 TFLOP/s outside the tensor cores.
//
// Both kernels:
// * Causal and window skipping are loop bounds, not masked work: the first
//   and last kv tiles come from q_offset, the window and the tile's first
//   and last query. Elementwise masks apply only in edge tiles (a tile that
//   crosses the diagonal, the window's lower edge or the end of the keys).
// * A masked score is -inf. A row that has seen no key yet keeps m = -inf;
//   the exponent then uses 0 in place of m, so exp(-inf) = 0 and never
//   exp(-inf - -inf) = NaN, and the row ends with l == 0 and is written 0.
// * Layout: element (b, s, h, e) of q, k, v and o lies at
//   b * stride_b + h * stride_h + s * stride_s + e, so the model layout
//   [b, s, h, d] and the head-flattened [bh, s, d] (h = 1) both run without
//   a copy. Query head h reads kv head h / g (GQA without repeating k, v).
// * The CTA tile is the kernel's own choice. The caller's block_q / block_k
//   only set the wrapper's divisibility contract; the tile changes only the
//   order of the sums.
//
// flash_f32_kernel (one CTA of 8 warps per (batch * head, 128-query tile),
// 16 query rows a warp, 32-key tiles):
// * Q (128 rows) and a 2-stage ring of K and V tiles live in shared memory
//   as the f32 inputs, filled by 16-byte cp.async (rows past the end
//   zero-filled); one barrier a tile, after which the next tile's copy is
//   issued, so it lands while this one is computed. Rows are padded to
//   D + 4 floats: the fragment reads, Q and K at (row g, column t) and V at
//   (rows 2t and 2t + 1, column g), fall on 32 different banks. 132 KB at
//   d = 128 (one CTA an SM), 68 KB at d = 64.
// * The split is done where a fragment is read, in two instructions: hi is
//   x with its 13 low mantissa bits cleared (a truncation, so no carry can
//   reach the exponent or the sign: a NaN stays a NaN or an inf, an inf an
//   inf, and a finite x stays finite up to FLT_MAX), lo = x - hi exactly,
//   of which the tensor core reads the top 10 mantissa bits. gemm.cu's
//   rounded split costs five instructions an element plus its NaN guard.
//   Splitting K and V once per CTA into hi and lo arrays instead would
//   double their shared memory and the bytes of every fragment read (each
//   is read by all 8 warps), and add a pass and a barrier a tile. The two
//   instructions are still the largest cost beside the products: a build
//   that left them out (wrong numbers, the same mma) ran markedly faster.
// * S = Q K^T over d, the three products of every k8 step accumulated in
//   the mma. The tensor core truncates as it accumulates; over d = 128 (48
//   products) that stays far inside the tolerance (chip_smoke.py prints the
//   share at qwen3-14b), while a fresh fragment per k8 step, added to S by
//   FADD, cost four FADDs per three products and timed measurably slower.
//   The softmax works on the S fragment in registers as
//   the bf16 kernel's does (a row's keys on the 4 threads of a quad), with
//   expf and the accurate tanhf in f32.
// * O += P V with P in registers: the C fragment gives a thread keys 2t and
//   2t + 1 of each k8 slab, the A fragment wants columns t and t + 4, so
//   the keys of a slab are taken in a permuted order (A's column t is key
//   2t, column t + 4 is key 2t + 1) and B's rows t and t + 4 are read from
//   V's rows 2t and 2t + 1. For each n8 fragment of O the tile's 4 slabs
//   go into a fresh fragment, added to O by FADD.
// * Warps whose rows see none of a tile skip it but keep the barrier; the
//   grid walks the longest causal tiles first, as the bf16 grid does.
// * Registers: O (D / 2 floats), S (16) and P's hi and lo (32). 64-key
//   tiles (S 32, P 64) spilled at d = 128 within 255 registers; the tile is
//   32 keys, and chip_smoke.py fails on an f32 spill or local-memory access.
// Where the trouble lay: the f32 function must survive the tensor core's
// 10-bit operands and its truncating accumulation (hence the split, and a
// fresh fragment per tile of P V, since O sums over the whole sequence);
// registers (64-key tiles spilled at d = 128); P must become an A
// fragment without a trip through shared memory (the permutation); and
// every operand element costs its split where it is read, so the split
// must be as short as a split can be (the truncation).
//
// flash_bf16_kernel (one CTA of three warpgroups per (batch * head,
// 128-query tile)):
// * Warpgroup 0 is the producer: setmaxnreg lowers it to 24 registers and
//   one thread issues the TMA loads, Q once, then each live 128-key tile of
//   K and V into a ring of kStages shared-memory stages, each guarded by a
//   full and an empty mbarrier. Warpgroups 1 and 2 are consumers
//   (setmaxnreg raises them to 240 registers); each owns 64 query rows, the
//   wgmma M.
// * S = Q K^T by wgmma m64n128k16 (bf16 in, f32 accumulation), Q and K both
//   K-major from shared memory. The online softmax works on the S fragment
//   in registers: a thread holds rows g and g + 8 of its warp's 16, and a
//   row's 128 columns lie on the 4 threads of a quad, so row max and row
//   sum are two shuffles. Scores are kept in log2 units (log2(e) folded
//   into the scale) and exponentiated with ex2.approx.ftz.
// * l sums the unrounded f32 p. p is rounded to bf16 when it is packed as
//   the A operand of O += P V (wgmma m64n{D}k16, A from registers): the S
//   fragment's register order is the A fragment's, so P never touches
//   shared memory. V is [keys, d] with d contiguous, i.e. MN-major: the
//   wgmma's transpose bit for B is set.
// * Epilogue: O / l (0 where l == 0) in bf16, stored from registers, rows
//   at or past sq not stored.
// Where trouble lies, and what the design does about it:
// 1. Swizzle. TMA's swizzle and the wgmma descriptor's layout are the same
//    address-bit XOR, so both use one mode per head dim: d = 128 and 64 take
//    128-byte swizzle with 64-column boxes (a d = 128 tile is two boxes, one
//    after the other), d = 32 takes 64-byte swizzle with one 32-column box.
//    Every tile starts on a 1024-byte boundary (the swizzle's period). A
//    K-major descriptor steps 32 bytes along k inside a box and jumps to the
//    next box every 128 bytes; SBO is 8 rows. The MN-major V descriptor has
//    LBO = the box stride (the next 64 columns of d) and SBO = 8 key rows,
//    and steps 16 key rows per k step.
// 2. Producer and consumers walk the same tile range, the union of the two
//    consumer warpgroups' ranges (live_tiles over the CTA's rows). Each
//    consumer waits on every stage's full barrier and arrives on its empty
//    barrier whether or not it has work there; it computes only on its own
//    range. A CTA or a warpgroup with no live tile still writes its zeros.
//    A barrier wait that outlasts 10 s traps, so a disagreement fails the
//    launch instead of hanging the card.
// 3. Shapes smaller than a tile: TMA fills rows past the end of q, k and v
//    with zeros; keys past skv are masked to -inf (the tile is an edge
//    tile) and rows past sq are not stored.
// 4. TMA alignment: the base must be 16-byte aligned and the strides a
//    multiple of 16 bytes. The wrapper checks this and raises before launch.
// 5. Registers: ptxas compiles the kernel within the launch bound's 168
//    registers a thread (65,536 / 384), whatever setmaxnreg asks at run
//    time. S (64 floats), O (D / 2) and P (32 words) fit without a spill
//    because a consumer waits for each product before the next step;
//    overlapping the softmax with the P V product needs more and spilled.
//    chip_smoke.py prints ptxas -v's report and fails on a bf16 spill.
// 6. MUFU: the softcap is tanh.approx.f32 and exp is ex2.approx.ftz, one
//    MUFU op each per score. The accurate tanhf costs two MUFU ops and
//    about fifteen other instructions per score; tanh.approx's error (a
//    relative 2^-11) is held by chip_smoke.py against the bf16 tolerance at
//    gemma2-27b's full width. The f32 kernel keeps tanhf.
// 7. Causal imbalance: grid y walks the query tiles from the last (the
//    longest) to the first, and grid x, which the scheduler takes first,
//    walks the heads, so the longest tiles of every head start first.
//
// C interface for ctypes: repro_flash_attention(...) encodes, for bf16, the
// 4-D tensor maps over (d, heads, s, b) of q, k and v on every call
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library needs no -lcuda), launches on the given stream and returns cudaGetLastError() as an int (0 = launched), -1 for a
// head dim that is not instantiated, -2 for a dtype it does not take, -3
// when a tensor map cannot be encoded and -4 when the driver's
// cuTensorMapEncodeTiled cannot be found.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

struct Params {
  int h;          // query heads
  int g;          // query heads per kv head
  int sq, skv;
  int q_offset;   // absolute position of query row 0
  int causal;
  int has_window;
  int window;
  int has_cap;
  float cap;
  float scale;
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// The kv tiles [begin, end), of kKeys keys each, that query rows r_lo..r_hi
// (inclusive) can see.
struct TileRange {
  int begin, end;
};
template <int kKeys>
__device__ __forceinline__ TileRange kv_tiles(const Params& p, int r_lo, int r_hi) {
  if (r_hi < r_lo) return {0, 0};
  int kv_begin = 0, kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, r_hi + p.q_offset + 1);
  if (p.has_window) kv_begin = max(kv_begin, r_lo + p.q_offset - p.window + 1);
  if (kv_end <= kv_begin) return {0, 0};
  return {kv_begin / kKeys, (kv_end + kKeys - 1) / kKeys};
}

// ------------------------------------------------------------------ f32 --
// flash_f32_kernel: one CTA of 8 warps per (batch * head, 128-query tile),
// 16 query rows a warp, 32-key tiles, both products as 3xTF32 on mma.sync
// m16n8k8. The file's note gives the design.

constexpr int kF32Rows = 128;               // query rows of a CTA
constexpr int kF32Keys = 32;                // keys of a kv tile
constexpr int kF32Threads = 2 * kF32Rows;   // 8 warps of 16 rows
constexpr int kF32Stages = 2;               // K/V ring depth

// Shared memory of the f32 kernel at head dim D, in floats: Q (128 rows),
// then kF32Stages x (K, V), every row padded to D + 4 floats.
template <int D>
struct F32Geometry {
  static constexpr int kPitch = D + 4;  // = 4 mod 32: fragment reads are free of bank conflicts
  static constexpr int kQ = kF32Rows * kPitch;
  static constexpr int kKV = kF32Keys * kPitch;  // one K or V tile
  static constexpr int kSmem = (kQ + 2 * kF32Stages * kKV) * static_cast<int>(sizeof(float));
  static_assert(kSmem <= 227 * 1024, "f32 shared memory above 227 KB");
};

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Rows [r0, r0 + ROWS) of a [s, D] slice g (row stride ld floats) into
// shared memory s at pitch D + 4, 16 bytes a copy; rows at or past rmax are
// zero-filled (src-size 0) from g itself.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* s, const float* __restrict__ g, int64_t ld, int r0,
                                          int rmax, int tid) {
  constexpr int kPerRow = D / 4;
  static_assert(ROWS * kPerRow % kF32Threads == 0, "copies do not tile the rows");
#pragma unroll
  for (int it = 0; it < ROWS * kPerRow / kF32Threads; ++it) {
    const int idx = tid + it * kF32Threads;
    const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
    const bool in = r0 + r < rmax;
    cp_async_16(s + r * (D + 4) + c, in ? g + (r0 + r) * ld + c : g, in ? 16 : 0);
  }
}

// x = hi + lo for the tensor core. hi is x truncated to TF32 (the 13 low
// mantissa bits cleared, so no carry can reach the exponent or the sign),
// lo = x - hi exactly; the tensor core reads lo's top 10 mantissa bits,
// so x is carried to about 2^-20 of itself. A NaN gives hi NaN or inf and
// lo NaN, an inf gives hi inf and lo NaN: either way the products are NaN,
// never a finite number.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b, m16n8k8, TF32 in, f32 accumulate. Fragment layouts (PTX ISA):
// lane = 4 g + t; A element (g or g+8, t or t+4), B element (t or t+4, g),
// C elements (g or g+8, 2t and 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, const Params p) {
  using G = F32Geometry<D>;
  constexpr int P = G::kPitch;
  constexpr int NS = kF32Keys / 8;  // n8 score fragments of a tile; k8 slabs of P . V
  constexpr int NO = D / 8;         // n8 output fragments
  extern __shared__ float4 smem_f32[];
  float* qs = reinterpret_cast<float*>(smem_f32);
  float* kv = qs + G::kQ;  // stage s: K at kv + 2 s kKV, V after it

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int bi = blockIdx.x / p.h;
  const int hi = blockIdx.x % p.h;
  const int kvh = hi / p.g;
  const float* kp = k + bi * p.kb + kvh * p.kh;
  const float* vp = v + bi * p.vb + kvh * p.vh;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kF32Rows;  // the longest causal tiles first
  const TileRange cta = kv_tiles<kF32Keys>(p, row0, min(row0 + kF32Rows, p.sq) - 1);
  const int wrow0 = row0 + 16 * warp;
  const int wrow_hi = min(wrow0 + 16, p.sq) - 1;  // last stored row of the warp
  const TileRange own = kv_tiles<kF32Keys>(p, wrow0, wrow_hi);
  const int warp_begin = own.begin;
  const int warp_end = own.end;
  const int qpos_lo = wrow0 + p.q_offset;
  const int qpos_hi = wrow_hi + p.q_offset;
  const int my_q = wrow0 + g + p.q_offset;  // this thread's rows: positions my_q, my_q + 8

  load_rows<D, kF32Rows>(qs, q + bi * p.qb + hi * p.qh, p.qs, row0, p.sq, tid);
  if (cta.begin < cta.end) {
    load_rows<D, kF32Keys>(kv, kp, p.ks, cta.begin * kF32Keys, p.skv, tid);
    load_rows<D, kF32Keys>(kv + G::kKV, vp, p.vs, cta.begin * kF32Keys, p.skv, tid);
  }
  cp_async_commit();

  float o_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] = 0.f;
  }
  float m[2] = {neg_inf(), neg_inf()};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int tile = cta.begin, i = 0; tile < cta.end; ++tile, ++i) {
    // Tile `tile` has landed for every thread, and every warp is done with
    // the stage that the next copy overwrites.
    cp_async_wait_all();
    __syncthreads();
    if (tile + 1 < cta.end) {
      float* next = kv + ((i + 1) % kF32Stages) * 2 * G::kKV;
      load_rows<D, kF32Keys>(next, kp, p.ks, (tile + 1) * kF32Keys, p.skv, tid);
      load_rows<D, kF32Keys>(next + G::kKV, vp, p.vs, (tile + 1) * kF32Keys, p.skv, tid);
    }
    cp_async_commit();
    if (tile < warp_begin || tile >= warp_end) continue;  // no row of this warp sees the tile
    const float* ks = kv + (i % kF32Stages) * 2 * G::kKV;
    const float* vs = ks + G::kKV;

    // S = Q K^T over d, accumulated in the mma.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float* qa = qs + (16 * warp + g) * P + 8 * kk + t;
      uint32_t qhi[4], qlo[4];
      split_tf32(qa[0], qhi[0], qlo[0]);
      split_tf32(qa[8 * P], qhi[1], qlo[1]);
      split_tf32(qa[4], qhi[2], qlo[2]);
      split_tf32(qa[8 * P + 4], qhi[3], qlo[3]);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float* kb = ks + (8 * n + g) * P + 8 * kk + t;
        uint32_t khi[2], klo[2];
        split_tf32(kb[0], khi[0], klo[0]);
        split_tf32(kb[4], khi[1], klo[1]);
        mma_tf32(s[n], qlo, khi);
        mma_tf32(s[n], qhi, klo);
        mma_tf32(s[n], qhi, khi);
      }
    }

    // Online softmax on the fragment: s[n][e] is row my_q + 8 (e >> 1), key
    // k0 + 8 n + 2 t + (e & 1); a row's keys lie on the 4 threads of a quad.
    const int k0 = tile * kF32Keys;
    const bool edge = (k0 + kF32Keys > p.skv) || (p.causal && k0 + kF32Keys - 1 > qpos_lo) ||
                      (p.has_window && k0 <= qpos_hi - p.window);
    if (p.has_cap) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = p.cap * tanhf(s[n][e] * p.scale / p.cap);
      }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= p.scale;
      }
    }
    if (edge) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * n + 2 * t + (e & 1);
          const int qpos = my_q + 8 * (e >> 1);
          bool ok = kpos < p.skv;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.has_window) ok = ok && kpos > qpos - p.window;
          if (!ok) s[n][e] = neg_inf();
        }
      }
    }
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
    float alpha[2], mu[2];  // mu: the max the exponent subtracts, 0 for a row with no key yet
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == neg_inf() ? 0.f : m_new;
      alpha[r] = expf(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[j][e] *= alpha[e >> 1];
    }

    // P as the A operand of O += P V, in registers. The k8 slab n holds keys
    // k0 + 8 n .. + 7 in a permuted order: A's column t is key 2t (C
    // elements 0 and 2 of fragment n), column t + 4 is key 2t + 1 (elements
    // 1 and 3), and B's rows t and t + 4 are read from V's rows 2t and
    // 2t + 1 to match. The sum over keys is the same.
    uint32_t phi[NS][4], plo[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float e4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) e4[e] = expf(s[n][e] - mu[e >> 1]);
      l[0] += e4[0] + e4[1];
      l[1] += e4[2] + e4[3];
      split_tf32(e4[0], phi[n][0], plo[n][0]);
      split_tf32(e4[2], phi[n][1], plo[n][1]);
      split_tf32(e4[1], phi[n][2], plo[n][2]);
      split_tf32(e4[3], phi[n][3], plo[n][3]);
    }

    // O += P V: for each n8 fragment of O, the tile's k8 slabs go into a
    // fresh d, added to O by FADD.
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float* vb = vs + (8 * n + 2 * t) * P + 8 * j + g;
        uint32_t vhi[2], vlo[2];
        split_tf32(vb[0], vhi[0], vlo[0]);
        split_tf32(vb[P], vhi[1], vlo[1]);
        mma_tf32(d, plo[n], vhi);
        mma_tf32(d, phi[n], vlo);
        mma_tf32(d, phi[n], vhi);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[j][e] += d[e];
    }
  }
  cp_async_wait_all();

  // Epilogue: O / l, 0 where l == 0; o_acc[j][2 r + e] is row wrow0 + g + 8 r,
  // column 8 j + 2 t + e.
  float* op = o + bi * p.ob + hi * p.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = wrow0 + g + 8 * r;
    if (row >= p.sq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<float2*>(op + row * p.os + 8 * j + 2 * t) =
          make_float2(o_acc[j][2 * r] / l_safe, o_acc[j][2 * r + 1] / l_safe);
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b, const Params& p,
               cudaStream_t stream) {
  constexpr int smem = F32Geometry<D>::kSmem;
  auto kernel = flash_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * p.h, (p.sq + kF32Rows - 1) / kF32Rows);
  kernel<<<grid, kF32Threads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                              static_cast<const float*>(v), static_cast<float*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- bf16 --

constexpr int kTile = 128;          // query rows of a CTA, keys of a kv tile
constexpr int kStages = 3;          // K/V ring depth: 229 KB of shared memory at d = 128
constexpr int kWgThreads = 128;     // one warpgroup
constexpr int kThreadsBf16 = 3 * kWgThreads;
constexpr int kConsumerWarps = 8;   // arrivals that free a stage
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry of one 128-row tile of bf16 at head dim D.
template <int D>
struct Geometry {
  static constexpr int kBox = D < 64 ? D : 64;           // columns of one TMA box
  static constexpr int kRowBytes = 2 * kBox;              // 64 or 128 bytes: the swizzle span
  static constexpr int kBoxes = D / kBox;
  static constexpr int kBoxBytes = kTile * kRowBytes;     // one box of 128 rows
  static constexpr int kTileBytes = kBoxes * kBoxBytes;   // 128 x D
  static constexpr uint32_t kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma: 128B / 64B swizzle
  // Q, then kStages x (K, V), then the barriers; 1024 bytes of slack to
  // align the first tile to the swizzle's period.
  static constexpr int kBarrierBytes = 8 * (2 * kStages + 1);
  static constexpr int kSmem = (1 + 2 * kStages) * kTileBytes + kBarrierBytes + 1024;
};

// 2^x on the MUFU unit (ex2.approx.ftz: a result below 2^-126 is 0, a p
// that no sum can see at the tolerance).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh on the MUFU unit (relative error about 2^-11).
__device__ __forceinline__ float fast_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Wait until the phase of the given parity has completed. A wait that
// outlasts kDeadlockNs is a producer and consumers that disagree on the
// tiles: the kernel traps (the launch fails) instead of hanging the card.
constexpr uint64_t kDeadlockNs = 10000000000ull;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - start > kDeadlockNs) __trap();
  }
}

// One TMA box of a 4-D map (d, heads, s, b) into shared memory; completion
// is counted in bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from touching accumulator registers across the
// asynchronous wgmma: every use after this point depends on it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (+)= Q K^T: m64n128k16, A and B K-major from shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V: m64n{D}k16, P (bf16 pairs) from registers, V MN-major.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) wgmma_rs_n128(d, a, db);
  if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  if constexpr (D == 32) wgmma_rs_n32(d, a, db);
}

// The 128-key tiles that query rows r_lo..r_hi (inclusive) can see.
__device__ __forceinline__ TileRange live_tiles(const Params& p, int r_lo, int r_hi) {
  return kv_tiles<kTile>(p, r_lo, r_hi);
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                  const Params p) {
  using G = Geometry<D>;
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  const uint32_t q_tile = (smem_u32(smem_bf16) + 1023u) & ~1023u;
  const uint32_t bars = q_tile + (1 + 2 * kStages) * G::kTileBytes;
  const uint32_t q_bar = bars + 16 * kStages;
  // stage s: K at k_tile(s), V right after it; barriers full(s), empty(s)
  auto k_tile = [&](int s) { return q_tile + (1 + 2 * s) * G::kTileBytes; };
  auto v_tile = [&](int s) { return q_tile + (2 + 2 * s) * G::kTileBytes; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int bi = blockIdx.x / p.h;
  const int hi = blockIdx.x % p.h;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // the longest causal tiles first
  const TileRange cta = live_tiles(p, row0, min(row0 + kTile, p.sq) - 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // ------------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = hi / p.g;
      mbar_expect_tx(q_bar, G::kTileBytes);
      for (int c = 0; c < G::kBoxes; ++c)
        tma_load(q_tile + c * G::kBoxBytes, &tq, q_bar, c * G::kBox, hi, row0, bi);
      for (int t = cta.begin, i = 0; t < cta.end; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * G::kTileBytes);
        for (int c = 0; c < G::kBoxes; ++c) {
          tma_load(k_tile(s) + c * G::kBoxBytes, &tk, full(s), c * G::kBox, kvh, t * kTile, bi);
          tma_load(v_tile(s) + c * G::kBoxBytes, &tv, full(s), c * G::kBox, kvh, t * kTile, bi);
        }
      }
    }
  } else {
    // ----------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / kWgThreads - 1;  // owns query rows 64 cw .. 64 cw + 63
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int wrow0 = row0 + 64 * cw;
    const int wrow_hi = min(wrow0 + 64, p.sq) - 1;  // last stored row
    const TileRange wr = live_tiles(p, wrow0, wrow_hi);
    const int live_begin = wr.begin;
    const int live_end = wr.end;
    const int qpos_lo = wrow0 + p.q_offset;
    const int qpos_hi = wrow_hi + p.q_offset;
    const int my_row = wrow0 + 16 * warp + lane / 4;  // this thread's rows: my_row, my_row + 8
    const float scale_log2 = p.scale * kLog2e;
    const float cap_log2 = p.cap * kLog2e;
    const float scale_over_cap = p.has_cap ? p.scale / p.cap : 0.f;

    float o_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o_acc[j] = 0.f;
    float m[2] = {neg_inf(), neg_inf()};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    mbar_wait(q_bar, 0);
    for (int t = cta.begin, i = 0; t < cta.end; ++t, ++i) {
      const int s = i % kStages;
      mbar_wait(full(s), (i / kStages) & 1);
      if (t >= live_begin && t < live_end) {
        float sc[64];
#pragma unroll
        for (int j = 0; j < 64; ++j) sc[j] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int box = kk * 32 / G::kRowBytes, off = kk * 32 % G::kRowBytes;
          const uint64_t da = smem_desc(q_tile + box * G::kBoxBytes + 64 * cw * G::kRowBytes + off,
                                        16, 8 * G::kRowBytes, G::kLayout);
          const uint64_t db = smem_desc(k_tile(s) + box * G::kBoxBytes + off, 16, 8 * G::kRowBytes,
                                        G::kLayout);
          wgmma_ss_n128(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // Scores in log2 units; sc[j] is row my_row + 8 * ((j >> 1) & 1),
        // key k0 + 8 * (j >> 2) + 2 * quad + (j & 1).
        const int k0 = t * kTile;
        const bool edge = (k0 + kTile > p.skv) || (p.causal && k0 + kTile - 1 > qpos_lo) ||
                          (p.has_window && k0 <= qpos_hi - p.window);
        // Each condition is tested once per tile, not per score, so the
        // common path (no cap, no edge) is straight-line code.
        if (p.has_cap) {
#pragma unroll
          for (int j = 0; j < 64; ++j) sc[j] = cap_log2 * fast_tanh(sc[j] * scale_over_cap);
        } else {
#pragma unroll
          for (int j = 0; j < 64; ++j) sc[j] *= scale_log2;
        }
        if (edge) {
#pragma unroll
          for (int j = 0; j < 64; ++j) {
            const int kpos = k0 + 8 * (j >> 2) + 2 * quad + (j & 1);
            const int qpos = my_row + 8 * ((j >> 1) & 1) + p.q_offset;
            bool ok = kpos < p.skv;
            if (p.causal) ok = ok && kpos <= qpos;
            if (p.has_window) ok = ok && kpos > qpos - p.window;
            if (!ok) sc[j] = neg_inf();
          }
        }
        float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
        for (int j = 0; j < 64; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
        float alpha[2], mu[2];  // mu: the max the exponent subtracts, 0 for a row with no key yet
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          mu[r] = m_new == neg_inf() ? 0.f : m_new;
          alpha[r] = fast_exp2(m[r] - mu[r]);
          m[r] = m_new;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < D / 2; ++j) o_acc[j] *= alpha[(j >> 1) & 1];

        // P as the A operand: the pair sc[2j], sc[2j + 1] is register j % 4
        // of k step j / 4 (the S fragment's order is the A fragment's).
        uint32_t pa[kTile / 16][4];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int r = j & 1;
          const float p0 = fast_exp2(sc[2 * j] - mu[r]);
          const float p1 = fast_exp2(sc[2 * j + 1] - mu[r]);
          const __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
          l[r] += p0 + p1;  // l sums the unrounded p
          pa[j / 4][j % 4] = *reinterpret_cast<const uint32_t*>(&pb);
        }

        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint64_t db = smem_desc(v_tile(s) + kk * 16 * G::kRowBytes, G::kBoxBytes,
                                        8 * G::kRowBytes, G::kLayout);
          wgmma_pv<D>(o_acc, pa[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // Epilogue: O / l, 0 where l == 0; o_acc[4j + 2r + e] is row
    // my_row + 8 r, column 8 j + 2 quad + e.
    __nv_bfloat16* op = o + bi * p.ob + hi * p.oh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = my_row + 8 * r;
      if (row >= p.sq) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(op + row * p.os + 8 * j + 2 * quad) =
            __floats2bfloat162_rn(o_acc[4 * j + 2 * r] / l_safe, o_acc[4 * j + 2 * r + 1] / l_safe);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so the library
// needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map over (d, heads, s, b) of a bf16 tensor, boxes of
// (box columns, 1 head, 128 rows, 1 batch); strides in elements.
template <int D>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int heads, int seq, int batch,
            int64_t sh, int64_t ss, int64_t sb) {
  using G = Geometry<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * sh), static_cast<cuuint64_t>(2 * ss),
                                 static_cast<cuuint64_t>(2 * sb)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::kBox), 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b, const Params& p,
                cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return -4;
  CUtensorMap tq, tk, tv;
  const int kv_heads = p.h / p.g;
  if (!encode<D>(enc, &tq, q, p.h, p.sq, b, p.qh, p.qs, p.qb) ||
      !encode<D>(enc, &tk, k, kv_heads, p.skv, b, p.kh, p.ks, p.kb) ||
      !encode<D>(enc, &tv, v, kv_heads, p.skv, b, p.vh, p.vs, p.vb))
    return -3;
  constexpr int smem = Geometry<D>::kSmem;
  auto kernel = flash_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * p.h, (p.sq + kTile - 1) / kTile);
  kernel<<<grid, kThreadsBf16, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v, void* o, int b,
                 const Params& p, cudaStream_t s) {
  if (dtype == kF32) return launch_f32<D>(q, k, v, o, b, p, s);
  if (dtype == kBF16) return launch_bf16<D>(q, k, v, o, b, p, s);
  return -2;
}

}  // namespace

extern "C" int repro_flash_attention(
    int d, int dtype, const void* q, const void* k, const void* v, void* o,
    int b, int h, int g, int sq, int skv, int q_offset,
    int causal, int has_window, int window, int has_cap, float cap, float scale,
    long long qb, long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh, long long os,
    void* stream) {
  const Params p{h, g, sq, skv, q_offset, causal, has_window, window, has_cap, cap, scale,
                 qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The instantiated head dims; kernels/flash_attention/flash_attention.py
  // HEAD_DIMS lists the same set (a CPU test holds the two equal).
#define REPRO_HEAD_DIM(D) \
  if (d == D) return launch_dtype<D>(dtype, q, k, v, o, b, p, s);
  REPRO_HEAD_DIM(32)
  REPRO_HEAD_DIM(64)
  REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
  return -1;
}
