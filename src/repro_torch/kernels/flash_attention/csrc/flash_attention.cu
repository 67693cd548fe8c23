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
// on O(s * d) bytes, thousands of flops per byte. This kernel uses no
// tensor cores (f32 FFMA for both products, bf16 converted to f32 on load),
// so its roof is the FP32 rate outside them, about 67 TFLOP/s on the H100
// SXM; the bf16 bound at the tensor cores' 989 TFLOP/s is out of its reach
// until the products move to wgmma (later work).
//
// Design (simple and right first; TMA, wgmma and warp specialisation are
// later work):
// * One CTA of 256 threads (16 x 16) per (batch * head, 64-query tile). It
//   walks the 64-key tiles that its queries can see; the TPU's sequential
//   kv grid axis becomes this loop, and m, l and the accumulator live in
//   registers. Each thread owns 4 query rows (strided by 16) and, for the
//   scores, 4 key columns; row max and row sum are reduced over the 16
//   threads of a row with warp shuffles.
// * The CTA tile (64 x 64) is the kernel's own choice. The caller's
//   block_q / block_k only set the wrapper's divisibility contract: the
//   reference's default block_k = 512 at d = 128 in f32 is a 256 KB K
//   tile, which no CTA holds. The tile changes only the order of the sums.
// * Causal and window skipping are loop bounds, not masked work: the first
//   and last kv tiles come from q_offset, the window and the tile's first
//   and last query. Elementwise masks apply only in edge tiles (a tile that
//   crosses the diagonal, the window's lower edge or the end of the keys).
// * A masked score is -inf. A row that has seen no key yet keeps m = -inf;
//   the exponent then uses 0 in place of m, so exp(-inf) = 0 and never
//   exp(-inf - -inf) = NaN, and the row ends with l == 0 and is written 0.
// * Q and K are staged transposed in shared memory (f32, one float of
//   padding per row, so transposed stores and the reads of the products
//   avoid bank conflicts), V row-major, P (the tile's probabilities) with
//   one float of padding. At d = 128 that is 113 KB, above the 48 KB static
//   limit, so the kernel takes dynamic shared memory after
//   cudaFuncSetAttribute(MaxDynamicSharedMemorySize).
// * In bf16, p is rounded to bf16 before the PV product (as the TPU kernel
//   casts p to v's dtype), l sums the unrounded p, and the output is
//   written in q's dtype. bf16 is converted only through the intrinsics.
// * Layout: element (b, s, h, e) of q, k, v and o lies at
//   b * stride_b + h * stride_h + s * stride_s + e, so the model layout
//   [b, s, h, d] and the head-flattened [bh, s, d] (h = 1) both run without
//   a copy. Query head h reads kv head h / g (GQA without repeating k, v).
//
// C interface for ctypes: repro_flash_attention(...) launches on the given
// stream and returns cudaGetLastError() as an int (0 = launched), -1 for a
// head dim that is not instantiated and -2 for a dtype it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows of a CTA tile
constexpr int kBK = 64;        // key rows of a kv tile
constexpr int kThreadsX = 16;  // threads along a tile's columns
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kCols = kBK / kThreadsX;  // score columns per thread

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

// p as the PV product sees it: in v's dtype.
__device__ __forceinline__ float round_p(float p, float*) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Reduce over the 16 threads of one row (lanes 0-15 or 16-31 of a warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return D * (kBQ + 1) + D * (kBK + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Params p) {
  static_assert(D % kThreadsX == 0, "head dim must be a multiple of 16");
  constexpr int DC = D / kThreadsX;  // output columns per thread
  extern __shared__ float4 smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [D][kBQ + 1], Q transposed
  float* kt = qt + D * (kBQ + 1);                   // [D][kBK + 1], K transposed
  float* vt = kt + D * (kBK + 1);                   // [kBK][D]
  float* pt = vt + kBK * D;                         // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;
  const int bi = blockIdx.y / p.h;
  const int hi = blockIdx.y % p.h;
  const int kvh = hi / p.g;
  const T* qp = q + bi * p.qb + hi * p.qh;
  const T* kp = k + bi * p.kb + kvh * p.kh;
  const T* vp = v + bi * p.vb + kvh * p.vh;
  T* op = o + bi * p.ob + hi * p.oh;

  const int row0 = blockIdx.x * kBQ;
  const int rows = min(kBQ, p.sq - row0);
  const int qpos_lo = row0 + p.q_offset;             // first query's position
  const int qpos_hi = row0 + rows - 1 + p.q_offset;  // last query's position

  // The keys this tile's queries can see: [kv_begin, kv_end).
  int kv_begin = 0, kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, qpos_hi + 1);
  if (p.has_window) kv_begin = max(kv_begin, qpos_lo - p.window + 1);

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    qt[c * (kBQ + 1) + r] = r < rows ? to_f32(qp[(row0 + r) * p.qs + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (kv_begin / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers of kt, vt and pt are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < p.skv;
      kt[c * (kBK + 1) + r] = in ? to_f32(kp[(k0 + r) * p.ks + c]) : 0.f;
      vt[r * D + c] = in ? to_f32(vp[(k0 + r) * p.vs + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qt[e * (kBQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = kt[e * (kBK + 1) + tx + kThreadsX * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

    // An edge tile holds some key that some query of the tile must not see.
    const bool edge = (k0 + kBK > p.skv) || (p.causal && k0 + kBK - 1 > qpos_lo) ||
                      (p.has_window && k0 <= qpos_hi - p.window);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = row0 + ty + 16 * i + p.q_offset;
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j] * p.scale;
        if (p.has_cap) x = p.cap * tanhf(x / p.cap);
        if (edge) {
          const int kpos = k0 + tx + kThreadsX * j;
          bool ok = kpos < p.skv;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.has_window) ok = ok && kpos > qpos - p.window;
          if (!ok) x = neg_inf();
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_use = m_new == neg_inf() ? 0.f : m_new;  // no -inf - -inf
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pj = expf(s[i][j] - m_use);
        sum += pj;
        pt[(ty + 16 * i) * (kBK + 1) + tx + kThreadsX * j] = round_p(pj, (T*)nullptr);
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[DC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = pt[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vt[kk * D + tx + kThreadsX * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      op[(row0 + r) * p.os + tx + kThreadsX * c] = from_f32<T>(acc[i][c] / l_safe);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b, const Params& p,
           cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = flash_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + kBQ - 1) / kBQ, b * p.h);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v, void* o, int b,
                 const Params& p, cudaStream_t s) {
  if (dtype == kF32) return launch<D, float>(q, k, v, o, b, p, s);
  if (dtype == kBF16) return launch<D, __nv_bfloat16>(q, k, v, o, b, p, s);
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
