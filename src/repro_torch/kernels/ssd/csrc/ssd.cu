// Mamba-2 SSD chunk scan for Hopper (sm_90a), f32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd.py:72 ssd_scan_kernel
// (body _ssd_kernel, :28). Per chunk of Q tokens of one (batch, head):
//   cum   = cumsum(logda)                                   [Q]
//   L     = exp(cum_i - cum_j) for i >= j, else 0           [Q, Q]
//   y     = ((C B^T) * L) xbar + exp(cum) * (C state^T)     [Q, p]
//   state = exp(cum_Q) * state + (exp(cum_Q - cum) * xbar)^T B   [p, n]
// with the [p, n] state carried from chunk to chunk.
//
// Bound on this card: operations. At mamba2-1.3b's widths (Q = 256,
// p = 64, n = 128, one B/C group for h = 64 heads) a token needs
// (Q + 1) n flops for C B^T once per group, and (Q + 1) p + 4pn per head
// for the decayed product with xbar, y_inter and the state update, on
// 4(p + 2n/h + 1) + 4p bytes per head; without tensor cores (f32 FFMA, as
// the reference's f32 tolerance needs) the roof is the FP32 rate outside
// them, about 67 TFLOP/s on the H100 SXM. This kernel recomputes C B^T for
// every head of a group (h / g times the scores' minimum), the first work
// for the redesign to share.
//
// Design (simple and right first):
// * One CTA of 256 threads (16 x 16) per (batch, head) walks the chunks in
//   order with the f32 state in shared memory: that loop replaces the TPU's
//   sequential chunk grid axis, which has no meaning on Hopper. Its limit is
//   parallelism: b * h CTAs (128 at b = 2 on mamba2-1.3b, against 132
//   SMs). The split into chunk-state, state-passing and chunk-scan kernels
//   is the later fix.
// * The Q x Q score matrix (256 KB in f32 at Q = 256) is never resident:
//   the chunk's outputs are computed in strips of 64 rows, and each strip
//   walks 64-column blocks of (C B^T) * L up to its diagonal block only, so
//   the masked upper triangle costs nothing.
// * cum_i - cum_j is positive above the diagonal (logda < 0), and its exp
//   overflows to inf at long chunks; inf * 0 would be NaN. The decay is
//   computed only where i >= j and is never multiplied by a 0/1 mask.
// * y reads the state from before the chunk; the state is updated only
//   after every strip of the chunk is written, behind a barrier.
// * cum is kept in f64 (warp 0 scans, each lane a contiguous run, then the
//   lane totals with shuffles), and cum_i - cum_j is taken in f64 before the
//   f32 exp. |cum| reaches hundreds within a chunk, so an f32 cum carries
//   an error of ulp(|cum|) into every decay, and at mamba2-1.3b's widths
//   that alone comes near the reference's 3e-4 tolerance. The f64 cum costs
//   Q doubles of shared memory and one f64 subtraction per score, against n
//   FMAs per score.
// * Shared memory (dynamic, above 48 KB at the model's widths): cum [Q]
//   (f64), the state [p][n + 1], a strip of C [64][n + 1], a block of B
//   [64][n + 1], a block of xbar [64][p] and the strip's scores [64][65];
//   rows padded by one float so that reads across rows avoid bank
//   conflicts. 131 KB at p = 64, n = 128, Q = 256.
// * Layout: element (b, t, h, e) of xbar and y lies at
//   b * stride_b + h * stride_h + t * stride_t + e, logda (b, t, h) likewise,
//   and B and C (b, t, g, e) with g = h / heads_per_group, so the model
//   layout runs without repeating B and C to heads and the head-flattened
//   [bh, s, *] layout is the case h = 1.
//
// C interface for ctypes: repro_ssd_scan(...) launches on the given stream
// and returns cudaGetLastError() as an int (0 = launched), -1 for a head dim
// p that is not instantiated and -3 for n above kMaxN or a chunk above
// kMaxChunk. Every shape it accepts fits the card's shared memory (a
// static_assert below), so no caller needs the layout's size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 64;         // rows of a strip, columns of a block
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kR / 16;  // strip rows per thread
constexpr int kMaxN = 128;     // largest state dim n
constexpr int kNJ = kMaxN / 16;  // state columns per thread
constexpr int kMaxChunk = 4096;  // longest chunk Q
constexpr int kMaxP = 128;     // largest head dim instantiated below
constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory a CTA may use on Hopper

struct Params {
  int h;       // heads
  int hg;      // heads per B/C group
  int s;       // sequence length
  int chunk;   // Q
  int n;       // state dim
  int64_t xb, xh, xs, lb, lh, ls, bb, bg, bs, yb, yh, ys;
};

// Dynamic shared memory of one CTA, in bytes (the layout is in ssd_kernel).
constexpr int smem_bytes(int p, int n, int chunk) {
  return chunk * static_cast<int>(sizeof(double)) +
         (p * (n + 1) + 2 * kR * (n + 1) + kR * p + kR * (kR + 1)) *
             static_cast<int>(sizeof(float));
}
static_assert(smem_bytes(kMaxP, kMaxN, kMaxChunk) <= kSmemLimit,
              "the largest accepted shape must fit the shared memory");

template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ logda,
           const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ y,
           Params p) {
  static_assert(P % 16 == 0, "head dim must be a multiple of 16");
  constexpr int PJ = P / 16;  // head-dim columns per thread
  const int n = p.n, n1 = p.n + 1, Q = p.chunk;
  extern __shared__ float4 smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);  // [Q]
  float* state = reinterpret_cast<float*>(cum + Q);   // [P][n + 1]
  float* cs = state + P * n1;                         // [kR][n + 1], strip of C
  float* bsm = cs + kR * n1;                          // [kR][n + 1], block of B
  float* xsm = bsm + kR * n1;                         // [kR][P], block of xbar
  float* ss = xsm + kR * P;                           // [kR][kR + 1], scores

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bi = blockIdx.x / p.h;
  const int hi = blockIdx.x % p.h;
  const int gi = hi / p.hg;
  const float* xp = x + bi * p.xb + hi * p.xh;
  const float* lp = logda + bi * p.lb + hi * p.lh;
  const float* bp = bm + bi * p.bb + gi * p.bg;
  const float* cp = cm + bi * p.bb + gi * p.bg;
  float* yp = y + bi * p.yb + hi * p.yh;

  for (int idx = tid; idx < P * n1; idx += kThreads) state[idx] = 0.f;

  for (int c0 = 0; c0 < p.s; c0 += Q) {
    // ---- cum = cumsum(logda) over the chunk ----
    for (int t = tid; t < Q; t += kThreads) cum[t] = lp[(c0 + t) * p.ls];
    __syncthreads();
    if (tid < 32) {
      const int run = (Q + 31) / 32;
      const int lo = min(Q, tid * run), hi_ = min(Q, lo + run);
      double total = 0.0;
      for (int t = lo; t < hi_; ++t) total += cum[t];
      double incl = total;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      double run_sum = incl - total;
      for (int t = lo; t < hi_; ++t) {
        run_sum += cum[t];
        cum[t] = run_sum;
      }
    }
    __syncthreads();
    const double total = cum[Q - 1];

    // ---- outputs, in strips of kR rows ----
    for (int i0 = 0; i0 < Q; i0 += kR) {
      for (int idx = tid; idx < kR * n; idx += kThreads) {
        const int r = idx / n, e = idx % n;
        cs[r * n1 + e] = i0 + r < Q ? cp[(c0 + i0 + r) * p.bs + e] : 0.f;
      }
      __syncthreads();

      // y_inter = exp(cum_i) * (C_i . state^T), from the state before the chunk
      float acc[kRows][PJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
      }
      for (int e = 0; e < n; ++e) {
        float a[kRows], b[PJ];
#pragma unroll
        for (int i = 0; i < kRows; ++i) a[i] = cs[(ty + 16 * i) * n1 + e];
#pragma unroll
        for (int j = 0; j < PJ; ++j) b[j] = state[(tx + 16 * j) * n1 + e];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = i0 + ty + 16 * i;
        const float d = row < Q ? expf(static_cast<float>(cum[row])) : 0.f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] *= d;
      }

      // y_intra: blocks of kR columns up to the strip's diagonal block
      for (int j0 = 0; j0 <= i0; j0 += kR) {
        __syncthreads();  // the previous block's readers of bsm, xsm, ss are done
        for (int idx = tid; idx < kR * n; idx += kThreads) {
          const int r = idx / n, e = idx % n;
          bsm[r * n1 + e] = j0 + r < Q ? bp[(c0 + j0 + r) * p.bs + e] : 0.f;
        }
        for (int idx = tid; idx < kR * P; idx += kThreads) {
          const int r = idx / P, e = idx % P;
          xsm[r * P + e] = j0 + r < Q ? xp[(c0 + j0 + r) * p.xs + e] : 0.f;
        }
        __syncthreads();
        float sc[kRows][kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int j = 0; j < kRows; ++j) sc[i][j] = 0.f;
        }
        for (int e = 0; e < n; ++e) {
          float a[kRows], b[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) a[i] = cs[(ty + 16 * i) * n1 + e];
#pragma unroll
          for (int j = 0; j < kRows; ++j) b[j] = bsm[(tx + 16 * j) * n1 + e];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
#pragma unroll
            for (int j = 0; j < kRows; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int row = i0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int col = j0 + tx + 16 * j;
            // exp only on and below the diagonal: above it, it may be inf.
            const float val = (row < Q && col <= row)
                                  ? sc[i][j] * expf(static_cast<float>(cum[row] - cum[col]))
                                  : 0.f;
            ss[(ty + 16 * i) * (kR + 1) + tx + 16 * j] = val;
          }
        }
        __syncthreads();
        for (int cc = 0; cc < kR; ++cc) {
          float a[kRows], b[PJ];
#pragma unroll
          for (int i = 0; i < kRows; ++i) a[i] = ss[(ty + 16 * i) * (kR + 1) + cc];
#pragma unroll
          for (int j = 0; j < PJ; ++j) b[j] = xsm[cc * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
#pragma unroll
            for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = i0 + ty + 16 * i;
        if (row >= Q) continue;
#pragma unroll
        for (int j = 0; j < PJ; ++j) yp[(c0 + row) * p.ys + tx + 16 * j] = acc[i][j];
      }
      __syncthreads();  // every reader of cs (and of the state) is done
    }

    // ---- state = exp(total) * state + (exp(total - cum) * xbar)^T B ----
    float st[PJ][kNJ];
#pragma unroll
    for (int i = 0; i < PJ; ++i) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j) st[i][j] = 0.f;
    }
    for (int j0 = 0; j0 < Q; j0 += kR) {
      for (int idx = tid; idx < kR * n; idx += kThreads) {
        const int r = idx / n, e = idx % n;
        bsm[r * n1 + e] = j0 + r < Q ? bp[(c0 + j0 + r) * p.bs + e] : 0.f;
      }
      for (int idx = tid; idx < kR * P; idx += kThreads) {
        const int r = idx / P, e = idx % P;
        xsm[r * P + e] =
            j0 + r < Q ? xp[(c0 + j0 + r) * p.xs + e] * expf(static_cast<float>(total - cum[j0 + r]))
                       : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < kR; ++r) {
        float a[PJ], b[kNJ];
#pragma unroll
        for (int i = 0; i < PJ; ++i) a[i] = xsm[r * P + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) b[j] = tx + 16 * j < n ? bsm[r * n1 + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < PJ; ++i) {
#pragma unroll
          for (int j = 0; j < kNJ; ++j) st[i][j] = fmaf(a[i], b[j], st[i][j]);
        }
      }
      __syncthreads();
    }
    const float decay = expf(static_cast<float>(total));
#pragma unroll
    for (int i = 0; i < PJ; ++i) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int e = tx + 16 * j;
        if (e < n) {
          float* sp = state + (ty + 16 * i) * n1 + e;
          *sp = decay * *sp + st[i][j];
        }
      }
    }
    __syncthreads();
  }
}

template <int P>
int launch(const float* x, const float* logda, const float* bm, const float* cm, float* y,
           int b, const Params& p, cudaStream_t stream) {
  static_assert(P <= kMaxP, "kMaxP bounds the shared memory of every instantiation");
  const int smem = smem_bytes(P, p.n, p.chunk);
  auto kernel = ssd_kernel<P>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b * p.h, kThreads, smem, stream>>>(x, logda, bm, cm, y, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_ssd_scan(
    int pdim, const void* x, const void* logda, const void* bm, const void* cm, void* y,
    int b, int h, int hg, int s, int chunk, int n,
    long long xb, long long xh, long long xs, long long lb, long long lh, long long ls,
    long long bb, long long bg, long long bs, long long yb, long long yh, long long ys,
    void* stream) {
  const Params p{h, hg, s, chunk, n, xb, xh, xs, lb, lh, ls, bb, bg, bs, yb, yh, ys};
  const float* xf = static_cast<const float*>(x);
  const float* lf = static_cast<const float*>(logda);
  const float* bf = static_cast<const float*>(bm);
  const float* cf = static_cast<const float*>(cm);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > kMaxN || chunk > kMaxChunk) return -3;
  // The instantiated head dims (none above kMaxP); kernels/ssd/ssd.py
  // HEAD_DIMS lists the same set (a CPU test holds the two equal).
#define REPRO_HEAD_DIM(P) \
  if (pdim == P) return launch<P>(xf, lf, bf, cf, yf, b, p, st);
  REPRO_HEAD_DIM(16)
  REPRO_HEAD_DIM(32)
  REPRO_HEAD_DIM(64)
  REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
  return -1;
}
