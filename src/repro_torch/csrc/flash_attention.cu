// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py ::
// flash_attention_pallas (body _fa_kernel, pallas_call at kernel.py:115).
// The JAX package has no backward kernel (the Pallas kernel cannot be
// differentiated); the backward here is this port's own, and computes
// the gradient that autograd of the plain attention gives.
//
// Computes, for q (b, hq, lq, d) and k, v (b, hkv, lk, d), contiguous,
// bf16 or fp32, hq % hkv == 0, d in {16, 32, 64, 128}, lq <= lk when
// causal:
//   forward   o = softmax(mask(scale * q k^T)) v in q's dtype, and the
//             row logsumexp lse (b, hq, lq) fp32 of the masked scores;
//   backward  dq, dk, dv (in the inputs' dtype) from do, o and lse.
// GQA maps q head h to kv head h / (hq / hkv), with no repeat.  The
// causal mask puts the queries at the end of the key window: query i
// sees key j iff j <= i + (lk - lq).  Masked scores are -1e30, as in the
// TPU kernel, so a masked key gets P == 0 exactly, padding keys and
// padding query rows of a ragged last tile included.  Tiles above the
// causal diagonal are skipped (kernel.py:46-48).
//
// Two routes, by dtype:
//   bf16  tensor cores.  Forward: fa_fwd_wgmma_kernel (wgmma + TMA) at
//         d = 64 and 128, fa_fwd_mma_kernel (mma.sync) at d = 16 and 32,
//         whose rows are narrower than one 128-byte swizzle chunk.
//         Backward: fa_bwd_delta_kernel, fa_bwd_dkdv_mma_kernel,
//         fa_bwd_dq_mma_kernel (mma.sync m16n8k16).
//   fp32  the FMA kernels (fa_fwd_kernel, fa_bwd_*_kernel): every
//         operand widened to fp32, every sum an fp32 fmaf chain, no
//         TF32.
//
// Precision of the bf16 route.  The TPU kernel keeps everything inside in
// fp32 (kernel.py:52).  Q K^T and dO V^T take bf16 operands as they are:
// each product of two bf16 values is exact in the fp32 accumulator, so
// only the fp32 sums' order differs.  The scale is applied to the fp32
// scores (not to q before the product): a difference of fp32 rounding
// only.  P V, P^T dO, dS^T Q and dS K take an fp32 operand (P or dS);
// rounded once to bf16 it would carry 2^-9 of its size into outputs that
// cancel toward 0, far beyond the 2e-5 the output is held to.  So it is
// split, x = hi + lo with hi = bf16(x) and lo = bf16(x - hi), and each
// such product is issued twice (hi, then lo): the residual is about
// 2^-17 |x|.  The forward issues 3 bf16 products, the backward 10.
//
// What bounds them on the H100.  At the training shape (l = 4096,
// d = 128) attention does ~l/2 multiply-adds per byte it must move, so
// the card's bound is its bf16 tensor-core rate.  The wgmma forward
// reaches a quarter of it: each consumer runs its score product, the
// softmax and the P V product in turn, with no overlap inside a
// warpgroup, and the split adds half again to the products.  The
// mma.sync backward is held by shared memory: every warp reads its
// fragments by ldmatrix, and each warp of a block reads the whole tile
// of the other operand.  The fp32 route is bound by the FMA units' rate
// and by shared-memory load issue.
//
// Design, bf16 forward (wgmma).  A block (384 threads) owns 128 q rows of
// one head.  Warpgroup 0 is the producer: one thread loads the q tile
// once and streams 64-key k and v tiles into a ring of kStages buffers by
// TMA (3-D tensor maps (d, rows, b * h), so a ragged tile reads zeros,
// not the next head; 128-byte swizzle, d = 128 in two 64-column boxes),
// with full/empty mbarriers.  Warpgroups 1 and 2 own 64 rows each
// (setmaxnreg moves registers from the producer to them): S = Q K^T by
// wgmma with both operands in shared memory, the scale and mask in fp32,
// the online softmax (m, l) in registers in the accumulator layout, then
// O += P_hi V + P_lo V by wgmma with P from registers and V as an
// MN-major operand.  O is written in bf16, lse in fp32.  The mma.sync
// forward is the same loop for one 4-warp block of 64 rows, k and v
// double-buffered by cp.async.
//
// Design, bf16 backward (mma.sync m16n8k16 bf16, ldmatrix, cp.async).
// Tiles sit in shared memory at row stride d + 8, so the 8 rows of an
// ldmatrix fall in 8 distinct bank groups.
//   fa_bwd_delta_kernel     D = rowsum(do * o) in fp32, one warp per row.
//   fa_bwd_dkdv_mma_kernel  one block per (b * hkv, 64-key tile), a warp
//                           per 16 keys: loops over the group's q heads
//                           and the 32-row q tiles under the diagonal
//                           (q, do, lse, D double-buffered), computing
//                           S^T = K Q^T and dP^T = V dO^T with keys as
//                           rows, so that P^T and dS^T are already the
//                           A operands of dV += P^T dO and dK += dS^T Q.
//   fa_bwd_dq_mma_kernel    one block per (b * hq, 64-row q tile), a warp
//                           per 16 rows: loops over the kv tiles as the
//                           forward does (k, v double-buffered), S and
//                           dP again, dQ += dS K.
// P is recomputed as exp(scale S - lse) from the forward's logsumexp.
// The dK/dV and dQ kernels each compute S and dP: the price of having no
// atomics.  Each output element is summed by one thread in one fixed
// order: two runs give bitwise-equal results.
//
// Design, fp32 route (unchanged).  A block is 256 threads, a 16 x 16 grid
// (ty, tx); tiles are 64 query rows by 64 keys.  Thread (ty, tx) owns
// query rows ty + 16 i and keys tx + 16 j (i, j < 4) of a score tile, and
// output columns tx + 16 jj (jj < d / 16).  Tiles sit in shared memory in
// fp32 with an odd row stride (d + 1), so the 16 lanes of a row group
// read 16 banks.
//   fa_fwd_kernel        one block per (b * hq, q tile): loops over the
//                        kv tiles the causal diagonal leaves, keeps the
//                        running (m, l, acc) in registers, writes o, lse.
//   fa_bwd_delta_kernel  as above.
//   fa_bwd_dkdv_kernel   one block per (b * hkv, kv tile): loops over the
//                        group q heads that share the kv head, and over
//                        the q tiles under the diagonal; recomputes
//                        P = exp(s - lse), accumulates dV = P^T dO and
//                        dK = dS^T (scale q), dS = P (dP - D).
//   fa_bwd_dq_kernel     one block per (b * hq, q tile): loops over the
//                        kv tiles as the forward does, dQ = scale dS K.
// No float atomics on either route.
#include <cuda.h>             // CUtensorMap and its encoder's types
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kTile = 64;          // query rows, and keys, per tile
constexpr int kR = kTile / 16;     // score rows (and keys) per thread
constexpr int kPS = kTile + 1;     // row stride of a score tile
constexpr float kNeg = -1.0e30f;   // the TPU kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// The 16 lanes of a row group (lanes xor 1, 2, 4, 8) hold one row; a
// butterfly leaves the same bits in every lane of the group.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Rows [row0, row0 + kTile) of a (n_rows, D) matrix into shared memory
// at row stride D + 1, widened to fp32 and times `mul`; zero past n_rows.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int row0, int n_rows, float mul) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < n_rows ? to_f32(src[static_cast<size_t>(row) * D + c]) * mul
                     : 0.f;
  }
}

// s[i][j] = sum over dd of a[row i][dd] * b[key j][dd], dd ascending,
// for this thread's rows ty + 16 i of `a` and keys tx + 16 j of `b`.
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[kR][kR],
                                         const float* a, const float* b,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    float av[kR], bv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + dd];
#pragma unroll
    for (int j = 0; j < kR; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + dd];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// Shared-memory floats of each kernel (dynamic shared memory).
template <int D>
constexpr int fwd_smem_floats() {
  // q, k (then P, when P is the larger), v
  return kTile * (D + 1) +
         kTile * ((D + 1) > kPS ? (D + 1) : kPS) + kTile * (D + 1);
}
template <int D>
constexpr int bwd_smem_floats() {
  // q, do, k, v, P, dS, lse, D
  return 4 * kTile * (D + 1) + 2 * kTile * kPS + 2 * kTile;
}

// Number of kv tiles the q tile starting at q0 needs.
__device__ __forceinline__ int kv_tiles(int q0, int lq, int lk, int causal) {
  int n = (lk + kTile - 1) / kTile;
  if (causal) {
    const int last = min(q0 + kTile, lq) - 1 + (lk - lq);
    n = min(n, last / kTile + 1);
  }
  return n;
}

// ---------------------------------------------------------------------------
// fp32 route: forward (FMA units)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int hq, int hkv, int lq, int lk,
              float scale, int causal) {
  constexpr int S = D + 1;
  constexpr int kJ = D / 16;           // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // [kTile][S], q * scale
  float* ks = qs + kTile * S;          // [kTile][S] k, then P [kTile][kPS]
  float* vs = ks + kTile * (S > kPS ? S : kPS);   // [kTile][S]

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int bh = blockIdx.y;
  const int bkv = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const T* qp = q + static_cast<size_t>(bh) * lq * D;
  const T* kp = k + static_cast<size_t>(bkv) * lk * D;
  const T* vp = v + static_cast<size_t>(bkv) * lk * D;
  const int q0 = qt * kTile, off = lk - lq;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage<T, D>(qs, qp, q0, lq, scale);

  float m[kR], l[kR], acc[kR][kJ];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) acc[i][jj] = 0.f;
  }

  const int n_kt = kv_tiles(q0, lq, lk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                   // the last tile's P and v are read
    stage<T, D>(ks, kp, k0, lk, 1.f);
    stage<T, D>(vs, vp, k0, lk, 1.f);
    __syncthreads();
    float s[kR][kR];
    tile_dot<D>(s, qs, ks, ty, tx);
    float alpha[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qpos = q0 + ty + 16 * i + off;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < lk && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        s[i][j] = expf(s[i][j] - m_new);     // now p
        sum += s[i][j];
      }
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + row_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();                   // every thread has read k
    float* ps = ks;
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j)
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = s[i][j];
    __syncthreads();
    float pv[kR][kJ];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) pv[i][jj] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pr[kR], vr[kJ];
#pragma unroll
      for (int i = 0; i < kR; ++i) pr[i] = ps[(ty + 16 * i) * kPS + kk];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) vr[jj] = vs[kk * S + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
          pv[i][jj] = fmaf(pr[i], vr[jj], pv[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
        acc[i][jj] = acc[i][jj] * alpha[i] + pv[i][jj];
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= lq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (static_cast<size_t>(bh) * lq + row) * D;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
      orow[tx + 16 * jj] = from_f32<T>(acc[i][jj] / li);
    if (tx == 0) lse[static_cast<size_t>(bh) * lq + row] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// fp32 route: backward (FMA units); the row sums D serve both routes
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void fa_bwd_delta_kernel(const T* __restrict__ o,
                                    const T* __restrict__ dout,
                                    float* __restrict__ delta, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;            // whole warps leave together
  const size_t base = static_cast<size_t>(row) * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s = fmaf(to_f32(dout[base + c]), to_f32(o[base + c]), s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(kFull, s, w);
  if (lane == 0) delta[row] = s;
}

// P and dS of one (q tile, kv tile) pair into ps and dss ([q row][key]),
// from the staged q * scale, do, k, v and the rows' lse and D.
template <int D>
__device__ __forceinline__ void p_and_ds(
    float* ps, float* dss, const float* qs, const float* dos,
    const float* ks, const float* vs, const float* lse_s,
    const float* dl_s, int q0, int k0, int lq, int lk, int causal, int ty,
    int tx) {
  float s[kR][kR], dp[kR][kR];
  tile_dot<D>(s, qs, ks, ty, tx);
  tile_dot<D>(dp, dos, vs, ty, tx);
  const int off = lk - lq;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty + 16 * i;
    const int qrow = q0 + r;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool ok = qrow < lq && kpos < lk &&
                      (!causal || kpos <= qrow + off);
      const float p = ok ? expf(s[i][j] - lse_s[r]) : 0.f;
      ps[r * kPS + tx + 16 * j] = p;
      dss[r * kPS + tx + 16 * j] = p * (dp[i][j] - dl_s[r]);
    }
  }
}

template <int D>
struct BwdSmem {
  float *qs, *dos, *ks, *vs, *ps, *dss, *lse_s, *dl_s;
  __device__ explicit BwdSmem(float* base) {
    qs = base;
    dos = qs + kTile * (D + 1);
    ks = dos + kTile * (D + 1);
    vs = ks + kTile * (D + 1);
    ps = vs + kTile * (D + 1);
    dss = ps + kTile * kPS;
    lse_s = dss + kTile * kPS;
    dl_s = lse_s + kTile;
  }
};

// The q tile's q * scale, do, lse and D into shared memory (zero rows,
// lse and D past lq).
template <typename T, int D>
__device__ __forceinline__ void stage_q_side(
    const BwdSmem<D>& sm, const T* __restrict__ q, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int bh,
    int q0, int lq, float scale) {
  const size_t base = static_cast<size_t>(bh) * lq;
  stage<T, D>(sm.qs, q + base * D, q0, lq, scale);
  stage<T, D>(sm.dos, dout + base * D, q0, lq, 1.f);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    sm.lse_s[threadIdx.x] = row < lq ? lse[base + row] : 0.f;
    sm.dl_s[threadIdx.x] = row < lq ? delta[base + row] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int hq, int hkv, int lq, int lk,
                   float scale, int causal) {
  constexpr int S = D + 1;
  constexpr int kJ = D / 16;
  extern __shared__ float smem[];
  const BwdSmem<D> sm(smem);

  const int kt = blockIdx.x;
  const int bkv = blockIdx.y;
  const int group = hq / hkv;
  const int bh0 = (bkv / hkv) * hq + (bkv % hkv) * group;
  const int k0 = kt * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t kv_base = static_cast<size_t>(bkv) * lk * D;

  stage<T, D>(sm.ks, k + kv_base, k0, lk, 1.f);
  stage<T, D>(sm.vs, v + kv_base, k0, lk, 1.f);

  // this thread's keys ty + 16 i, columns tx + 16 jj
  float dka[kR][kJ], dva[kR][kJ];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) dka[i][jj] = dva[i][jj] = 0.f;

  // the first q tile with a row that sees key k0
  const int first_qt = causal ? max(0, k0 - (lk - lq)) / kTile : 0;
  const int n_qt = (lq + kTile - 1) / kTile;
  for (int g = 0; g < group; ++g) {
    for (int qt = first_qt; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();                 // the last tile's P and dS are read
      stage_q_side<T, D>(sm, q, dout, lse, delta, bh0 + g, q0, lq, scale);
      __syncthreads();
      p_and_ds<D>(sm.ps, sm.dss, sm.qs, sm.dos, sm.ks, sm.vs, sm.lse_s,
                  sm.dl_s, q0, k0, lq, lk, causal, ty, tx);
      __syncthreads();
      // dV[key] += P[r][key] do[r];  dK[key] += dS[r][key] (q[r] * scale)
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        float pr[kR], dsr[kR], dor[kJ], qr[kJ];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          pr[i] = sm.ps[r * kPS + ty + 16 * i];
          dsr[i] = sm.dss[r * kPS + ty + 16 * i];
        }
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          dor[jj] = sm.dos[r * S + tx + 16 * jj];
          qr[jj] = sm.qs[r * S + tx + 16 * jj];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int jj = 0; jj < kJ; ++jj) {
            dva[i][jj] = fmaf(pr[i], dor[jj], dva[i][jj]);
            dka[i][jj] = fmaf(dsr[i], qr[jj], dka[i][jj]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= lk) continue;
    const size_t base = kv_base + static_cast<size_t>(key) * D;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      dk[base + tx + 16 * jj] = from_f32<T>(dka[i][jj]);
      dv[base + tx + 16 * jj] = from_f32<T>(dva[i][jj]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 int hq, int hkv, int lq, int lk, float scale, int causal) {
  constexpr int S = D + 1;
  constexpr int kJ = D / 16;
  extern __shared__ float smem[];
  const BwdSmem<D> sm(smem);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int bkv = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const size_t kv_base = static_cast<size_t>(bkv) * lk * D;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage_q_side<T, D>(sm, q, dout, lse, delta, bh, q0, lq, scale);

  float dqa[kR][kJ];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) dqa[i][jj] = 0.f;

  const int n_kt = kv_tiles(q0, lq, lk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                   // the last tile's dS and k are read
    stage<T, D>(sm.ks, k + kv_base, k0, lk, 1.f);
    stage<T, D>(sm.vs, v + kv_base, k0, lk, 1.f);
    __syncthreads();
    p_and_ds<D>(sm.ps, sm.dss, sm.qs, sm.dos, sm.ks, sm.vs, sm.lse_s,
                sm.dl_s, q0, k0, lq, lk, causal, ty, tx);
    __syncthreads();
    // dQ[r] += dS[r][key] k[key]   (times scale at the end)
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsr[kR], kr[kJ];
#pragma unroll
      for (int i = 0; i < kR; ++i) dsr[i] = sm.dss[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) kr[jj] = sm.ks[c * S + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
          dqa[i][jj] = fmaf(dsr[i], kr[jj], dqa[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= lq) continue;
    T* out = dq + (static_cast<size_t>(bh) * lq + row) * D;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
      out[tx + 16 * jj] = from_f32<T>(dqa[i][jj] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (bf16 products, fp32 accumulation)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;       // 4 warps, 16 rows of a tile each
constexpr int kBwdRows = 32;          // q rows per step of the dK/dV kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared without the registers; zero fill
// when !valid (no bytes are read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, one row address from each
// lane (lanes 8i..8i+7 give matrix i); lane l receives row l / 4, columns
// 2 (l % 4) and + 1 of each (of the transpose with ldsm4_t).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

// c (16 x 8 fp32) += a (16 x 16 bf16) b (16 x 8 bf16).  Lane l (g = l / 4,
// t = l % 4) holds a at rows g, g + 8 and k 2t, 2t + 1, 2t + 8, 2t + 9;
// b at k 2t, 2t + 1, 2t + 8, 2t + 9 and column g; c at rows g, g + 8 and
// columns 2t, 2t + 1.
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) ~ hi + lo: hi = bf16(x), lo = bf16(x - hi), so that hi + lo
// is within about 2^-17 |x| of x.
__device__ __forceinline__ void split_bf16(float x0, float x1,
                                           uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// An accumulator's n-tiles c0 (columns 0-7) and c1 (8-15) are, register
// for register, the A operand of the 16 x 16 k-step they span: split
// into its bf16 hi and lo halves.
__device__ __forceinline__ void acc_to_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// Rows [row0, row0 + R) of a (n_rows, D) bf16 matrix into shared memory
// at row stride D + 8 (so the 8 row addresses of an ldmatrix fall in 8
// distinct 16-byte bank groups), by cp.async; rows past n_rows read 0.
template <int R, int D>
__device__ __forceinline__ void load_rows(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int kC = D / 8;            // 16-byte chunks per row
  for (int e = threadIdx.x; e < R * kC; e += kTcThreads) {
    const int r = e / kC, c = e % kC, row = row0 + r;
    const bool ok = row < n_rows;
    cp_async16(smem_addr(dst + r * (D + 8) + c * 8),
               src + static_cast<size_t>(ok ? row : 0) * D + c * 8, ok);
  }
}

// src[row0 .. row0 + R) (fp32) into shared memory; 0 past n_rows.
template <int R>
__device__ __forceinline__ void load_vals(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n_rows) {
  for (int r = threadIdx.x; r < R; r += kTcThreads) {
    const bool ok = row0 + r < n_rows;
    cp_async4(smem_addr(dst + r), src + (ok ? row0 + r : 0), ok);
  }
}

// The q side of a backward step: rows [q0, q0 + R) of head bh's q and
// do, and their lse and D.
template <int R, int D>
__device__ __forceinline__ void load_q_side(
    bf16* qs, bf16* dos, float* lse_s, float* dl_s, const bf16* q,
    const bf16* dout, const float* lse, const float* delta, int bh, int q0,
    int lq) {
  const size_t base = static_cast<size_t>(bh) * lq;
  load_rows<R, D>(qs, q + base * D, q0, lq);
  load_rows<R, D>(dos, dout + base * D, q0, lq);
  load_vals<R>(lse_s, lse + base, q0, lq);
  load_vals<R>(dl_s, delta + base, q0, lq);
}

// Lane offsets of the ldmatrix row addresses.  "a": matrices 0-3 are
// (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15): the A
// operand of a 16 x 16 block, or with ldsm4_t the B operands of two
// n-tiles from a (k, n) row-major block.  "b": (0-7, 0-7), (0-7, 8-15),
// (8-15, 0-7), (8-15, 8-15): the B operands of two n-tiles from an
// (n, k) row-major block.
struct Lane {
  int warp, g, t, a_row, a_col, b_row, b_col;
  __device__ Lane() {
    const int lane = threadIdx.x % 32;
    warp = threadIdx.x / 32;
    g = lane >> 2;
    t = lane & 3;
    a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    a_col = (lane >> 4) * 8;
    b_row = (lane & 7) + (lane >> 4) * 8;
    b_col = ((lane >> 3) & 1) * 8;
  }
};

// ---- forward: the softmax step and epilogue of both forward kernels ---
// One kv tile of the online softmax for a thread's rows row0 and row0 + 8
// (s: the raw scores of keys k0 .. k0 + 63 in the accumulator layout).
// Scales into log2 units, masks with -1e30 where `edge` (padding keys;
// causal, keys past row + off), turns s into p = exp2(s - m), advances m
// and the lane's partial row sums l, and scales acc by exp2(m_old - m).
template <int kNO>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kTile / 8][4], float (&m)[2], float (&l)[2],
    float (&acc)[kNO][4], float scale_log2, bool edge, int k0, int t,
    int row0, int lk, int off, int causal) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale_log2;
      if (edge) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (key >= lk || (causal && key > row + off)) x = kNeg;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {     // the 4 lanes of a quad share a row
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    alpha[i] = exp2f(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - m[e >> 1]);       // now p
      l[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// o = acc / l in bf16 and lse = m ln 2 + ln l for rows row0, row0 + 8
// (those below lq) of head bh.
template <int kNO>
__device__ __forceinline__ void write_o_lse(const float (&acc)[kNO][4],
                                            const float (&m)[2],
                                            float (&l)[2], bf16* o,
                                            float* lse, int bh, int lq,
                                            int row0, int t) {
  constexpr int D = kNO * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {        // l was summed per lane
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= lq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    bf16* orow = o + (static_cast<size_t>(bh) * lq + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kNO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i] / li, acc[n][2 * i + 1] / li);
    if (t == 0)
      lse[static_cast<size_t>(bh) * lq + row] = m[i] * kLn2 + logf(li);
  }
}

// ---- forward on mma.sync (d = 16, 32) ---------------------------------
template <int D>
constexpr int fwd_tc_smem_bytes() {   // q, two k and two v tiles
  return 5 * kTile * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
fa_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, int hq, int hkv, int lq, int lk,
                  float scale_log2, int causal) {
  constexpr int SD = D + 8, kKS = D / 16, kNO = D / 8, kNS = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTile * SD;          // two buffers
  bf16* vs = ks + 2 * kTile * SD;      // two buffers

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest causal rows first
  const int bkv = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const bf16* kp = k + static_cast<size_t>(bkv) * lk * D;
  const bf16* vp = v + static_cast<size_t>(bkv) * lk * D;
  const int q0 = qt * kTile, off = lk - lq;
  const Lane ln;
  const int row0 = q0 + ln.warp * 16 + ln.g;  // rows row0 and row0 + 8

  load_rows<kTile, D>(qs, q + static_cast<size_t>(bh) * lq * D, q0, lq);
  load_rows<kTile, D>(ks, kp, 0, lk);
  load_rows<kTile, D>(vs, vp, 0, lk);
  cp_async_commit();

  uint32_t qf[kKS][4];
  float acc[kNO][4];
  zero(acc);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  const int n_kt = kv_tiles(q0, lq, lk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const bf16* kb = ks + (kt & 1) * kTile * SD;
    const bf16* vb = vs + (kt & 1) * kTile * SD;
    if (kt + 1 < n_kt) {
      load_rows<kTile, D>(ks + ((kt + 1) & 1) * kTile * SD, kp,
                          k0 + kTile, lk);
      load_rows<kTile, D>(vs + ((kt + 1) & 1) * kTile * SD, vp,
                          k0 + kTile, lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
        ldsm4(qf[kk], smem_addr(qs + (ln.warp * 16 + ln.a_row) * SD +
                                kk * 16 + ln.a_col));
    }
    // S = Q K^T, exact products of bf16 in the fp32 accumulator
    float s[kNS][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
      for (int j = 0; j < kNS; j += 2) {
        uint32_t b[4];
        ldsm4(b, smem_addr(kb + (j * 8 + ln.b_row) * SD + kk * 16 +
                           ln.b_col));
        mma16816(s[j], qf[kk], b[0], b[1]);
        mma16816(s[j + 1], qf[kk], b[2], b[3]);
      }
    // scale (fp32, in log2 units), mask, online softmax
    softmax_tile(s, m, l, acc, scale_log2,
                 k0 + kTile > lk || (causal && k0 + kTile - 1 > q0 + off),
                 k0, ln.t, row0, lk, off, causal);
    // O += P V, with P as bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < kNS / 2; ++kk) {
      uint32_t ph[4], pl[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int n = 0; n < kNO; n += 2) {
        uint32_t b[4];
        ldsm4_t(b, smem_addr(vb + (kk * 16 + ln.a_row) * SD + n * 8 +
                             ln.a_col));
        mma16816(acc[n], ph, b[0], b[1]);
        mma16816(acc[n + 1], ph, b[2], b[3]);
        mma16816(acc[n], pl, b[0], b[1]);
        mma16816(acc[n + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();                   // this buffer is loaded next
  }

  write_o_lse(acc, m, l, o, lse, bh, lq, row0, ln.t);
}

// ---- forward on wgmma + TMA (d = 64, 128) -------------------------------
constexpr int kWgThreads = 384;   // warpgroup 0 loads, 1 and 2 compute
constexpr int kWgRows = 128;      // q rows per block, 64 per consumer
constexpr int kStages = 3;        // k and v tiles in flight
constexpr long long kWaitCycles = 20000000000LL;   // ~10 s, then trap

// Shared memory, in bytes from a 1024-aligned base.  Every tile is kept
// in 128-byte column chunks (64 bf16) of TMA's 128-byte swizzle, which
// is the layout wgmma's descriptors read.
template <int D>
struct WgLayout {
  static constexpr int kChunks = D / 64;
  static constexpr int kQChunk = kWgRows * 128;    // a chunk of the q tile
  static constexpr int kKvChunk = kTile * 128;     // of a k or v tile
  static constexpr int q = 0;
  static constexpr int k = q + kChunks * kQChunk;  // kStages tiles
  static constexpr int v = k + kStages * kChunks * kKvChunk;
  // q_full, k_full[kStages], v_full[kStages], k_empty[], v_empty[]
  static constexpr int bars = v + kStages * kChunks * kKvChunk;
  static constexpr int bytes = bars + 8 * (1 + 4 * kStages) + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Wait for the phase of parity `parity` to complete.  A wait that
// outlasts kWaitCycles traps (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// A box of a 3-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's descriptor of a 128-byte-swizzled operand at `addr`: rows of
// 128 bytes, 8-row groups 1024 bytes apart (sbo), `lbo` between 64-wide
// chunks of an MN-major operand (unused for K-major).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep registers an asynchronous wgmma reads or writes in place until
// after its wait.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e]) :: "memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e]) :: "memory");
}

// d (64 x 64 fp32) += A B by the warpgroup, A (64 x 16) and B (64 x 16,
// K-major) from shared memory through their descriptors.  The
// accumulator has mma16816's layout per warp: warp w of the warpgroup
// holds rows 16w .. 16w + 15, d[j] the columns of n8 block j.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d += A B, A (64 x 16 bf16) from registers in mma16816's A layout per
// warp, B (16 x 64) MN-major (n contiguous) from shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ o, float* __restrict__ lse, int hq,
                    int hkv, int lq, int lk, float scale_log2, int causal) {
  using L = WgLayout<D>;
  constexpr int kC = L::kChunks, kNO = D / 8, kNS = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::bars;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest causal rows first
  const int bkv = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = qt * kWgRows, off = lk - lq;
  int n_kt = (lk + kTile - 1) / kTile;
  if (causal)
    n_kt = min(n_kt, (min(q0 + kWgRows, lq) - 1 + off) / kTile + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);        // one arrival per consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {             // the producer: one thread copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kC * L::kQChunk);
      for (int c = 0; c < kC; ++c)
        tma_load(base + L::q + c * L::kQChunk, &tq, q_full, c * 64, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        const uint32_t free_parity = ((kt / kStages) & 1) ^ 1;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), kC * L::kKvChunk);
        for (int c = 0; c < kC; ++c)
          tma_load(base + L::k + (s * kC + c) * L::kKvChunk, &tk, k_full(s),
                   c * 64, kt * kTile, bkv);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), kC * L::kKvChunk);
        for (int c = 0; c < kC; ++c)
          tma_load(base + L::v + (s * kC + c) * L::kKvChunk, &tv, v_full(s),
                   c * 64, kt * kTile, bkv);
      }
    }
    return;
  }

  // consumers: warpgroup 1 + cw owns q rows 64 cw .. 64 cw + 63 of the
  // tile, with the registers the producer gave up
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int first = q0 + cw * 64;      // this consumer's first row
  const int row0 = first + warp * 16 + (lane >> 2);
  const uint32_t qa = base + L::q + cw * 64 * 128;

  float acc[kNO][4];
  zero(acc);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    const uint32_t parity = (kt / kStages) & 1;
    const int k0 = kt * kTile;
    const uint32_t kb = base + L::k + s * kC * L::kKvChunk;
    const uint32_t vb = base + L::v + s * kC * L::kKvChunk;
    // S = Q K^T: both K-major; a k-step is 32 bytes along a swizzled row
    float sc[kNS][4];
    zero(sc);
    mbar_wait(k_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc,
               desc_sw128(qa + (kk / 4) * L::kQChunk + (kk % 4) * 32, 16),
               desc_sw128(kb + (kk / 4) * L::kKvChunk + (kk % 4) * 32, 16));
    wgmma_commit();
    wgmma_wait();
    hold(sc);
    if (lane == 0) mbar_arrive(k_empty(s));

    softmax_tile(sc, m, l, acc, scale_log2,
                 k0 + kTile > lk || (causal && k0 + kTile - 1 > first + off),
                 k0, t, row0, lk, off, causal);
    uint32_t ph[kNS / 2][4], pl[kNS / 2][4];
#pragma unroll
    for (int kk = 0; kk < kNS / 2; ++kk)
      acc_to_a(sc[2 * kk], sc[2 * kk + 1], ph[kk], pl[kk]);

    // O += P V, P as bf16 hi + lo from registers, V MN-major: a k-step
    // is 16 key rows, 2048 bytes
    mbar_wait(v_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float (&oc)[8][4] = *reinterpret_cast<float (*)[8][4]>(&acc[c * 8]);
#pragma unroll
      for (int kk = 0; kk < kNS / 2; ++kk) {
        const uint64_t dv =
            desc_sw128(vb + c * L::kKvChunk + kk * 2048, L::kKvChunk);
        wgmma_rs(oc, ph[kk], dv);
        wgmma_rs(oc, pl[kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait();
    hold(acc);
    hold(ph);
    hold(pl);
    if (lane == 0) mbar_arrive(v_empty(s));
  }
  write_o_lse(acc, m, l, o, lse, bh, lq, row0, t);
}

// ---- backward on mma.sync ---------------------------------------------
template <int D>
constexpr int dkdv_tc_smem_bytes() {  // k, v; two q, do; two lse, D
  return (2 * kTile + 4 * kBwdRows) * (D + 8) *
             static_cast<int>(sizeof(bf16)) +
         4 * kBwdRows * static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
fa_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int hq,
                       int hkv, int lq, int lk, float scale,
                       float scale_log2, int causal) {
  constexpr int SD = D + 8, kKS = D / 16, kNO = D / 8;
  constexpr int kNS = kBwdRows / 8;    // q-row n-tiles of S^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile * SD;
  bf16* qs = vs + kTile * SD;                  // two buffers
  bf16* dos = qs + 2 * kBwdRows * SD;          // two buffers
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kBwdRows * SD);
  float* dl_s = lse_s + 2 * kBwdRows;

  const int bkv = blockIdx.x;
  const int kt = blockIdx.y;           // causal: the most q tiles first
  const int group = hq / hkv;
  const int bh0 = (bkv / hkv) * hq + (bkv % hkv) * group;
  const int k0 = kt * kTile, off = lk - lq;
  const size_t kv_base = static_cast<size_t>(bkv) * lk * D;
  const Lane ln;
  const int kw = ln.warp * 16;         // this warp's keys in the tile

  // steps: (q head of the group, q tile under the diagonal)
  const int first_qt = causal ? max(0, k0 - off) / kBwdRows : 0;
  const int per_head = (lq + kBwdRows - 1) / kBwdRows - first_qt;
  const int n_steps = group * per_head;

  load_rows<kTile, D>(ks, k + kv_base, k0, lk);
  load_rows<kTile, D>(vs, v + kv_base, k0, lk);
  load_q_side<kBwdRows, D>(qs, dos, lse_s, dl_s, q, dout, lse, delta, bh0,
                           first_qt * kBwdRows, lq);
  cp_async_commit();

  float dka[kNO][4], dva[kNO][4];
  zero(dka);
  zero(dva);
  for (int st = 0; st < n_steps; ++st) {
    const int buf = st & 1;
    if (st + 1 < n_steps) {
      const int nb = buf ^ 1;
      load_q_side<kBwdRows, D>(
          qs + nb * kBwdRows * SD, dos + nb * kBwdRows * SD,
          lse_s + nb * kBwdRows, dl_s + nb * kBwdRows, q, dout, lse, delta,
          bh0 + (st + 1) / per_head,
          (first_qt + (st + 1) % per_head) * kBwdRows, lq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (first_qt + st % per_head) * kBwdRows;
    const bf16* qb = qs + buf * kBwdRows * SD;
    const bf16* db = dos + buf * kBwdRows * SD;
    const float* lb = lse_s + buf * kBwdRows;
    const float* dlb = dl_s + buf * kBwdRows;

    // S^T = K Q^T (keys x q rows)
    float pt[kNS][4];
    zero(pt);
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[4];
      ldsm4(a, smem_addr(ks + (kw + ln.a_row) * SD + kk * 16 + ln.a_col));
#pragma unroll
      for (int j = 0; j < kNS; j += 2) {
        uint32_t b[4];
        ldsm4(b, smem_addr(qb + (j * 8 + ln.b_row) * SD + kk * 16 +
                           ln.b_col));
        mma16816(pt[j], a, b[0], b[1]);
        mma16816(pt[j + 1], a, b[2], b[3]);
      }
    }
    // P^T = exp(scale S^T - lse), 0 where masked
    const bool edge = q0 + kBwdRows > lq || k0 + kTile > lk ||
                      (causal && k0 + kTile - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = j * 8 + 2 * ln.t + (e & 1);
        float p = exp2f(pt[j][e] * scale_log2 - lb[r] * kLog2e);
        if (edge) {
          const int qrow = q0 + r, key = k0 + kw + ln.g + (e >> 1) * 8;
          if (qrow >= lq || key >= lk || (causal && key > qrow + off))
            p = 0.f;
        }
        pt[j][e] = p;
      }
    // dV += P^T dO, P^T as bf16 hi + lo
#pragma unroll
    for (int kq = 0; kq < kNS / 2; ++kq) {
      uint32_t ph[4], pl[4];
      acc_to_a(pt[2 * kq], pt[2 * kq + 1], ph, pl);
#pragma unroll
      for (int n = 0; n < kNO; n += 2) {
        uint32_t b[4];
        ldsm4_t(b, smem_addr(db + (kq * 16 + ln.a_row) * SD + n * 8 +
                             ln.a_col));
        mma16816(dva[n], ph, b[0], b[1]);
        mma16816(dva[n + 1], ph, b[2], b[3]);
        mma16816(dva[n], pl, b[0], b[1]);
        mma16816(dva[n + 1], pl, b[2], b[3]);
      }
    }
    // dP^T = V dO^T, then dS^T = P^T (dP^T - D)
    float ds[kNS][4];
    zero(ds);
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[4];
      ldsm4(a, smem_addr(vs + (kw + ln.a_row) * SD + kk * 16 + ln.a_col));
#pragma unroll
      for (int j = 0; j < kNS; j += 2) {
        uint32_t b[4];
        ldsm4(b, smem_addr(db + (j * 8 + ln.b_row) * SD + kk * 16 +
                           ln.b_col));
        mma16816(ds[j], a, b[0], b[1]);
        mma16816(ds[j + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = pt[j][e] * (ds[j][e] - dlb[j * 8 + 2 * ln.t + (e & 1)]);
    // dK += dS^T Q, dS^T as bf16 hi + lo (times scale at the end)
#pragma unroll
    for (int kq = 0; kq < kNS / 2; ++kq) {
      uint32_t dh[4], dl[4];
      acc_to_a(ds[2 * kq], ds[2 * kq + 1], dh, dl);
#pragma unroll
      for (int n = 0; n < kNO; n += 2) {
        uint32_t b[4];
        ldsm4_t(b, smem_addr(qb + (kq * 16 + ln.a_row) * SD + n * 8 +
                             ln.a_col));
        mma16816(dka[n], dh, b[0], b[1]);
        mma16816(dka[n + 1], dh, b[2], b[3]);
        mma16816(dka[n], dl, b[0], b[1]);
        mma16816(dka[n + 1], dl, b[2], b[3]);
      }
    }
    __syncthreads();                   // this buffer is loaded next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kw + ln.g + i * 8;
    if (key >= lk) continue;
    const size_t base = kv_base + static_cast<size_t>(key) * D + 2 * ln.t;
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + n * 8) =
          __floats2bfloat162_rn(dka[n][2 * i] * scale,
                                dka[n][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + n * 8) =
          __floats2bfloat162_rn(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

template <int D>
constexpr int dq_tc_smem_bytes() {    // q, do, two k and two v; lse, D
  return 6 * kTile * (D + 8) * static_cast<int>(sizeof(bf16)) +
         2 * kTile * static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
fa_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int hq, int hkv, int lq, int lk, float scale,
                     float scale_log2, int causal) {
  constexpr int SD = D + 8, kKS = D / 16, kNO = D / 8, kNS = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kTile * SD;
  bf16* ks = dos + kTile * SD;         // two buffers
  bf16* vs = ks + 2 * kTile * SD;      // two buffers
  float* lse_s = reinterpret_cast<float*>(vs + 2 * kTile * SD);
  float* dl_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bkv = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const bf16* kp = k + static_cast<size_t>(bkv) * lk * D;
  const bf16* vp = v + static_cast<size_t>(bkv) * lk * D;
  const int q0 = qt * kTile, off = lk - lq;
  const Lane ln;
  const int lr = ln.warp * 16 + ln.g;  // local rows lr and lr + 8
  const int row0 = q0 + lr;

  load_q_side<kTile, D>(qs, dos, lse_s, dl_s, q, dout, lse, delta, bh, q0,
                        lq);
  load_rows<kTile, D>(ks, kp, 0, lk);
  load_rows<kTile, D>(vs, vp, 0, lk);
  cp_async_commit();

  float dqa[kNO][4];
  zero(dqa);
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};   // read at kt == 0
  const int n_kt = kv_tiles(q0, lq, lk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const bf16* kb = ks + (kt & 1) * kTile * SD;
    const bf16* vb = vs + (kt & 1) * kTile * SD;
    if (kt + 1 < n_kt) {
      load_rows<kTile, D>(ks + ((kt + 1) & 1) * kTile * SD, kp,
                          k0 + kTile, lk);
      load_rows<kTile, D>(vs + ((kt + 1) & 1) * kTile * SD, vp,
                          k0 + kTile, lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse2[i] = lse_s[lr + i * 8] * kLog2e;
        dl[i] = dl_s[lr + i * 8];
      }
    }
    // S = Q K^T and dP = dO V^T
    float s[kNS][4], dp[kNS][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[4];
      ldsm4(a, smem_addr(qs + (ln.warp * 16 + ln.a_row) * SD + kk * 16 +
                         ln.a_col));
#pragma unroll
      for (int j = 0; j < kNS; j += 2) {
        uint32_t b[4];
        ldsm4(b, smem_addr(kb + (j * 8 + ln.b_row) * SD + kk * 16 +
                           ln.b_col));
        mma16816(s[j], a, b[0], b[1]);
        mma16816(s[j + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[4];
      ldsm4(a, smem_addr(dos + (ln.warp * 16 + ln.a_row) * SD + kk * 16 +
                         ln.a_col));
#pragma unroll
      for (int j = 0; j < kNS; j += 2) {
        uint32_t b[4];
        ldsm4(b, smem_addr(vb + (j * 8 + ln.b_row) * SD + kk * 16 +
                           ln.b_col));
        mma16816(dp[j], a, b[0], b[1]);
        mma16816(dp[j + 1], a, b[2], b[3]);
      }
    }
    // dS = P (dP - D), P = exp(scale S - lse), 0 where masked
    const bool edge = k0 + kTile > lk ||
                      (causal && k0 + kTile - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(s[j][e] * scale_log2 - lse2[i]);
        if (edge) {
          const int key = k0 + j * 8 + 2 * ln.t + (e & 1);
          if (key >= lk || (causal && key > row0 + i * 8 + off)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[i]);
      }
    // dQ += dS K, dS as bf16 hi + lo (times scale at the end)
#pragma unroll
    for (int kk = 0; kk < kNS / 2; ++kk) {
      uint32_t dh[4], dlo[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], dh, dlo);
#pragma unroll
      for (int n = 0; n < kNO; n += 2) {
        uint32_t b[4];
        ldsm4_t(b, smem_addr(kb + (kk * 16 + ln.a_row) * SD + n * 8 +
                             ln.a_col));
        mma16816(dqa[n], dh, b[0], b[1]);
        mma16816(dqa[n + 1], dh, b[2], b[3]);
        mma16816(dqa[n], dlo, b[0], b[1]);
        mma16816(dqa[n + 1], dlo, b[2], b[3]);
      }
    }
    __syncthreads();                   // this buffer is loaded next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= lq) continue;
    bf16* out = dq + (static_cast<size_t>(bh) * lq + row) * D + 2 * ln.t;
#pragma unroll
    for (int n = 0; n < kNO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(dqa[n][2 * i] * scale,
                                dqa[n][2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
struct Shape {
  int b, hq, hkv, lq, lk;
  float scale;
  int causal;
};

bool valid(const Shape& s) {
  return s.b > 0 && s.hq > 0 && s.hkv > 0 && s.hq % s.hkv == 0 &&
         s.lq > 0 && s.lk > 0 && !(s.causal && s.lq > s.lk) &&
         static_cast<long long>(s.b) * s.hq <= 65535;
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, const Shape& s, cudaStream_t st) {
  const size_t smem = sizeof(float) * fwd_smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((s.lq + kTile - 1) / kTile, s.b * s.hq);
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s.hq, s.hkv, s.lq,
      s.lk, s.scale, s.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, const Shape& s, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = s.b * s.hq * s.lq;
  fa_bwd_delta_kernel<T, D><<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const T*>(o), dot, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = sizeof(float) * bwd_smem_floats<D>();
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((s.lk + kTile - 1) / kTile, s.b * s.hkv);
  fa_bwd_dkdv_kernel<T, D><<<kv_grid, kThreads, smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      s.hq, s.hkv, s.lq, s.lk, s.scale, s.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(fa_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 q_grid((s.lq + kTile - 1) / kTile, s.b * s.hq);
  fa_bwd_dq_kernel<T, D><<<q_grid, kThreads, smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), s.hq, s.hkv, s.lq,
      s.lk, s.scale, s.causal);
  return cudaGetLastError();
}

// The bf16 route: tensor-core kernels.
template <int D>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Shape& s, cudaStream_t st) {
  const int smem = fwd_tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.hq, (s.lq + kTile - 1) / kTile);
  fa_fwd_mma_kernel<D><<<grid, kTcThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, s.hq, s.hkv,
      s.lq, s.lk, s.scale * kLog2e, s.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_tc(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, const Shape& s,
                   cudaStream_t st) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const int rows = s.b * s.hq * s.lq;
  fa_bwd_delta_kernel<bf16, D><<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const bf16*>(o), dot, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  int smem = dkdv_tc_smem_bytes<D>();
  err = cudaFuncSetAttribute(fa_bwd_dkdv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(s.b * s.hkv, (s.lk + kTile - 1) / kTile);
  fa_bwd_dkdv_mma_kernel<D><<<kv_grid, kTcThreads, smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s.hq, s.hkv, s.lq, s.lk, s.scale,
      s.scale * kLog2e, s.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  smem = dq_tc_smem_bytes<D>();
  err = cudaFuncSetAttribute(fa_bwd_dq_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 q_grid(s.b * s.hq, (s.lq + kTile - 1) / kTile);
  fa_bwd_dq_mma_kernel<D><<<q_grid, kTcThreads, smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), s.hq, s.hkv,
      s.lq, s.lk, s.scale, s.scale * kLog2e, s.causal);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map (d, rows, heads) of a contiguous (heads, rows, d) bf16
// tensor, in boxes of 64 columns x box_rows rows x 1 head with the
// 128-byte swizzle; rows past `rows` read 0, never the next head's.
bool tensor_map(CUtensorMap* map, const void* ptr, int heads, int rows,
                int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {d * sizeof(bf16),
                                 static_cast<cuuint64_t>(rows) * d *
                                     sizeof(bf16)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t fwd_wg(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Shape& s, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, s.b * s.hq, s.lq, D, kWgRows) ||
      !tensor_map(&tk, k, s.b * s.hkv, s.lk, D, kTile) ||
      !tensor_map(&tv, v, s.b * s.hkv, s.lk, D, kTile))
    return cudaErrorInvalidValue;
  const int smem = WgLayout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.hq, (s.lq + kWgRows - 1) / kWgRows);
  fa_fwd_wgmma_kernel<D><<<grid, kWgThreads, smem, st>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, s.hq, s.hkv, s.lq, s.lk,
      s.scale * kLog2e, s.causal);
  return cudaGetLastError();
}

// The bf16 forward: wgmma + TMA at d = 64 and 128, mma.sync below (a
// row of d < 64 is narrower than one 128-byte swizzle chunk).
template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o,
                     float* lse, const Shape& s, cudaStream_t st) {
  if constexpr (D >= 64) {
    return fwd_wg<D>(q, k, v, o, lse, s, st);
  } else {
    return fwd_tc<D>(q, k, v, o, lse, s, st);
  }
}

// bf16 -> the tensor-core kernels, fp32 -> the FMA kernels.
cudaError_t fwd_d(int d, int is_bf16, const void* q, const void* k,
                  const void* v, void* o, float* lse, const Shape& s,
                  cudaStream_t st) {
#define FA_FWD(D)                                  \
  (is_bf16 ? fwd_bf16<D>(q, k, v, o, lse, s, st)   \
           : fwd<float, D>(q, k, v, o, lse, s, st))
  switch (d) {
    case 16: return FA_FWD(16);
    case 32: return FA_FWD(32);
    case 64: return FA_FWD(64);
    case 128: return FA_FWD(128);
    default: return cudaErrorInvalidValue;
  }
#undef FA_FWD
}

cudaError_t bwd_d(int d, int is_bf16, const void* q, const void* k,
                  const void* v, const void* o, const void* dout,
                  const float* lse, float* delta, void* dq, void* dk,
                  void* dv, const Shape& s, cudaStream_t st) {
#define FA_BWD(D)                                                         \
  (is_bf16                                                                \
       ? bwd_tc<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, s, st)       \
       : bwd<float, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, s, st))
  switch (d) {
    case 16: return FA_BWD(16);
    case 32: return FA_BWD(32);
    case 64: return FA_BWD(64);
    case 128: return FA_BWD(128);
    default: return cudaErrorInvalidValue;
  }
#undef FA_BWD
}

}  // namespace

// q (b, hq, lq, d), k and v (b, hkv, lk, d), o like q, lse (b, hq, lq)
// fp32; bf16 != 0 for bfloat16 tensors, else float32.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int b, int hq, int hkv, int lq,
                                          int lk, int d, float scale,
                                          int causal, int bf16,
                                          void* stream) {
  const Shape s{b, hq, hkv, lq, lk, scale, causal};
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fwd_d(d, bf16, q, k, v, o, lse, s,
                                static_cast<cudaStream_t>(stream)));
}

// The forward's inputs, o and lse, the output gradient dout (like o), a
// scratch delta (b, hq, lq) fp32; writes dq, dk, dv (like q, k, v).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int hq, int hkv, int lq, int lk, int d, float scale,
    int causal, int bf16, void* stream) {
  const Shape s{b, hq, hkv, lq, lk, scale, causal};
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bwd_d(d, bf16, q, k, v, o, dout, lse, delta, dq,
                                dk, dv, s,
                                static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
