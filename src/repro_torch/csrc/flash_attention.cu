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
// padding query rows of a ragged last tile included.
//
// Precision, as kernel.py:52 does it: every operand is widened to fp32
// (q times scale in fp32), and every sum is an fp32 fmaf chain in a
// fixed order.  No tensor cores (no TF32 for fp32 inputs, no bf16
// rounding of q * scale or of P).
//
// What bounds it on the H100: at the training shape (l = 4096, d = 128)
// attention does ~l/2 multiply-adds per byte it must move, so the card's
// bound is its tensor-core rate.  These kernels use the fp32 FMA units
// (67 TFLOP/s, 1/15 of the bf16 tensor-core peak) and read their
// operands from shared memory, one scalar load per two FMAs in the score
// loops: they are bound by shared-memory load issue.  Making them fast
// (mma/wgmma on bf16, TMA) is later work; this is the simple, exact one.
//
// Design.  A block is 256 threads, a 16 x 16 grid (ty, tx); tiles are
// 64 query rows by 64 keys.  Thread (ty, tx) owns query rows ty + 16 i
// and keys tx + 16 j (i, j < 4) of a score tile, and output columns
// tx + 16 jj (jj < d / 16).  Tiles sit in shared memory in fp32 with an
// odd row stride (d + 1), so the 16 lanes of a row group read 16 banks.
//   fa_fwd_kernel        one block per (b * hq, q tile): loops over the
//                        kv tiles the causal diagonal leaves (the skip of
//                        kernel.py:46-48), keeps the running (m, l, acc)
//                        in registers, writes o and lse.
//   fa_bwd_delta_kernel  D = rowsum(do * o) in fp32, one warp per row.
//   fa_bwd_dkdv_kernel   one block per (b * hkv, kv tile): loops over the
//                        group q heads that share the kv head, and over
//                        the q tiles under the diagonal; recomputes
//                        P = exp(s - lse), accumulates dV = P^T dO and
//                        dK = dS^T (scale q), dS = P (dP - D).
//   fa_bwd_dq_kernel     one block per (b * hq, q tile): loops over the
//                        kv tiles as the forward does, dQ = scale dS K.
// Each output element is summed by one thread in one fixed order, and no
// float atomics are used: two runs give bitwise-equal results.
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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
// forward
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
// backward
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

template <typename T>
cudaError_t fwd_d(int d, const void* q, const void* k, const void* v,
                  void* o, float* lse, const Shape& s, cudaStream_t st) {
  switch (d) {
    case 16: return fwd<T, 16>(q, k, v, o, lse, s, st);
    case 32: return fwd<T, 32>(q, k, v, o, lse, s, st);
    case 64: return fwd<T, 64>(q, k, v, o, lse, s, st);
    case 128: return fwd<T, 128>(q, k, v, o, lse, s, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_d(int d, const void* q, const void* k, const void* v,
                  const void* o, const void* dout, const float* lse,
                  float* delta, void* dq, void* dk, void* dv, const Shape& s,
                  cudaStream_t st) {
#define FA_BWD(D) bwd<T, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, s, st)
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? fwd_d<__nv_bfloat16>(d, q, k, v, o, lse, s, st)
           : fwd_d<float>(d, q, k, v, o, lse, s, st));
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? bwd_d<__nv_bfloat16>(d, q, k, v, o, dout, lse, delta, dq, dk,
                                  dv, s, st)
           : bwd_d<float>(d, q, k, v, o, dout, lse, delta, dq, dk, dv, s,
                          st));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
