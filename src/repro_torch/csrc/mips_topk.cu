// Maximum-inner-product top-k for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mips_topk/kernel.py :: mips_topk_pallas
// (body _mips_kernel, merge _merge_topk, pallas_call at kernel.py:117).
//
// Computes, for queries Q (b, d) fp32 and rows DB (n, d) fp32 with
// k <= min(n, 64), the k best rows of every query by the total order
// (score descending, row index ascending): vals (b, k) fp32 and idx
// (b, k) int32.  The (b, n) score matrix is never written to memory.
//
// What bounds it on the H100: it reads n*d*4 bytes and does 2*b*n*d
// fp32 FLOP on CUDA cores (no TF32: row ids must match the fp32
// reference).  At b = 1 it is memory-bound; at the deployment batch
// b = 64 the FLOP take longer than the bytes at the fp32 non-tensor
// peak, so it is operation-bound.
//
// Design.  The TPU kernel walks the n-tiles in order on one core and
// gets lowest-index-first ties from that order; on Hopper the blocks run
// in any order, so the order is made explicit instead:
//   1. mips_scan_kernel: one block per (16-query tile, n-range).  The
//      block streams 128 rows at a time through shared memory in
//      32-feature chunks (coalesced loads, queries read as broadcast
//      float4s); each thread scores one row against the 16 queries, one
//      fmaf per feature in the fixed order 0..d-1, so a (query, row)
//      score is bitwise the same whatever the batch size, the tile or
//      the range.  Scores go to shared memory, and each warp folds 4
//      queries' scores into a per-query top-k list held across its lanes
//      (entry e in lane e % 32), inserting only candidates that beat the
//      list's k-th entry.  The list of every (query, range) is written
//      to a small (b, ranges, k) scratch.
//   2. mips_merge_kernel: one warp per query folds its ranges * k
//      partial candidates into the final list by the same total order.
// mips_rescore_kernel (entry mips_rescore_launch) is the same score loop
// and merge over a per-query list of gathered rows: the exact rescore of
// the two-stage quantized scan, which is XLA in the JAX package
// (src/repro/kernels/quantized_scan/ops.py:229, in _two_stage).
// Rows past the end of a range or of the DB are never candidates;
// unfilled list slots hold (-inf, INT_MAX), which every real score
// beats — including the store's masked rows at MASK_BIAS = -3e30.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // rows per tile, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;                // queries per block
constexpr int kQPerWarp = kBQ / kWarps;
constexpr int kDC = 32;                // features staged per chunk
constexpr int kMaxK = 64;
constexpr int kNoIdx = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Sorted top-k list (k <= 64) spread over a warp: lane l holds entries
// l (v0, i0) and l + 32 (v1, i1).  Every call is warp-uniform.
struct WarpTopK {
  float v0, v1;
  int i0, i1;

  __device__ __forceinline__ void init() {
    v0 = v1 = -INFINITY;
    i0 = i1 = kNoIdx;
  }

  // the k-th entry: a candidate must beat it to enter
  __device__ __forceinline__ void kth(int k, float& tv, int& ti) const {
    const int e = k - 1;
    tv = __shfl_sync(kFull, e < 32 ? v0 : v1, e & 31);
    ti = __shfl_sync(kFull, e < 32 ? i0 : i1, e & 31);
  }

  __device__ __forceinline__ void insert(float cv, int ci, int k,
                                         int lane) {
    const unsigned b0 =
        __ballot_sync(kFull, lane < k && better(v0, i0, cv, ci));
    const unsigned b1 =
        __ballot_sync(kFull, lane + 32 < k && better(v1, i1, cv, ci));
    const int pos = __popc(b0) + __popc(b1);
    if (pos >= k) return;
    float uv0 = __shfl_up_sync(kFull, v0, 1);
    int ui0 = __shfl_up_sync(kFull, i0, 1);
    float uv1 = __shfl_up_sync(kFull, v1, 1);
    int ui1 = __shfl_up_sync(kFull, i1, 1);
    const float last_v0 = __shfl_sync(kFull, v0, 31);
    const int last_i0 = __shfl_sync(kFull, i0, 31);
    if (lane == 0) {  // entry 32 takes entry 31
      uv1 = last_v0;
      ui1 = last_i0;
    }
    if (lane > pos) {
      v0 = uv0;
      i0 = ui0;
    } else if (lane == pos) {
      v0 = cv;
      i0 = ci;
    }
    if (lane + 32 > pos) {
      v1 = uv1;
      i1 = ui1;
    } else if (lane + 32 == pos) {
      v1 = cv;
      i1 = ci;
    }
  }

  // offer one candidate per lane (valid lanes only), lowest lane first
  __device__ __forceinline__ void offer(float s, int idx, bool valid, int k,
                                        int lane) {
    float tv;
    int ti;
    kth(k, tv, ti);
    unsigned m = __ballot_sync(kFull, valid && better(s, idx, tv, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float cv = __shfl_sync(kFull, s, src);
      const int ci = __shfl_sync(kFull, idx, src);
      insert(cv, ci, k, lane);
    }
  }

  __device__ __forceinline__ void store(float* vals, int32_t* idx, int k,
                                        int lane) const {
    if (lane < k) {
      vals[lane] = v0;
      idx[lane] = i0;
    }
    if (lane + 32 < k) {
      vals[lane + 32] = v1;
      idx[lane + 32] = i1;
    }
  }
};

// The one score loop of both kernels: thread tid sums the score of tile
// row tid against NQ queries (q0 .. q0 + NQ - 1, those >= b read as
// zeros), one fmaf per feature in the order 0..d-1.  Tile row r is DB
// row row_of(r), or a zero row where row_of(r) < 0.  Features are
// staged through shared memory kDC at a time; the zero padding past d
// adds fmaf(0, 0, acc) == acc.  Because the scan and the rescore both
// run this chain, a rescored (query, row) score is bitwise the scan's.
// Every thread of the block calls it (it holds barriers).
template <int NQ, typename RowOf>
__device__ __forceinline__ void score_tile(
    const float* __restrict__ q, const float* __restrict__ db, int q0,
    int b, int d, RowOf row_of, float (*rows_s)[kDC + 1],
    float (*q_s)[NQ], float (&acc)[NQ]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j] = 0.f;
  for (int d0 = 0; d0 < d; d0 += kDC) {
    __syncthreads();
#pragma unroll 8
    for (int e = tid; e < kThreads * kDC; e += kThreads) {
      const int r = e / kDC, c = e % kDC;
      const int row = row_of(r), col = d0 + c;
      rows_s[r][c] = (row >= 0 && col < d)
                         ? db[static_cast<size_t>(row) * d + col] : 0.f;
    }
    for (int e = tid; e < kDC * NQ; e += kThreads) {
      const int c = e / NQ, j = e % NQ;
      const int qi = q0 + j, col = d0 + c;
      q_s[c][j] = (qi < b && col < d)
                      ? q[static_cast<size_t>(qi) * d + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const float x = rows_s[tid][c];
      float qv[NQ];
      if constexpr (NQ % 4 == 0) {  // broadcast float4 loads
        const float4* q4 = reinterpret_cast<const float4*>(&q_s[c][0]);
#pragma unroll
        for (int j4 = 0; j4 < NQ / 4; ++j4) {
          const float4 w = q4[j4];
          qv[4 * j4 + 0] = w.x;
          qv[4 * j4 + 1] = w.y;
          qv[4 * j4 + 2] = w.z;
          qv[4 * j4 + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < NQ; ++j) qv[j] = q_s[c][j];
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) acc[j] = fmaf(x, qv[j], acc[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mips_scan_kernel(const float* __restrict__ q, const float* __restrict__ db,
                 float* __restrict__ part_v, int32_t* __restrict__ part_i,
                 int b, int n, int d, int k, int rows_per_range,
                 int n_ranges) {
  __shared__ float rows_s[kThreads][kDC + 1];
  __shared__ __align__(16) float q_s[kDC][kBQ];
  __shared__ float scores_s[kBQ][kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.y * kBQ;
  const int range = blockIdx.x;
  const int r_begin = range * rows_per_range;
  const int r_end = min(n, r_begin + rows_per_range);

  WarpTopK lists[kQPerWarp];
#pragma unroll
  for (int jj = 0; jj < kQPerWarp; ++jj) lists[jj].init();

  for (int t0 = r_begin; t0 < r_end; t0 += kThreads) {
    float acc[kBQ];
    score_tile<kBQ>(q, db, q0, b, d,
                    [=](int r) { return t0 + r < r_end ? t0 + r : -1; },
                    rows_s, q_s, acc);

#pragma unroll
    for (int j = 0; j < kBQ; ++j) scores_s[j][tid] = acc[j];
    __syncthreads();

#pragma unroll
    for (int jj = 0; jj < kQPerWarp; ++jj) {
      const int j = warp * kQPerWarp + jj;
      if (q0 + j >= b) continue;  // warp-uniform
      for (int base = 0; base < kThreads; base += 32) {
        const int row = t0 + base + lane;
        lists[jj].offer(scores_s[j][base + lane], row, row < r_end, k,
                        lane);
      }
    }
    // the next tile's first __syncthreads keeps scores_s from being
    // overwritten before every warp has read it
  }

#pragma unroll
  for (int jj = 0; jj < kQPerWarp; ++jj) {
    const int qi = q0 + warp * kQPerWarp + jj;
    if (qi >= b) continue;
    const size_t off = (static_cast<size_t>(qi) * n_ranges + range) * k;
    lists[jj].store(part_v + off, part_i + off, k, lane);
  }
}

__global__ void __launch_bounds__(kThreads)
mips_merge_kernel(const float* __restrict__ part_v,
                  const int32_t* __restrict__ part_i,
                  float* __restrict__ out_v, int32_t* __restrict__ out_i,
                  int b, int n_cand, int k) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (qi >= b) return;  // warp-uniform
  WarpTopK list;
  list.init();
  const float* pv = part_v + static_cast<size_t>(qi) * n_cand;
  const int32_t* pi = part_i + static_cast<size_t>(qi) * n_cand;
  for (int base = 0; base < n_cand; base += 32) {
    const int c = base + lane;
    const bool valid = c < n_cand;
    list.offer(valid ? pv[c] : -INFINITY, valid ? pi[c] : kNoIdx, valid,
               k, lane);
  }
  list.store(out_v + static_cast<size_t>(qi) * k,
             out_i + static_cast<size_t>(qi) * k, k, lane);
}

// The rescore of the two-stage quantized scan: one block per (query,
// range of that query's candidates).  The query's own candidate rows
// (its index list, cand[qi]) go through score_tile, the scan's score
// loop, so a (query, row) score here is bitwise the score
// mips_scan_kernel computes for that row.  Each warp
// keeps a top-k list over the rows it scores; the lists go to a
// (b, ranges, 4, k) scratch that mips_merge_kernel folds.  Candidate
// indices outside [0, n) are never scored.
__global__ void __launch_bounds__(kThreads)
mips_rescore_kernel(const float* __restrict__ q,
                    const float* __restrict__ db,
                    const int32_t* __restrict__ cand,
                    float* __restrict__ part_v, int32_t* __restrict__ part_i,
                    int n, int d, int n_cand, int k, int cands_per_range,
                    int n_ranges) {
  __shared__ float rows_s[kThreads][kDC + 1];
  __shared__ float q_s[kDC][1];
  __shared__ int row_s[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qi = blockIdx.y;
  const int range = blockIdx.x;
  const int p_begin = range * cands_per_range;
  const int p_end = min(n_cand, p_begin + cands_per_range);
  const int32_t* my_cand = cand + static_cast<size_t>(qi) * n_cand;

  WarpTopK list;
  list.init();
  for (int t0 = p_begin; t0 < p_end; t0 += kThreads) {
    __syncthreads();
    int row = t0 + tid < p_end ? my_cand[t0 + tid] : -1;
    row_s[tid] = (row >= 0 && row < n) ? row : -1;
    // score_tile's first barrier publishes row_s
    float acc[1];
    score_tile<1>(q, db, qi, qi + 1, d, [&](int r) { return row_s[r]; },
                  rows_s, q_s, acc);
    row = row_s[tid];
    list.offer(acc[0], row, row >= 0, k, lane);
  }
  const size_t off =
      ((static_cast<size_t>(qi) * n_ranges + range) * kWarps + warp) * k;
  list.store(part_v + off, part_i + off, k, lane);
}

}  // namespace

// part_v / part_i: (b, n_ranges, k) scratch; out_v / out_i: (b, k).
// rows_per_range must be a multiple of 128 with
// n_ranges == ceil(n / rows_per_range).
extern "C" int mips_topk_launch(const float* q, const float* db,
                                float* part_v, int32_t* part_i,
                                float* out_v, int32_t* out_i, int b, int n,
                                int d, int k, int rows_per_range,
                                int n_ranges, void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || k < 1 || k > kMaxK || k > n ||
      rows_per_range <= 0 || rows_per_range % kThreads != 0 ||
      n_ranges != (n + rows_per_range - 1) / rows_per_range) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 scan_grid(n_ranges, (b + kBQ - 1) / kBQ);
  mips_scan_kernel<<<scan_grid, kThreads, 0, s>>>(
      q, db, part_v, part_i, b, n, d, k, rows_per_range, n_ranges);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 merge_grid((b + kWarps - 1) / kWarps);
  mips_merge_kernel<<<merge_grid, kThreads, 0, s>>>(
      part_v, part_i, out_v, out_i, b, n_ranges * k, k);
  return static_cast<int>(cudaGetLastError());
}

// q: (b, d) augmented queries; cand: (b, n_cand) row indices into db
// (n, d); part_v / part_i: (b, n_ranges, 4, k) scratch; out_v / out_i:
// (b, k).  cands_per_range must be a multiple of 128 with
// n_ranges == ceil(n_cand / cands_per_range).
extern "C" int mips_rescore_launch(const float* q, const float* db,
                                   const int32_t* cand, float* part_v,
                                   int32_t* part_i, float* out_v,
                                   int32_t* out_i, int b, int n, int d,
                                   int n_cand, int k, int cands_per_range,
                                   int n_ranges, void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || n_cand < 1 || k < 1 || k > kMaxK ||
      k > n_cand || cands_per_range <= 0 ||
      cands_per_range % kThreads != 0 ||
      n_ranges != (n_cand + cands_per_range - 1) / cands_per_range) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_ranges, b);
  mips_rescore_kernel<<<grid, kThreads, 0, s>>>(
      q, db, cand, part_v, part_i, n, d, n_cand, k, cands_per_range,
      n_ranges);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 merge_grid((b + kWarps - 1) / kWarps);
  mips_merge_kernel<<<merge_grid, kThreads, 0, s>>>(
      part_v, part_i, out_v, out_i, b, n_ranges * kWarps * k, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mips_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
