// Packed-code Hamming top-C for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hamming_topk/kernel.py :: hamming_topk_pallas
// (body _hamming_kernel, pallas_call at kernel.py:72).
//
// Computes, for query codes QC (b, w) and row codes DBC (n, w) of 32-bit
// words (int32 carrying the uint32 bits) and any 1 <= C <= n, the C rows
// nearest to each query by popcount(q ^ row): dist (b, C) int32 and
// idx (b, C) int32, ordered by (distance ascending, row ascending) --
// lax.top_k's order.  w <= kMaxW.
//
// What bounds it on the H100: it reads n*w*4 bytes and does b*n*w
// popcounts (16 per SM per clock); at the deployment batch b = 64 the
// popcounts take longer than the bytes, so it is operation-bound.
//
// Design.  The TPU kernel keeps a running top-C in VMEM, which caps C
// at what a list can hold.  Here C runs from 32 (the serving default)
// up to n (the store clamps C to its capacity), so no list is kept.
// Distances are small bounded integers in [0, 32w], which makes an
// exact counting selection possible for every C:
//   1. hamming_hist_kernel: one block per (16-query tile, row range).
//      Rows stream through shared memory 128 at a time (a tile's codes
//      are contiguous, so the loads coalesce); each of the 4 warps owns
//      4 queries and counts its queries' distances into a per-(query,
//      range) histogram in shared memory, written out to `hist`.
//   2. hamming_select_kernel: one block per query.  It sums the range
//      histograms, finds the threshold t (the C-th smallest distance)
//      and each class's first output slot by a prefix sum over the
//      classes, then replaces hist[q][r][c] (c <= t) by the output slot
//      of the first row of class c in range r: an exclusive prefix sum
//      over the ranges, so each class keeps row order across blocks.
//   3. hamming_scatter_kernel: the grid of pass 1 again.  It recomputes
//      the distances (the codes are cheap to re-read) and writes each
//      row with distance <= t to its slot: the range's offset for its
//      class plus its rank among the earlier rows of that class.  A
//      warp walks its range in row order, ranking the lanes of one
//      32-row step with __match_any_sync, and owns its queries'
//      running class counters, so no other warp touches them.  Slots
//      >= C (the tail of class t) are dropped.
// Every count is exact and no result depends on the order blocks run
// in: the output is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // rows per tile
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;                // queries per block
constexpr int kQPerWarp = kBQ / kWarps;
constexpr int kSelThreads = 256;
constexpr int kMaxW = 80;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of the scan kernels (dynamic): the block's query codes,
// one tile of row codes (odd row stride: conflict-free lane reads), and
// one counter per (query, distance class).
struct ScanSmem {
  uint32_t* q;    // [kBQ][w]
  uint32_t* rows; // [kThreads][ws]
  int* cnt;       // [kBQ][n_cls]
  int w, ws, n_cls;

  __device__ ScanSmem(uint32_t* base, int w_) : w(w_) {
    ws = w_ | 1;
    n_cls = 32 * w_ + 1;
    q = base;
    rows = q + kBQ * w_;
    cnt = reinterpret_cast<int*>(rows + kThreads * ws);
  }
};

__host__ __device__ inline size_t scan_smem_bytes(int w) {
  return 4u * (static_cast<size_t>(kBQ) * w +
               static_cast<size_t>(kThreads) * (w | 1) +
               static_cast<size_t>(kBQ) * (32 * w + 1));
}

__device__ __forceinline__ void load_queries(ScanSmem& s,
                                             const int32_t* qc, int q0,
                                             int b) {
  for (int e = threadIdx.x; e < kBQ * s.w; e += kThreads) {
    const int j = e / s.w;
    s.q[e] = (q0 + j < b)
                 ? static_cast<uint32_t>(qc[static_cast<size_t>(q0) * s.w +
                                            e])
                 : 0u;
  }
}

// the tile's codes are one contiguous run of 128 * w words
__device__ __forceinline__ void load_tile(ScanSmem& s, const int32_t* dbc,
                                          int t0, int r_end) {
  const int rows = min(kThreads, r_end - t0);
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(dbc) + static_cast<size_t>(t0) * s.w;
  for (int e = threadIdx.x; e < rows * s.w; e += kThreads) {
    const int r = e / s.w, j = e - r * s.w;
    s.rows[r * s.ws + j] = src[e];
  }
}

// distances of tile row r to the warp's 4 queries
__device__ __forceinline__ void distances(const ScanSmem& s, int r,
                                          int ql0, int dist[kQPerWarp]) {
#pragma unroll
  for (int qq = 0; qq < kQPerWarp; ++qq) dist[qq] = 0;
  const uint32_t* row = s.rows + r * s.ws;
  for (int j = 0; j < s.w; ++j) {
    const uint32_t x = row[j];
#pragma unroll
    for (int qq = 0; qq < kQPerWarp; ++qq) {
      dist[qq] += __popc(x ^ s.q[(ql0 + qq) * s.w + j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hamming_hist_kernel(const int32_t* __restrict__ qc,
                    const int32_t* __restrict__ dbc,
                    int32_t* __restrict__ hist, int b, int n, int w,
                    int rows_per_range, int n_ranges) {
  extern __shared__ uint32_t smem[];
  ScanSmem s(smem, w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kBQ;
  const int range = blockIdx.x;
  const int r_begin = range * rows_per_range;
  const int r_end = min(n, r_begin + rows_per_range);
  const int ql0 = warp * kQPerWarp;

  load_queries(s, qc, q0, b);
  for (int e = tid; e < kBQ * s.n_cls; e += kThreads) s.cnt[e] = 0;

  for (int t0 = r_begin; t0 < r_end; t0 += kThreads) {
    __syncthreads();
    load_tile(s, dbc, t0, r_end);
    __syncthreads();
    for (int base = 0; base < kThreads; base += 32) {
      const int r = base + lane;
      if (t0 + r >= r_end) break;
      int dist[kQPerWarp];
      distances(s, r, ql0, dist);
#pragma unroll
      for (int qq = 0; qq < kQPerWarp; ++qq) {
        if (q0 + ql0 + qq < b) {
          atomicAdd(&s.cnt[(ql0 + qq) * s.n_cls + dist[qq]], 1);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kBQ * s.n_cls; e += kThreads) {
    const int ql = e / s.n_cls, c = e - ql * s.n_cls;
    if (q0 + ql < b) {
      hist[(static_cast<size_t>(q0 + ql) * n_ranges + range) * s.n_cls +
           c] = s.cnt[e];
    }
  }
}

__global__ void __launch_bounds__(kSelThreads)
hamming_select_kernel(int32_t* __restrict__ hist,
                      int32_t* __restrict__ thresh, int n_cls, int n_ranges,
                      int c_out) {
  extern __shared__ int sel_smem[];
  int* base_s = sel_smem;             // [n_cls]: class totals, then bases
  int* part_s = sel_smem + n_cls;     // [kSelThreads]
  __shared__ int t_s;
  const int tid = threadIdx.x;
  int32_t* h = hist + static_cast<size_t>(blockIdx.x) * n_ranges * n_cls;

  for (int c = tid; c < n_cls; c += kSelThreads) {
    int total = 0;
    for (int r = 0; r < n_ranges; ++r) total += h[r * n_cls + c];
    base_s[c] = total;
  }
  __syncthreads();
  // exclusive prefix sum over the classes: thread tid owns a run of
  // consecutive classes
  const int per = (n_cls + kSelThreads - 1) / kSelThreads;
  const int lo = min(n_cls, tid * per), hi = min(n_cls, lo + per);
  int local = 0;
  for (int c = lo; c < hi; ++c) local += base_s[c];
  part_s[tid] = local;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int i = 0; i < kSelThreads; ++i) {
      const int x = part_s[i];
      part_s[i] = run;
      run += x;
    }
  }
  __syncthreads();
  int run = part_s[tid];
  for (int c = lo; c < hi; ++c) {
    const int total = base_s[c];
    // t: the one class where the running count first reaches C
    if (run < c_out && run + total >= c_out) t_s = c;
    base_s[c] = run;
    run += total;
  }
  __syncthreads();
  const int t = t_s;
  for (int c = tid; c <= t; c += kSelThreads) {
    int slot = base_s[c];
    for (int r = 0; r < n_ranges; ++r) {
      const int count = h[r * n_cls + c];
      h[r * n_cls + c] = slot;
      slot += count;
    }
  }
  if (tid == 0) thresh[blockIdx.x] = t;
}

__global__ void __launch_bounds__(kThreads)
hamming_scatter_kernel(const int32_t* __restrict__ qc,
                       const int32_t* __restrict__ dbc,
                       const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ thresh,
                       int32_t* __restrict__ out_d,
                       int32_t* __restrict__ out_i, int b, int n, int w,
                       int c_out, int rows_per_range, int n_ranges) {
  extern __shared__ uint32_t smem[];
  ScanSmem s(smem, w);
  __shared__ int t_s[kBQ];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kBQ;
  const int range = blockIdx.x;
  const int r_begin = range * rows_per_range;
  const int r_end = min(n, r_begin + rows_per_range);
  const int ql0 = warp * kQPerWarp;
  const unsigned lanes_below = (1u << lane) - 1u;

  load_queries(s, qc, q0, b);
  if (tid < kBQ) t_s[tid] = (q0 + tid < b) ? thresh[q0 + tid] : -1;
  __syncthreads();
  // running slot of each class <= t, starting at this range's offsets
  for (int e = tid; e < kBQ * s.n_cls; e += kThreads) {
    const int ql = e / s.n_cls, c = e - ql * s.n_cls;
    if (c <= t_s[ql]) {
      s.cnt[e] = offsets[(static_cast<size_t>(q0 + ql) * n_ranges + range) *
                             s.n_cls +
                         c];
    }
  }

  for (int t0 = r_begin; t0 < r_end; t0 += kThreads) {
    __syncthreads();
    load_tile(s, dbc, t0, r_end);
    __syncthreads();
    for (int base = 0; base < kThreads; base += 32) {
      const int r = base + lane;
      const int row = t0 + r;
      if (t0 + base >= r_end) break;   // warp-uniform
      const bool valid = row < r_end;
      int dist[kQPerWarp];
      distances(s, valid ? r : 0, ql0, dist);
#pragma unroll
      for (int qq = 0; qq < kQPerWarp; ++qq) {
        const int ql = ql0 + qq;
        const int t = t_s[ql];           // -1 past the batch
        const bool cand = valid && dist[qq] <= t;
        if (!__ballot_sync(kFull, cand)) continue;   // warp-uniform
        // lanes of one class, ranked in lane (= row) order
        const unsigned grp = __match_any_sync(kFull, cand ? dist[qq]
                                                          : -1 - lane);
        int* slot = &s.cnt[ql * s.n_cls + (cand ? dist[qq] : 0)];
        const int rank = __popc(grp & lanes_below);
        const int pos = cand ? *slot + rank : 0;
        __syncwarp();
        if (cand && rank == 0) *slot += __popc(grp);
        __syncwarp();
        if (cand && pos < c_out) {
          const size_t o = static_cast<size_t>(q0 + ql) * c_out + pos;
          out_d[o] = dist[qq];
          out_i[o] = row;
        }
      }
    }
  }
}

}  // namespace

// hist: (b, n_ranges, 32 * w + 1) int32 scratch; thresh: (b,) int32
// scratch; out_d / out_i: (b, c_out).  rows_per_range must be a
// multiple of 128 with n_ranges == ceil(n / rows_per_range).
extern "C" int hamming_topk_launch(const int32_t* qc, const int32_t* dbc,
                                   int32_t* hist, int32_t* thresh,
                                   int32_t* out_d, int32_t* out_i, int b,
                                   int n, int w, int c_out,
                                   int rows_per_range, int n_ranges,
                                   void* stream) {
  if (b <= 0 || n <= 0 || w < 1 || w > kMaxW || c_out < 1 || c_out > n ||
      rows_per_range <= 0 || rows_per_range % kThreads != 0 ||
      n_ranges != (n + rows_per_range - 1) / rows_per_range) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_cls = 32 * w + 1;
  const size_t scan_smem = scan_smem_bytes(w);
  const size_t sel_smem = 4u * (static_cast<size_t>(n_cls) + kSelThreads);
  cudaError_t err;
  err = cudaFuncSetAttribute(hamming_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(scan_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(hamming_scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(scan_smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 scan_grid(n_ranges, (b + kBQ - 1) / kBQ);
  hamming_hist_kernel<<<scan_grid, kThreads, scan_smem, s>>>(
      qc, dbc, hist, b, n, w, rows_per_range, n_ranges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hamming_select_kernel<<<b, kSelThreads, sel_smem, s>>>(
      hist, thresh, n_cls, n_ranges, c_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hamming_scatter_kernel<<<scan_grid, kThreads, scan_smem, s>>>(
      qc, dbc, hist, thresh, out_d, out_i, b, n, w, c_out, rows_per_range,
      n_ranges);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hamming_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
