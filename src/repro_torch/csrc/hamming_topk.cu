// Packed-code Hamming top-C for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hamming_topk/kernel.py :: hamming_topk_pallas
// (body _hamming_kernel, pallas_call at kernel.py:72).
//
// Computes, for query codes QC (b, w) and row codes DBC (n, w) of 32-bit
// words (int32 carrying the uint32 bits) and any 1 <= C <= n, the C rows
// nearest to each query by popcount(q ^ row): dist (b, C) int32 and
// idx (b, C) int32, ordered by (distance ascending, row ascending) --
// lax.top_k's order.  w <= kMaxW.  The plane may start at any 4-byte
// aligned address.
//
// What bounds it on the H100: it reads n*w*4 bytes and does b*n*w
// popcounts (16 per SM per clock); at the deployment batch b = 64 the
// popcounts take longer than the bytes, so it is operation-bound.
//
// Two routes, chosen by C on the host (hamming_route in
// kernels/hamming_topk/ops.py); neither gives way to the other.
//
// The list route (hamming_list_launch, C <= kListMaxC), two launches:
//   1. hamming_list_scan_kernel: one block of 8 warps per SM, each over
//      a contiguous range of rows, holding a query tile of 8, 16, 32 or
//      64 queries in shared memory (larger b: query tiles on blockIdx.y),
//      so the code plane is read once per 64 queries.  Each warp owns 8
//      queries of the tile; where the tile has fewer than 64 queries the
//      warps of one query group split the rows between them.  Rows are
//      staged tile by tile (512, 256 or 128 rows by width: one
//      contiguous run of tile_rows * w words) by cp.async into a ring of
//      4 stages, 16-byte copies where the address allows and 4-byte ones
//      at the ends of a run.  A lane takes one row of a 32-row step,
//      holds its words in registers and computes its distance to each of
//      the warp's queries exactly once; at w = 11 (the store's codes) the
//      queries' words sit in registers too, otherwise they come from
//      shared memory as 16-byte broadcasts.  No atomics.  Each (warp,
//      query) keeps an exact top-C by a warp-select (WarpSelect below): a
//      key (dist, row) packed into one unsigned integer enters a 32-slot
//      buffer only if it is below the list's C-th key, and when a buffer
//      would overflow the warp sorts all its buffers and merges them into
//      their lists by bitonic networks of shuffles, the 8 queries'
//      networks interleaved (merge_all).  Warps that split the rows fold
//      their lists in shared memory at the end, and each (query, range)
//      list goes to a (b, n_ranges, C) scratch.
//   2. hamming_list_merge_kernel: one block per query; its 8 warps fold
//      the range lists with the same warp-select, then one warp folds the
//      8 warp lists and writes (dist, idx).
//   Keys: (dist << s) | (row - r_begin) in 32 bits where 32w and the
//   range allow it (s bits hold an offset in the range), else
//   (dist << 32) | row in 64 bits; the host chooses.  Keys are unique, so
//   (dist, row) order is a total order and the result is exact.
//   What holds it back (PERF.md has the measured split): the popcounts
//   issue at about two thirds of the __popc rate, and the warp-select
//   costs about a fifth of the scan at 2^22 rows and most of it at the
//   main path's 256 rows a range.
//
// The counting route (hamming_topk_launch, any C; the wrapper sends it
// C > kListMaxC).  Distances are small bounded integers in [0, 32w],
// which makes an exact counting selection possible for every C:
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
// in: both routes are deterministic, and query j of a batch gets the
// same result as query j alone.
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

// ---------------------------------------------------------------------------
// The list route
// ---------------------------------------------------------------------------

constexpr int kListThreads = 256;
constexpr int kListWarps = kListThreads / 32;
constexpr int kQ = 8;                  // queries per warp
constexpr int kStages = 4;             // ring of staged row tiles
constexpr int kListMaxC = 128;         // 4 keys per lane of a warp list
constexpr int kSmemMax = 232448;       // a block's shared memory on sm_90
typedef unsigned long long u64;

template <typename K>
struct KeyTraits;
template <>
struct KeyTraits<uint32_t> {
  static constexpr uint32_t kSent = 0xffffffffu;
};
template <>
struct KeyTraits<u64> {
  static constexpr u64 kSent = ~0ull;
};

template <typename K>
__device__ __forceinline__ K kmin(K a, K b) {
  return a < b ? a : b;
}
template <typename K>
__device__ __forceinline__ K kmax(K a, K b) {
  return a < b ? b : a;
}

// 32 keys, one per lane, sorted ascending across the warp (bitonic)
template <typename K>
__device__ __forceinline__ K warp_sort32(K x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const K o = __shfl_xor_sync(kFull, x, stride);
      // a block of `size` lanes ascends where lane & size is 0: its
      // lower lane of a pair keeps the smaller key there
      const bool up = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      x = (low == up) ? kmin(x, o) : kmax(x, o);
    }
  }
  return x;
}

// An exact running top-C of unique keys for one (warp, query), C <= 32L.
// The list holds the 32L smallest keys offered so far, sorted ascending:
// lane l holds entries l + 32i in v[i].  `thr` is its C-th entry (the
// sentinel until C keys have come).  A key enters the warp's 32-slot
// buffer in shared memory only if it is below thr; a buffer that would
// overflow is sorted and merged into the list first.
//
// Why no member of the true top-C is ever turned away: thr is the C-th
// smallest of a subset of the keys offered (those merged so far), so it
// is at or above the C-th smallest of all of them.  A key of the true
// top-C is at most that, and not equal to thr (keys are unique, and the
// sentinel is above every real key), so it is below thr and enters.
// After the last merge the list's first C entries are therefore the
// exact top-C whatever order the keys came in (entries past C are real
// keys, but not necessarily the next smallest).
//
// Every call is warp-uniform; `cnt` is the same in every lane.
template <int L, typename K>
struct WarpSelect {
  static_assert(L == 1 || L == 2 || L == 4, "a list of 32, 64 or 128");
  static constexpr K kSent = KeyTraits<K>::kSent;
  K v[L];
  K thr;
  int cnt;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < L; ++i) v[i] = kSent;
    thr = kSent;
    cnt = 0;
  }

  // merges 32 keys sorted ascending across the warp into the list
  __device__ __forceinline__ void insert_sorted(K x, int c, int lane) {
    // the list ascends and the new keys, reversed, descend: their
    // elementwise minimum is bitonic and holds the 32L smallest of both
    v[L - 1] = kmin(v[L - 1], __shfl_sync(kFull, x, 31 - lane));
    // bitonic merge: entries 32st apart (registers), then lanes
    constexpr int kLevels = L == 4 ? 2 : L == 2 ? 1 : 0;
#pragma unroll
    for (int lv = 0; lv < kLevels; ++lv) {
      const int st = (L / 2) >> lv;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if ((i & st) == 0) {
          const K a = v[i], b = v[i + st];
          v[i] = kmin(a, b);
          v[i + st] = kmax(a, b);
        }
      }
    }
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const K o = __shfl_xor_sync(kFull, v[i], stride);
        v[i] = (lane & stride) == 0 ? kmin(v[i], o) : kmax(v[i], o);
      }
    }
    // the C-th entry: shuffled out of every register, then picked (a
    // register picked by index would put the list in local memory)
    const int e = c - 1;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const K t = __shfl_sync(kFull, v[i], e & 31);
      if (i == (e >> 5)) thr = t;
    }
  }

  // the buffer's keys (the sentinel past cnt), emptying it
  __device__ __forceinline__ K take(const K* buf, int lane) {
    __syncwarp();
    const K x = lane < cnt ? buf[lane] : kSent;
    __syncwarp();
    cnt = 0;
    return x;
  }

  __device__ __forceinline__ void merge(K* buf, int c, int lane) {
    insert_sorted(warp_sort32(take(buf, lane), lane), c, lane);
  }

  // the lanes' keys below thr go to the buffer, which must hold them
  __device__ __forceinline__ void append(K key, K* buf, int lane) {
    const unsigned m = __ballot_sync(kFull, key < thr);
    if (key < thr) buf[cnt + __popc(m & ((1u << lane) - 1u))] = key;
    cnt += __popc(m);
  }

  // one key per lane (the sentinel for none)
  __device__ __forceinline__ void offer(K key, K* buf, int c, int lane) {
    const unsigned m = __ballot_sync(kFull, key < thr);
    if (!m) return;
    if (cnt + __popc(m) > 32) merge(buf, c, lane);
    append(key, buf, lane);
  }

  __device__ __forceinline__ void flush(K* buf, int c, int lane) {
    if (cnt) merge(buf, c, lane);
  }

  // the first c entries
  template <typename D>
  __device__ __forceinline__ void store(D* dst, int c, int lane) const {
#pragma unroll
    for (int i = 0; i < L; ++i)
      if (32 * i + lane < c) dst[32 * i + lane] = v[i];
  }
};

// Merges every buffer of a warp's kQ lists at once: the sorts and
// merges of the lists are independent, so their shuffles interleave
// (one merge's latency for all of them).  An empty buffer merges only
// sentinels, which leaves its list as it was.
template <int L, typename K>
__device__ __forceinline__ void merge_all(WarpSelect<L, K> (&sel)[kQ],
                                          K* wbuf, int c, int lane) {
  K x[kQ];
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) x[qi] = sel[qi].take(wbuf + qi * 32, lane);
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) x[qi] = warp_sort32(x[qi], lane);
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) sel[qi].insert_sorted(x[qi], c, lane);
}

__device__ __forceinline__ void cp_async4(uint32_t* dst,
                                          const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A staged run starts at word head_words(src) of its stage, so 16-byte
// aligned words of the plane land on 16-byte aligned shared words.
__device__ __forceinline__ int head_words(const uint32_t* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// Copies the nw contiguous words at src into stage + head_words(src):
// the aligned middle by 16-byte copies, the words before and after it by
// 4-byte ones (nothing outside the run is read).
__device__ __forceinline__ void stage_run(uint32_t* stage,
                                          const uint32_t* src, int nw) {
  const int h = head_words(src);
  const int head = min((4 - h) & 3, nw);
  const int n16 = (nw - head) >> 2;
  const int tail = head + 4 * n16;
  uint32_t* dst = stage + h;
  const int tid = threadIdx.x;
  for (int i = tid; i < n16; i += kListThreads)
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  if (tid < head) cp_async4(dst + tid, src + tid);
  if (tid < nw - tail) cp_async4(dst + tail + tid, src + tail + tid);
}

// Shared memory of the scan (dynamic), in 32-bit words: the ring of
// staged tiles (the same words hold the row groups' lists at the end),
// the query tile ([query][wq], wq = w rounded up to 4, zero-padded), and
// each warp's 32-slot buffer per query.
struct ListLayout {
  int stage_words, ring_words, wq, q_words;
  size_t bytes;

  __host__ __device__ ListLayout(int w, int tile_rows, int query_tile,
                                 int c, int key_bytes) {
    stage_words = (tile_rows * w + 3 + 3) & ~3;
    const int fold_words = kListWarps * kQ * c * key_bytes / 4;
    ring_words = kStages * stage_words > fold_words
                     ? kStages * stage_words : fold_words;
    wq = (w + 3) & ~3;
    q_words = query_tile * wq;
    bytes = 4u * (static_cast<size_t>(ring_words) + q_words) +
            static_cast<size_t>(kListWarps) * kQ * 32 * key_bytes;
  }
};

// Distances of one row (its words at `row`) to the warp's first nq
// queries: one popcount per word and query.  W > 0 fixes w at compile
// time: the row's words and the queries' (qw, loaded once per block) are
// in registers.  W = 0 walks w in chunks of 4 words, the queries' coming
// from shared memory (at qs, wq words apart) as 16-byte broadcasts;
// words past w are zero on both sides.
template <int W>
__device__ __forceinline__ void row_dists(
    const uint32_t* row, const uint32_t* qs, int wq, int w, int nq,
    const uint32_t (&qw)[kQ][W > 0 ? W : 1], int (&dist)[kQ]) {
  if constexpr (W > 0) {
    uint32_t x[W];
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = row[j];
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      if (qi < nq) {
        int d = 0;
#pragma unroll
        for (int j = 0; j < W; ++j) d += __popc(x[j] ^ qw[qi][j]);
        dist[qi] = d;
      }
    }
  } else {
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) dist[qi] = 0;
    for (int j0 = 0; j0 < w; j0 += 4) {
      const uint32_t x0 = row[j0];
      const uint32_t x1 = j0 + 1 < w ? row[j0 + 1] : 0u;
      const uint32_t x2 = j0 + 2 < w ? row[j0 + 2] : 0u;
      const uint32_t x3 = j0 + 3 < w ? row[j0 + 3] : 0u;
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
        if (qi < nq) {
          const uint4 y = *reinterpret_cast<const uint4*>(qs + qi * wq + j0);
          dist[qi] += __popc(x0 ^ y.x) + __popc(x1 ^ y.y) +
                      __popc(x2 ^ y.z) + __popc(x3 ^ y.w);
        }
      }
    }
  }
}

// (dist, row) as one key: 32 bits hold dist << s | offset in the range,
// 64 bits dist << 32 | row
__device__ __forceinline__ uint32_t make_key(uint32_t, int dist, int off,
                                             int s, int) {
  return (static_cast<uint32_t>(dist) << s) | static_cast<uint32_t>(off);
}
__device__ __forceinline__ u64 make_key(u64, int dist, int off, int,
                                        int r_begin) {
  return (static_cast<u64>(dist) << 32) |
         static_cast<u64>(static_cast<uint32_t>(r_begin + off));
}

// A scratch key of list m (range m) as a global (dist, row) key of the
// merge: dist << out_shift | row (out_shift bits hold any row; 32 for
// 64-bit keys)
template <typename KM>
__device__ __forceinline__ KM decode_key(uint32_t k, int m,
                                         int rows_per_range, int s,
                                         int out_shift) {
  if (k == KeyTraits<uint32_t>::kSent) return KeyTraits<KM>::kSent;
  const uint32_t row = static_cast<uint32_t>(m) * rows_per_range +
                       (k & ((1u << s) - 1u));
  return (static_cast<KM>(k >> s) << out_shift) | row;
}
template <typename KM>
__device__ __forceinline__ KM decode_key(u64 k, int, int, int, int) {
  return k;  // already global (KM is 64 bits)
}

// entry e of list m (the sentinel past c)
template <typename KM, typename KIn>
__device__ __forceinline__ KM list_key(const KIn* base, int m, int e, int c,
                                       int rows_per_range, int key_shift,
                                       int out_shift) {
  return e < c ? decode_key<KM>(base[static_cast<size_t>(m) * c + e], m,
                                rows_per_range, key_shift, out_shift)
               : KeyTraits<KM>::kSent;
}

// The warp's 32-row steps rg, rg + rgs, ... of one staged tile (`rows`
// rows at `stage`, the first at offset off0 in the range): each lane's
// row against the warp's first nq queries, the keys that beat a list's
// C-th offered to it.
template <int L, typename K, int W>
__device__ __forceinline__ void scan_steps(
    const uint32_t* stage, int rows, int off0, int rg, int rgs, int lane,
    const uint32_t* wqs, int wq, int w, int nq,
    const uint32_t (&qw)[kQ][W > 0 ? W : 1], WarpSelect<L, K> (&sel)[kQ],
    K* wbuf, int c, int key_shift, int r_begin) {
  constexpr K kSent = KeyTraits<K>::kSent;
  for (int st = rg; st * 32 < rows; st += rgs) {
    const int r = st * 32 + lane;  // rows past the tile read stale words
    const bool valid = r < rows;
    int dist[kQ];
    row_dists<W>(stage + r * w, wqs, wq, w, nq, qw, dist);
    K key[kQ];
    unsigned admit = 0;  // bit qi: the lane's key enters query qi's list
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      if (qi < nq) {
        key[qi] = valid ? make_key(K(), dist[qi], off0 + r, key_shift,
                                   r_begin)
                        : kSent;
        admit |= static_cast<unsigned>(key[qi] < sel[qi].thr) << qi;
      }
    }
    admit = __reduce_or_sync(kFull, admit);
    if (admit) {
      // a buffer that would overflow merges first, and with it all the
      // warp's buffers (together they cost about one merge's latency)
      bool full = false;
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
        if ((admit >> qi) & 1u) {
          const unsigned m = __ballot_sync(kFull, key[qi] < sel[qi].thr);
          full |= sel[qi].cnt + __popc(m) > 32;
        }
      }
      if (full) merge_all(sel, wbuf, c, lane);
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi)
        if ((admit >> qi) & 1u) sel[qi].append(key[qi], wbuf + qi * 32, lane);
    }
  }
}

// One block per (row range, query tile).  Warp wi = g * rgs + rg owns
// queries g * 8 .. g * 8 + 7 of the tile and takes the 32-row steps
// rg, rg + rgs, ... of every staged tile (rgs = 64 / query_tile row
// groups).  Its lists go to part[(query, range, slot)].
template <int L, typename K, int W>
__global__ void __launch_bounds__(kListThreads, 1)
hamming_list_scan_kernel(const int32_t* __restrict__ qc,
                         const int32_t* __restrict__ dbc,
                         K* __restrict__ part, int b, int n, int w, int c,
                         int query_tile, int tile_rows, int rows_per_range,
                         int n_ranges, int key_shift) {
  constexpr K kSent = KeyTraits<K>::kSent;
  extern __shared__ __align__(16) uint32_t lsmem[];
  const ListLayout lay(w, tile_rows, query_tile, c, sizeof(K));
  uint32_t* ring = lsmem;
  uint32_t* qs = lsmem + lay.ring_words;
  K* bufs = reinterpret_cast<K*>(qs + lay.q_words);

  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const int rgs = kListWarps / (query_tile / kQ);
  const int g = wi / rgs, rg = wi - g * rgs;
  const int q0 = blockIdx.y * query_tile;
  const int qb = q0 + g * kQ;
  const int nq = max(0, min(kQ, b - qb));
  const int range = blockIdx.x;
  const int r_begin = range * rows_per_range;
  const int r_len = min(n, r_begin + rows_per_range) - r_begin;
  const int n_tiles = (r_len + tile_rows - 1) / tile_rows;
  const uint32_t* src0 =
      reinterpret_cast<const uint32_t*>(dbc) +
      static_cast<size_t>(r_begin) * w;

  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int rows = min(tile_rows, r_len - t * tile_rows);
      stage_run(ring + (t % kStages) * lay.stage_words,
                src0 + static_cast<size_t>(t) * tile_rows * w, rows * w);
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  for (int e = tid; e < lay.q_words; e += kListThreads) {
    const int j = e / lay.wq, word = e - j * lay.wq;
    qs[e] = (q0 + j < b && word < w)
                ? static_cast<uint32_t>(qc[static_cast<size_t>(q0 + j) * w +
                                           word])
                : 0u;
  }

  WarpSelect<L, K> sel[kQ];
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) sel[qi].init();
  K* wbuf = bufs + wi * kQ * 32;
  const uint32_t* wqs = qs + g * kQ * lay.wq;
  uint32_t qw[kQ][W > 0 ? W : 1];
  if constexpr (W > 0) {
    __syncthreads();  // the query tile is in shared memory
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi)
#pragma unroll
      for (int j = 0; j < W; ++j) qw[qi][j] = wqs[qi * lay.wq + j];
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    // tile t is visible to all; every warp is done with tile t - 1,
    // whose stage the next copy refills
    __syncthreads();
    issue(t + kStages - 1);
    const int rows = min(tile_rows, r_len - t * tile_rows);
    const uint32_t* stage =
        ring + (t % kStages) * lay.stage_words +
        head_words(src0 + static_cast<size_t>(t) * tile_rows * w);
    if (nq > 0)  // warp-uniform
      scan_steps<L, K, W>(stage, rows, t * tile_rows, rg, rgs, lane, wqs,
                          lay.wq, w, nq, qw, sel, wbuf, c, key_shift,
                          r_begin);
  }

  if (rgs > 1) {
    // the row groups of a query group fold their lists into the first
    // group's, through the ring's words
    cp_async_wait<0>();
    __syncthreads();
    K* fold = reinterpret_cast<K*>(ring);
    if (nq > 0) merge_all(sel, wbuf, c, lane);
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi)
      if (qi < nq) sel[qi].store(fold + (wi * kQ + qi) * c, c, lane);
    __syncthreads();
    if (rg == 0) {
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
        if (qi < nq) {
          for (int o = 1; o < rgs; ++o) {
            const K* src = fold + ((wi + o) * kQ + qi) * c;
            for (int j0 = 0; j0 < c; j0 += 32)
              sel[qi].offer(j0 + lane < c ? src[j0 + lane] : kSent,
                            wbuf + qi * 32, c, lane);
          }
        }
      }
    }
  }
  if (rg == 0 && nq > 0) {
    merge_all(sel, wbuf, c, lane);
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi)
      if (qi < nq)
        sel[qi].store(
            part + (static_cast<size_t>(qb + qi) * n_ranges + range) * c, c,
            lane);
  }
}

// One block per query: warp wi folds lists wi, wi + 8, ... of the
// query's n_lists range lists, the first 32 keys of four lists at a
// time; a list's later keys (C > 32) only while the last key read from it
// is below the warp's C-th (a list is sorted, so nothing after that key
// could enter).  Then warp 0 folds the 8 warp lists the same way and
// writes (dist, idx).  KM, the merge's key, is 32 bits where the global
// (dist, row) key fits them.
template <int L, typename KIn, typename KM>
__global__ void __launch_bounds__(kListThreads, 1)
hamming_list_merge_kernel(const KIn* __restrict__ part,
                          int32_t* __restrict__ out_d,
                          int32_t* __restrict__ out_i, int n_lists, int c,
                          int rows_per_range, int key_shift, int out_shift) {
  constexpr KM kSent = KeyTraits<KM>::kSent;
  __shared__ KM bufs[kListWarps][32];
  __shared__ KM fold[kListWarps][32 * L];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int q = blockIdx.x;
  const KIn* base = part + static_cast<size_t>(q) * n_lists * c;
  WarpSelect<L, KM> sel;
  sel.init();
  for (int m0 = wi; m0 < n_lists; m0 += 4 * kListWarps) {
    KM key[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = m0 + u * kListWarps;
      key[u] = m < n_lists ? list_key<KM>(base, m, lane, c, rows_per_range,
                                          key_shift, out_shift)
                           : kSent;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) sel.offer(key[u], bufs[wi], c, lane);
    if constexpr (L > 1) {  // C > 32: the lists' later keys
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = m0 + u * kListWarps;
        KM last = __shfl_sync(kFull, key[u], 31);
        for (int j0 = 32; m < n_lists && j0 < c && last < sel.thr;
             j0 += 32) {
          const KM k = list_key<KM>(base, m, j0 + lane, c, rows_per_range,
                                    key_shift, out_shift);
          sel.offer(k, bufs[wi], c, lane);
          last = __shfl_sync(kFull, k, 31);
        }
      }
    }
  }
  sel.flush(bufs[wi], c, lane);
  sel.store(fold[wi], 32 * L, lane);
  __syncthreads();
  if (wi != 0) return;
  for (int o = 1; o < kListWarps; ++o) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (!(fold[o][32 * i] < sel.thr)) break;  // the rest are larger
      sel.offer(fold[o][32 * i + lane], bufs[0], c, lane);
    }
  }
  sel.flush(bufs[0], c, lane);
  const KM row_mask = (KM(1) << out_shift) - 1;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int slot = 32 * i + lane;
    if (slot < c) {
      out_d[static_cast<size_t>(q) * c + slot] =
          static_cast<int32_t>(sel.v[i] >> out_shift);
      out_i[static_cast<size_t>(q) * c + slot] =
          static_cast<int32_t>(sel.v[i] & row_mask);
    }
  }
}

// out_shift < 32: the merge runs on 32-bit global keys (dist << out_shift
// | row); 32: on 64-bit ones
template <int L, typename K, int W>
cudaError_t launch_list(const int32_t* qc, const int32_t* dbc, void* part,
                        int32_t* out_d, int32_t* out_i, int b, int n, int w,
                        int c, int query_tile, int tile_rows,
                        int rows_per_range, int n_ranges, int key_shift,
                        int out_shift, cudaStream_t s) {
  static unsigned long long sized = 0;  // devices with the attribute set
  const ListLayout lay(w, tile_rows, query_tile, c, sizeof(K));
  if (lay.bytes > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(sized & bit)) {
    err = cudaFuncSetAttribute(hamming_list_scan_kernel<L, K, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return err;
    sized |= bit;
  }
  const dim3 grid(n_ranges, (b + query_tile - 1) / query_tile);
  K* keys = static_cast<K*>(part);
  hamming_list_scan_kernel<L, K, W><<<grid, kListThreads, lay.bytes, s>>>(
      qc, dbc, keys, b, n, w, c, query_tile, tile_rows, rows_per_range,
      n_ranges, key_shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (sizeof(K) == 4) {
    if (out_shift < 32) {
      hamming_list_merge_kernel<L, K, uint32_t><<<b, kListThreads, 0, s>>>(
          keys, out_d, out_i, n_ranges, c, rows_per_range, key_shift,
          out_shift);
      return cudaGetLastError();
    }
  }
  hamming_list_merge_kernel<L, K, u64><<<b, kListThreads, 0, s>>>(
      keys, out_d, out_i, n_ranges, c, rows_per_range, key_shift, 32);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_list_l(const int32_t* qc, const int32_t* dbc, void* part,
                          int32_t* out_d, int32_t* out_i, int b, int n,
                          int w, int c, int query_tile, int tile_rows,
                          int rows_per_range, int n_ranges, int key_bits,
                          int key_shift, int out_shift, cudaStream_t s) {
  if (key_bits == 64)
    return launch_list<L, u64, 0>(qc, dbc, part, out_d, out_i, b, n, w, c,
                                  query_tile, tile_rows, rows_per_range,
                                  n_ranges, key_shift, 32, s);
  if (w == 11)  // the store's codes at the default 64 scan bits
    return launch_list<L, uint32_t, 11>(qc, dbc, part, out_d, out_i, b, n,
                                        w, c, query_tile, tile_rows,
                                        rows_per_range, n_ranges, key_shift,
                                        out_shift, s);
  return launch_list<L, uint32_t, 0>(qc, dbc, part, out_d, out_i, b, n, w,
                                     c, query_tile, tile_rows,
                                     rows_per_range, n_ranges, key_shift,
                                     out_shift, s);
}

int bit_length(unsigned x) {
  int bits = 0;
  while (x) {
    ++bits;
    x >>= 1;
  }
  return bits;
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

// The list route, C <= 128.  part: (b, n_ranges, c) scratch of key_bits
// (32 or 64) keys; out_d / out_i: (b, c).  query_tile is 8, 16, 32 or
// 64; tile_rows a multiple of 32; n_ranges == ceil(n / rows_per_range).
// 32-bit keys need bit_length(32 w) + bit_length(rows_per_range - 1)
// <= 32.
extern "C" int hamming_list_launch(const int32_t* qc, const int32_t* dbc,
                                   void* part, int32_t* out_d,
                                   int32_t* out_i, int b, int n, int w,
                                   int c, int query_tile, int tile_rows,
                                   int rows_per_range, int n_ranges,
                                   int key_bits, void* stream) {
  const bool tile_ok = query_tile == 8 || query_tile == 16 ||
                       query_tile == 32 || query_tile == 64;
  if (b <= 0 || n <= 0 || w < 1 || w > kMaxW || c < 1 || c > n ||
      c > kListMaxC || !tile_ok || tile_rows <= 0 || tile_rows % 32 != 0 ||
      rows_per_range <= 0 ||
      n_ranges != (n + rows_per_range - 1) / rows_per_range ||
      (key_bits != 32 && key_bits != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int key_shift = bit_length(static_cast<unsigned>(rows_per_range - 1));
  if (key_bits == 32 && bit_length(32u * w) + key_shift > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  // the merge's keys: 32 bits where dist << out_shift | row fits them
  const int row_bits = bit_length(static_cast<unsigned>(n - 1));
  const int out_shift =
      key_bits == 32 && bit_length(32u * w) + row_bits <= 32 ? row_bits : 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (c <= 32)
    err = launch_list_l<1>(qc, dbc, part, out_d, out_i, b, n, w, c,
                           query_tile, tile_rows, rows_per_range, n_ranges,
                           key_bits, key_shift, out_shift, s);
  else if (c <= 64)
    err = launch_list_l<2>(qc, dbc, part, out_d, out_i, b, n, w, c,
                           query_tile, tile_rows, rows_per_range, n_ranges,
                           key_bits, key_shift, out_shift, s);
  else
    err = launch_list_l<4>(qc, dbc, part, out_d, out_i, b, n, w, c,
                           query_tile, tile_rows, rows_per_range, n_ranges,
                           key_bits, key_shift, out_shift, s);
  return static_cast<int>(err);
}

extern "C" const char* hamming_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
