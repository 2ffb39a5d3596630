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
// The score chain.  A (query, row) score is acc = 0, then
// acc = fmaf(db[r][f], q[j][f], acc) for f = 0 .. d-1 in that order,
// with nothing padded.  The scan, whatever its variant, and the rescore
// below both run exactly this chain, so b = 1 is bitwise b = 64 and a
// rescored score is bitwise the scan's.  That rules out the tensor cores
// (TF32 or split products) and any split of d.
//
// What bounds it on the H100: it reads n*d*4 bytes and does 2*b*n*d fp32
// FLOP on the FMA units.  At b = 64 the FLOP bound (67 TFLOP/s) is above
// the byte bound (3.35 TB/s): 2.075 against 1.30 ms at n = 2^22, d = 259;
// at b <= 16 the bytes bound it.  Three things keep it from those bounds:
//   * the FMA loop: with both operands in registers this 8 x 16 tile
//     issues at about 60 % of the fp32 peak (dependent-free FFMAs, 8 warps
//     per SM); shared-memory operands cost a few points more;
//   * the row stride: d = 259 gives 1036-byte rows, so a 16-feature chunk
//     of a row is an unaligned 64-byte piece, and staging every row's
//     piece per chunk reads DRAM in scattered pieces (about 2 TB/s when
//     nothing else runs);
//   * the two overlap only in part: both go through the SM's load/store
//     path, and a chunk's barrier waits for its slowest warp.
// PERF.md has the measured split.
//
// Design (mips_scan_kernel<M, N>, one block of 256 threads per SM):
//   * One DB pass per batch.  A block holds 4N queries: 64 (N = 16) or
//     16 (N = 4, for b <= 16, so b = 1 does not pay 64x the FMAs); larger
//     b is cut into query tiles on blockIdx.y.  Each block walks a
//     contiguous range of row tiles of 64M rows (512, or 256 where the
//     512-row tiles would leave SMs idle).
//   * Register tile: a warp is 8 lanes along the rows x 4 along the
//     queries; a lane scores rows w*8M + 8i + lr (i < M) against queries
//     16h + 4lq + e, M x N accumulators (128 at 8 x 16).  Per feature it
//     reads M row scalars and N/4 query float4s from shared memory.
//   * Staging: a ring of up to 4 stages of 16 features, filled with
//     cp.async and one wait and one barrier per chunk.  Rows are copied as
//     the 16-byte blocks that hold their features (cp.async.cg, zero fill
//     past the chunk, an L2 prefetch hint of 256 bytes for the next
//     chunks), into a row-major stage of pitch 20 floats; a row's features
//     then start at its offset within its first block, which for this
//     lane's rows is one value (tiles start at multiples of 4 rows and
//     chunks at multiples of 16 features).  Pitch 20 puts 8 consecutive
//     rows in 8 distinct 4-bank groups: the row reads are conflict-free
//     for every d and any 4-byte-aligned base.  Queries are copied
//     4 bytes a lane into a [feature][query] stage.
//   * Fold, after a tile's last chunk: each lane queues (shared-memory
//     atomics into a per-query queue) its scores that beat the query's
//     k-th entry as of the last fold; on a block's first tile also not
//     below a lower bound on it (the k-th best of 32 distinct rows' pairs:
//     each warp's 4 best lane maxima), which holds where rows tie too.
//     One compare of a query's best row clears its M rows at once.  The
//     owning warp sorts a queue (bitonic, in registers), offers it best
//     first to the query's list (kept in shared memory) and publishes the
//     new k-th entry.  A full queue keeps the rest for another round.
//   * mips_merge_kernel: one warp per query folds the per-range lists,
//     skipping every candidate below the k-th best of the lists' first
//     entries (each list is sorted, and its first entries are distinct
//     rows).
// mips_rescore_kernel (entry mips_rescore_launch) scores a per-query list
// of gathered rows with the same chain, in one launch with no scratch:
// the exact rescore of the two-stage quantized scan, which is XLA in the
// JAX package (src/repro/kernels/quantized_scan/ops.py:229, in
// _two_stage).  Its design is at the kernel.  Rows past the end of a
// range or of the DB are never candidates;
// unfilled list slots hold (-inf, INT_MAX), which every real score
// beats — including the store's masked rows at MASK_BIAS = -3e30.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // merge blocks
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;
constexpr int kNoIdx = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// the scan
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;  // each along the rows
constexpr int kChunk = 16;             // features per stage
constexpr int kBlocks = kChunk / 4 + 1;  // 16-byte blocks per staged row
constexpr int kPitchR = 4 * kBlocks;   // floats per staged row, = 4 mod 8
constexpr int kQueue = 32;             // candidate slots per query and round
constexpr int kSmemMax = 232448;       // a block's shared memory on sm_90

// the rescore
constexpr int kRescoreTile = 32;       // candidates per warp tile, a lane each
constexpr int kRescoreChunk = 64;      // features per stage
constexpr int kRescoreBlocks = kRescoreChunk / 4 + 1;  // 16-byte blocks a row
constexpr int kRescorePitch = 4 * kRescoreBlocks;      // = 4 mod 8 floats
constexpr int kRescoreStages = 2;      // per warp
// a stage: the tile's rows (row-major), then the query's features
constexpr int kRescoreStageFloats =
    kRescoreTile * kRescorePitch + kRescoreChunk;
constexpr int kRescoreMaxWarps = 8;    // per block
constexpr int kMaxCluster = 8;         // the portable cluster size
// a warp's ring and its list
constexpr int kRescoreWarpBytes =
    kRescoreStages * kRescoreStageFloats * 4 + 8 * kMaxK;
static_assert(kRescoreStageFloats % 4 == 0 && kRescorePitch % 8 == 4 &&
                  kRescoreTile * kRescoreBlocks % 32 == 0,
              "16-byte aligned stages, rows and query chunks; whole "
              "warp instructions of row blocks");
static_assert(kRescoreTile * kRescorePitch <= 0xffff,
              "a stage offset fits 16 bits");
static_assert(kRescoreMaxWarps * kRescoreWarpBytes <= kSmemMax,
              "rescore block exceeds shared memory");

// A scan variant: each lane scores M rows x N queries (N a multiple of
// 4); a warp is 8 lanes along the rows x 4 along the queries.
template <int M, int N>
struct Scan {
  static constexpr int kM = M, kN = N;
  static constexpr int kBQ = 4 * N;                // queries per block
  static constexpr int kRows = kScanWarps * 8 * M; // rows per tile
  static constexpr int kLists = kBQ / kScanWarps;  // queries per warp
  // row-major row stage (pitch kPitchR), feature-major query stage
  // ([feature][query]); a query pitch of 4 mod 8 floats keeps its 4-byte
  // writes conflict-free
  static constexpr int kPitchQ = kBQ + 4;
  static constexpr int kStageFloats = kRows * kPitchR + kChunk * kPitchQ;
  // per query: its top-k list, its candidate queue (which also holds the
  // warps' best pairs before a first tile is queued), its lower bound
  // pair, k-th entry and count
  static constexpr int kFoldBytes = kBQ * (8 * kMaxK + 8 * kQueue + 20);
  static constexpr int kStages =
      (kSmemMax - kFoldBytes) / (4 * kStageFloats) < 4
          ? (kSmemMax - kFoldBytes) / (4 * kStageFloats) : 4;
  static constexpr int kSmemBytes = kStages * kStageFloats * 4 + kFoldBytes;
  static_assert(kStages >= 2, "scan stages exceed shared memory");
  static_assert(kPitchR % 8 == 4 && kPitchQ % 8 == 4, "pitch");
};

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

  // offer one candidate per lane (valid lanes only), lowest lane first;
  // (tv, ti) holds the list's k-th entry and is kept current, so a
  // ballot that no lane wins costs one compare, and a candidate that the
  // raised entry beats is never inserted
  __device__ __forceinline__ void offer(float s, int idx, bool valid, int k,
                                        int lane, float& tv, int& ti) {
    unsigned m = __ballot_sync(kFull, valid && better(s, idx, tv, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      const float cv = __shfl_sync(kFull, s, src);
      const int ci = __shfl_sync(kFull, idx, src);
      insert(cv, ci, k, lane);
      kth(k, tv, ti);
      // drop the lanes the raised k-th entry now beats
      m &= (m - 1) & __ballot_sync(kFull, valid && better(s, idx, tv, ti));
    }
  }

  __device__ __forceinline__ void offer(float s, int idx, bool valid, int k,
                                        int lane) {
    float tv;
    int ti;
    kth(k, tv, ti);
    offer(s, idx, valid, k, lane, tv, ti);
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

// Sorts one (v, i) pair per lane across each group of W lanes (lane l
// is place l % W of its group) by (v desc, i asc): a bitonic network of
// shfl_xor exchanges.
template <int W>
__device__ __forceinline__ void sort_lanes(float& v, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= W; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, stride);
      const int oi = __shfl_xor_sync(kFull, i, stride);
      // a block sorts descending where lane & size is 0: its lower lane
      // keeps the better pair there, the worse one elsewhere
      const bool keep_better =
          ((lane & stride) == 0) == ((lane & size & (W - 1)) == 0);
      if (keep_better == better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
  }
}

__device__ __forceinline__ void warp_sort(float& v, int& i, int lane) {
  sort_lanes<32>(v, i, lane);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// 16 bytes from a 16-byte-aligned src, of which the first src_bytes
// are read and the rest zeroed; L2 fetches the 256 bytes around them,
// which the next chunks of the row (and the next rows) read
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(s),
      "l"(src), "r"(src_bytes));
}

// the same without the L2 prefetch (a gathered row's neighbours are not
// read), and nothing at all, not even the zero fill, where src_bytes is 0
__device__ __forceinline__ void cp_async16_row(float* dst, const float* src,
                                               int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.cg.shared.global [%0], [%1], 16, %2;\n}\n" ::"r"(s),
      "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One feature of the chain: the lane's M rows (scalars, 8 rows apart in
// the row-major stage) against its N queries (N/4 float4s of the
// feature-major query stage).
template <int M, int N>
__device__ __forceinline__ void fma_feature(const float* __restrict__ rows,
                                            const float* __restrict__ qs,
                                            float (&acc)[M][N]) {
  float x[M];
  float4 w[N / 4];
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = rows[i * 8 * kPitchR];
#pragma unroll
  for (int h = 0; h < N / 4; ++h)
    w[h] = *reinterpret_cast<const float4*>(qs + h * 16);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      acc[i][4 * h + 0] = fmaf(x[i], w[h].x, acc[i][4 * h + 0]);
      acc[i][4 * h + 1] = fmaf(x[i], w[h].y, acc[i][4 * h + 1]);
      acc[i][4 * h + 2] = fmaf(x[i], w[h].z, acc[i][4 * h + 2]);
      acc[i][4 * h + 3] = fmaf(x[i], w[h].w, acc[i][4 * h + 3]);
    }
}

// One block per (query tile, row range), walking the range's tiles.
// Lane (lr, lq) of warp w scores tile rows w*8*M + 8i + lr (i < M)
// against block queries 16h + 4lq + e (h < N/4, e < 4), query index
// t = 4h + e.  The per-(query, range) lists go to a (b, n_ranges, k)
// scratch.
template <int M, int N>
__global__ void __launch_bounds__(kScanThreads, 1)
mips_scan_kernel(const float* __restrict__ q, const float* __restrict__ db,
                 float* __restrict__ part_v, int32_t* __restrict__ part_i,
                 int b, int n, int d, int k, int rows_per_range,
                 int n_ranges) {
  using S = Scan<M, N>;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(16) float smem[];
  float* list_v = smem + kStages * S::kStageFloats;        // [kBQ][kMaxK]
  int* list_i = reinterpret_cast<int*>(list_v + S::kBQ * kMaxK);
  float* queue_v = reinterpret_cast<float*>(list_i + S::kBQ * kMaxK);
  int* queue_i = reinterpret_cast<int*>(queue_v + S::kBQ * kQueue);
  float* thr_v = reinterpret_cast<float*>(queue_i + S::kBQ * kQueue);
  int* thr_i = reinterpret_cast<int*>(thr_v + S::kBQ);
  int* cnt = thr_i + S::kBQ;
  float* lower_v = reinterpret_cast<float*>(cnt + S::kBQ);
  int* lower_i = reinterpret_cast<int*>(lower_v + S::kBQ);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lr = lane & 7, lq = lane >> 3;
  const int row_base = warp * 8 * M + lr;  // + 8i
  const int q_base = lq * 4;
  const int q0 = blockIdx.y * S::kBQ;
  const int range = blockIdx.x;
  const int r_begin = range * rows_per_range;
  const int r_end = min(n, r_begin + rows_per_range);
  const int n_chunks = (d + kChunk - 1) / kChunk;
  const int n_steps =
      (r_end - r_begin + S::kRows - 1) / S::kRows * n_chunks;
  // A staged row starts at the 16-byte block holding its first feature,
  // so feature c of tile row r sits at r * kPitchR + o_r + c, with o_r
  // the row start's float offset within its block.  Tiles start at
  // multiples of 4 rows and chunks at multiples of 16 features, so o_r
  // depends on r mod 4 only: every row of this lane shares one offset.
  const int base_off = static_cast<int>(
      (reinterpret_cast<uintptr_t>(db) >> 2) & 3);
  const int lane_off = (base_off + lr * (d & 3)) & 3;

  for (int e = tid; e < S::kBQ * kMaxK; e += kScanThreads) {
    list_v[e] = -INFINITY;
    list_i[e] = kNoIdx;
  }
  for (int j = tid; j < S::kBQ; j += kScanThreads) {
    thr_v[j] = -INFINITY;
    thr_i[j] = kNoIdx;
    cnt[j] = 0;
  }

  // step s stages features [f0, f0 + len) of tile s / n_chunks: each
  // row as the 16-byte blocks that hold them (consecutive threads take
  // consecutive blocks; nothing past the last feature is read, and the
  // o floats before the first share its aligned block, so they lie in
  // the tensor's allocation), and
  // the queries 4 x 8 features per warp instruction, 4 bytes a lane,
  // written transposed.  Rows past the range and queries past b are not
  // copied.
  const int sub = lane & 3, feat = lane >> 2;
  auto stage_load = [&](int s) {
    if (s < n_steps) {
      const int tile = s / n_chunks;
      const int f0 = (s - tile * n_chunks) * kChunk;
      const int len = min(kChunk, d - f0);
      const int t0 = r_begin + tile * S::kRows;
      float* rows_s = smem + (s % kStages) * S::kStageFloats;
      float* q_s = rows_s + S::kRows * kPitchR;
#pragma unroll 4
      for (int e = tid; e < S::kRows * kBlocks; e += kScanThreads) {
        const int r = e / kBlocks, blk = e - r * kBlocks;
        if (t0 + r >= r_end) continue;
        const float* first = db + static_cast<size_t>(t0 + r) * d + f0;
        const int o = static_cast<int>(
            (reinterpret_cast<uintptr_t>(first) >> 2) & 3);
        const int left = o + len - 4 * blk;   // floats still needed
        if (left > 0)
          cp_async16(rows_s + r * kPitchR + 4 * blk,
                     first - o + 4 * blk, 4 * min(4, left));
      }
#pragma unroll
      for (int p = warp; p < S::kBQ * kChunk / 32; p += kScanWarps) {
        const int j = 4 * (p / (kChunk / 8)) + sub;
        const int c = 8 * (p % (kChunk / 8)) + feat;
        if (c < len && q0 + j < b)
          cp_async4(q_s + c * S::kPitchQ + j,
                    q + static_cast<size_t>(q0 + j) * d + f0 + c);
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  float acc[M][N];

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage_load(s);

  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();
    // step s is visible to all; every thread is done with step s - 1,
    // whose stage the next load refills
    __syncthreads();
    stage_load(s + kStages - 1);
    const int tile = s / n_chunks;
    const int chunk = s - tile * n_chunks;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int t = 0; t < N; ++t) acc[i][t] = 0.f;
    }
    const float* stage = smem + (s % kStages) * S::kStageFloats;
    const float* rows_s = stage + row_base * kPitchR + lane_off;
    const float* q_s = stage + S::kRows * kPitchR + q_base;
    const int len = min(kChunk, d - chunk * kChunk);
    if (len == kChunk) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        fma_feature(rows_s + c, q_s + c * S::kPitchQ, acc);
    } else {
#pragma unroll 1
      for (int c = 0; c < len; ++c)
        fma_feature(rows_s + c, q_s + c * S::kPitchQ, acc);
    }
    if (chunk != n_chunks - 1) continue;

    // The tile is scored.  Each lane queues its scores that beat their
    // query's k-th entry (as of the last fold) and, on a block's first
    // tile, are not below a lower bound on it; the owning warps fold the
    // queues, in rounds until no lane holds a pending score (a full queue
    // leaves the rest for the next round, against the raised entry).
    // Past the first tiles a lane rarely has a score to queue: one
    // compare of a query's best row here clears its M rows.
    const int t0 = r_begin + tile * S::kRows + row_base;
    // The lower bound, a (score, row) pair: each warp offers the 4 best
    // of its lanes' best rows per query (distinct rows), so for k <= 32
    // the k-th best of those 32 pairs is at most the query's k-th entry
    // after this tile.  It keeps a block's first tile from queueing every
    // row, also where rows tie (the store's padding rows all score the
    // mask bias).
    constexpr int kTop = kQueue / kScanWarps;
    static_assert(kTop * kScanWarps == 32, "one pair per lane");
    const bool bounded = k <= 32 && tile == 0;
    if (bounded) {
#pragma unroll
      for (int t = 0; t < N; ++t) {
        float bv = -INFINITY;
        int bi = kNoIdx;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const int row = t0 + 8 * i;
          if (row < r_end && better(acc[i][t], row, bv, bi)) {
            bv = acc[i][t];
            bi = row;
          }
        }
        sort_lanes<8>(bv, bi, lr);  // the query's 8 lanes of this warp
        if (lr < kTop) {
          const int e = (warp * kTop + lr) * S::kBQ + (t / 4) * 16 +
                        q_base + t % 4;
          queue_v[e] = bv;
          queue_i[e] = bi;
        }
      }
      __syncthreads();
#pragma unroll 1
      for (int u = 0; u < S::kLists; ++u) {
        const int j = warp * S::kLists + u;
        float v = queue_v[lane * S::kBQ + j];
        int i = queue_i[lane * S::kBQ + j];
        warp_sort(v, i, lane);
        v = __shfl_sync(kFull, v, k - 1);
        i = __shfl_sync(kFull, i, k - 1);
        if (lane == 0) {
          lower_v[j] = v;
          lower_i[j] = i;
        }
      }
      __syncthreads();
    }
    constexpr int kWords = (M * N + 31) / 32;
    unsigned pend[kWords];  // bit i * N + t: score (i, t) still to queue
#pragma unroll
    for (int w = 0; w < kWords; ++w) pend[w] = 0;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const int j = (t / 4) * 16 + q_base + t % 4;
      const float lo = bounded ? fmaxf(lower_v[j], thr_v[j]) : thr_v[j];
      float mx = acc[0][t];
#pragma unroll
      for (int i = 1; i < M; ++i) mx = fmaxf(mx, acc[i][t]);
      if (q0 + j < b && mx >= lo) {
#pragma unroll
        for (int i = 0; i < M; ++i)
          pend[(i * N + t) / 32] |= 1u << ((i * N + t) % 32);
      }
    }
    for (;;) {
      bool left = false;
#pragma unroll
      for (int t = 0; t < N; ++t) {
        const int j = (t / 4) * 16 + q_base + t % 4;
        const float tv = thr_v[j];
        const int ti = thr_i[j];
        const float lv = bounded ? lower_v[j] : -INFINITY;
        const int li = bounded ? lower_i[j] : kNoIdx;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const int bit = i * N + t;
          const unsigned mask = 1u << (bit % 32);
          if (!(pend[bit / 32] & mask)) continue;
          const int row = t0 + 8 * i;
          // beats the k-th entry and is not below the bound pair
          if (q0 + j < b && row < r_end && !better(lv, li, acc[i][t], row) &&
              better(acc[i][t], row, tv, ti)) {
            const int slot = atomicAdd(&cnt[j], 1);
            if (slot >= kQueue) {
              left = true;
              continue;
            }
            queue_v[j * kQueue + slot] = acc[i][t];
            queue_i[j * kQueue + slot] = row;
          }
          pend[bit / 32] &= ~mask;
        }
      }
      __syncthreads();
#pragma unroll 1
      for (int u = 0; u < S::kLists; ++u) {
        const int j = warp * S::kLists + u;
        const int c = min(cnt[j], kQueue);
        if (c == 0) continue;  // warp-uniform
        WarpTopK list;
        list.v0 = list_v[j * kMaxK + lane];
        list.i0 = list_i[j * kMaxK + lane];
        list.v1 = list_v[j * kMaxK + lane + 32];
        list.i1 = list_i[j * kMaxK + lane + 32];
        // best first: the list takes at most k of them, and the raised
        // k-th entry turns the rest away in one ballot
        float qv = lane < c ? queue_v[j * kQueue + lane] : -INFINITY;
        int qi = lane < c ? queue_i[j * kQueue + lane] : kNoIdx;
        warp_sort(qv, qi, lane);
        list.offer(qv, qi, lane < c, k, lane);
        list_v[j * kMaxK + lane] = list.v0;
        list_i[j * kMaxK + lane] = list.i0;
        list_v[j * kMaxK + lane + 32] = list.v1;
        list_i[j * kMaxK + lane + 32] = list.i1;
        float tv;
        int ti;
        list.kth(k, tv, ti);
        if (lane == 0) {
          thr_v[j] = tv;
          thr_i[j] = ti;
          cnt[j] = 0;
        }
      }
      if (!__syncthreads_or(left)) break;
    }
  }

  __syncthreads();
  for (int e = tid; e < S::kBQ * kMaxK; e += kScanThreads) {
    const int j = e / kMaxK, slot = e % kMaxK;
    if (q0 + j >= b || slot >= k) continue;
    const size_t off =
        (static_cast<size_t>(q0 + j) * n_ranges + range) * k + slot;
    part_v[off] = list_v[e];
    part_i[off] = list_i[e];
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
  float tv;
  int ti;
  list.kth(k, tv, ti);
  const float* pv = part_v + static_cast<size_t>(qi) * n_cand;
  const int32_t* pi = part_i + static_cast<size_t>(qi) * n_cand;
  // The candidates are n_cand / k lists, each sorted best first and of
  // distinct rows.  Lane l's best first entry among lists l, l + 32, ...
  // is one row, so the k-th best over the lanes (k <= 32) is at most the
  // final k-th score: a candidate below it is never offered.
  float lo = -INFINITY;
  if (k <= 32) {
    float bv = -INFINITY;
    int bi = kNoIdx;
    for (int m = lane; m * k < n_cand; m += 32) {
      if (better(pv[m * k], pi[m * k], bv, bi)) {
        bv = pv[m * k];
        bi = pi[m * k];
      }
    }
    warp_sort(bv, bi, lane);
    lo = __shfl_sync(kFull, bv, k - 1);
  }
  for (int base = 0; base < n_cand; base += 32) {
    const int c = base + lane;
    const bool valid = c < n_cand && pv[c] >= lo;
    list.offer(valid ? pv[c] : -INFINITY, valid ? pi[c] : kNoIdx, valid,
               k, lane, tv, ti);
  }
  list.store(out_v + static_cast<size_t>(qi) * k,
             out_i + static_cast<size_t>(qi) * k, k, lane);
}

// The rescore of the two-stage quantized scan, one launch a call: each
// warp scores tiles of 32 of one query's candidates (its list cand[qi]),
// one candidate a lane, so a (query, row) score is one thread's fmaf
// chain over f = 0 .. d-1, bitwise the score mips_scan_kernel computes
// for that row.
//   * Grid (rescore_grid in kernels/common.py): a block holds
//     queries_per_block queries of warps_per_query warps each, and of
//     each query the candidates [rank * cands_per_block, + cands_per_block),
//     rank being its place in a cluster of `cluster` blocks (1: no
//     cluster).  Warp j of a query takes the block's tiles j,
//     j + warps_per_query, ...
//   * Staging: a ring of kRescoreStages stages per warp, filled with
//     cp.async and drained with one wait and one __syncwarp per stage
//     (warps never wait for each other).  A stage holds 64 features of
//     the tile's 32 rows, each row as the 16-byte blocks that hold them
//     (as the scan stages them: zero fill past the chunk, so any
//     4-byte-aligned base works; 17 blocks of all 32 rows are 17 warp
//     instructions), and the query's same features (4 bytes a lane),
//     read as float4 broadcasts.  Lane r reads its row at its offset in
//     its first block; the pitch of 68 floats puts lanes 8 apart in one
//     4-bank group, so rows whose offsets agree there share a bank.  The
//     next stages' copies are in flight while this stage's FMAs run,
//     also across the warp's tiles.
//   * Selection: each warp sorts a tile's 32 (score, row) pairs; its first
//     tile's best k are its list as they stand, and a later tile with a
//     pair that beats the list's k-th entry is offered best first to its
//     WarpTopK.  The warps of a query fold their
//     lists in shared memory; a cluster's first block folds its members'
//     lists through distributed shared memory and writes the outputs.
// Rows outside [0, n) are never scored; unfilled slots hold (-inf,
// INT_MAX).  What bounds it: the gathered rows' bytes (b * C * d * 4, the
// distinct rows at least); its FMAs (b * C * d) are far below the peak.
__global__ void __launch_bounds__(kRescoreMaxWarps * 32, 1)
mips_rescore_kernel(const float* __restrict__ q, const float* __restrict__ db,
                    const int32_t* __restrict__ cand,
                    float* __restrict__ out_v, int32_t* __restrict__ out_i,
                    int b, int n, int d, int n_cand, int k,
                    int queries_per_block, int warps_per_query,
                    int cands_per_block, int cluster) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* ring = smem + warp * kRescoreStages * kRescoreStageFloats;
  float* list_v = smem + warps * kRescoreStages * kRescoreStageFloats;
  int* list_i = reinterpret_cast<int*>(list_v + warps * kMaxK);

  // a 1-D cluster is `cluster` consecutive blocks
  const int rank = blockIdx.x % cluster;
  const int qi = (blockIdx.x / cluster) * queries_per_block +
                 warp / warps_per_query;
  const int j = warp % warps_per_query;
  const int p_end = min(n_cand, (rank + 1) * cands_per_block);
  const int first = rank * cands_per_block + kRescoreTile * j;
  const int stride = kRescoreTile * warps_per_query;
  const int n_tiles =
      qi < b && first < p_end ? (p_end - first + stride - 1) / stride : 0;
  const int n_chunks = (d + kRescoreChunk - 1) / kRescoreChunk;
  const int n_steps = n_tiles * n_chunks;
  const int32_t* my_cand = cand + static_cast<size_t>(qi) * n_cand;
  const float* my_q = q + static_cast<size_t>(qi) * d;

  // the lane's candidate of tile t as stored (checked where it is used,
  // so that a prefetch does not wait for its load), -1 past the tiles
  auto cand_of = [&](int t) {
    const int p = first + t * stride + lane;
    return t < n_tiles && p < p_end ? __ldg(my_cand + p) : -1;
  };
  auto scored = [&](int row) {
    return static_cast<unsigned>(row) < static_cast<unsigned>(n);
  };

  // the float offset of a row's features within their 16-byte blocks (a
  // chunk starts at a multiple of 4 features)
  auto offset_of = [&](int row) {
    return static_cast<int>(
        (reinterpret_cast<uintptr_t>(db + static_cast<size_t>(row) * d) >>
         2) & 3);
  };

  // step s stages features [f0, f0 + len) of tile s / n_chunks: each row
  // as the 16-byte blocks that hold them (consecutive lanes take
  // consecutive blocks: lane l copies blocks l, l + 32, ... of the tile's
  // 32 x kRescoreBlocks; nothing past the chunk is read, and the o floats
  // before it share its first block, so they lie in the tensor's
  // allocation), and the query's, 4 bytes a lane.  Where each of the
  // lane's blocks comes from and goes is worked out once a tile, so a
  // chunk's copies are one add and one predicated cp.async each.
  constexpr int kCopies = kRescoreTile * kRescoreBlocks / 32;
  const float* src[kCopies];  // the block at feature 0 of the chunk
  // its place in a stage (low 16 bits), and the floats of it to read less
  // the chunk's len, plus kRescoreChunk (high): one register, no spill
  int place[kCopies];
  int next_row = cand_of(0);
  auto stage_load = [&](int s) {
    if (s < n_steps) {
      const int t = s / n_chunks;
      const int c = s - t * n_chunks;
      if (c == 0) {  // the next tile's candidates load meanwhile
        const int ld_row = next_row;
        next_row = cand_of(t + 1);
#pragma unroll
        for (int i = 0; i < kCopies; ++i) {
          const int e = lane + 32 * i;
          const int r = e / kRescoreBlocks, blk = e - r * kRescoreBlocks;
          const int row = __shfl_sync(kFull, ld_row, r);
          const int o = offset_of(row);
          src[i] = db + static_cast<size_t>(row) * d - o + 4 * blk;
          // a row that is not scored reads nothing
          const int need = scored(row) ? o - 4 * blk : -kRescoreChunk;
          place[i] = r * kRescorePitch + 4 * blk +
                     ((need + kRescoreChunk) << 16);
        }
      }
      const int f0 = c * kRescoreChunk;
      const int len = min(kRescoreChunk, d - f0);
      float* st = ring + (s % kRescoreStages) * kRescoreStageFloats;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int left = (place[i] >> 16) - kRescoreChunk + len;
        cp_async16_row(st + (place[i] & 0xffff), src[i] + f0,
                       4 * max(0, min(4, left)));
      }
      float* qs = st + kRescoreTile * kRescorePitch;
#pragma unroll
      for (int f = lane; f < kRescoreChunk; f += 32)
        if (f < len) cp_async4(qs + f, my_q + f0 + f);
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  WarpTopK list;
  list.init();
  float tv;
  int ti;
  list.kth(k, tv, ti);

#pragma unroll
  for (int s = 0; s < kRescoreStages - 1; ++s) stage_load(s);

  float acc = 0.f;
  int row = -1;
  const float* x = ring;  // the lane's row in stage 0
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kRescoreStages - 2>();
    // step s is visible to the whole warp, and every lane is done with
    // step s - 1, whose stage the next load refills
    __syncwarp();
    stage_load(s + kRescoreStages - 1);
    const int t = s / n_chunks;
    const int c = s - t * n_chunks;
    if (c == 0) {
      acc = 0.f;
      row = cand_of(t);
      x = ring + lane * kRescorePitch + offset_of(row);
    }
    const int stage = (s % kRescoreStages) * kRescoreStageFloats;
    const float* w = ring + stage + kRescoreTile * kRescorePitch;
    const int len = min(kRescoreChunk, d - c * kRescoreChunk);
    if (len == kRescoreChunk) {
#pragma unroll
      for (int f = 0; f < kRescoreChunk; f += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(w + f);
        acc = fmaf(x[stage + f + 0], w4.x, acc);
        acc = fmaf(x[stage + f + 1], w4.y, acc);
        acc = fmaf(x[stage + f + 2], w4.z, acc);
        acc = fmaf(x[stage + f + 3], w4.w, acc);
      }
    } else {
#pragma unroll 1
      for (int f = 0; f < len; ++f) acc = fmaf(x[stage + f], w[f], acc);
    }
    if (c == n_chunks - 1) {
      float v = scored(row) ? acc : -INFINITY;
      int i = scored(row) ? row : kNoIdx;
      if (t == 0) {
        // an empty list takes the tile's best k as they stand
        warp_sort(v, i, lane);
        list.v0 = lane < k ? v : -INFINITY;
        list.i0 = lane < k ? i : kNoIdx;
        list.kth(k, tv, ti);
      } else if (__any_sync(kFull, better(v, i, tv, ti))) {
        // best first: the list takes at most k of them, and the raised
        // k-th entry turns the rest away in one ballot
        warp_sort(v, i, lane);
        list.offer(v, i, i != kNoIdx, k, lane, tv, ti);
      }
    }
  }
  cp_async_wait<0>();

  // another warp's sorted list (here or in a cluster member), best first
  auto fold = [&](const float* lv, const int* li) {
    list.offer(lv[lane], li[lane], lane < k, k, lane, tv, ti);
    if (k > 32)
      list.offer(lv[lane + 32], li[lane + 32], lane + 32 < k, k, lane, tv,
                 ti);
  };
  auto publish = [&](int slot) {
    list_v[slot * kMaxK + lane] = list.v0;
    list_i[slot * kMaxK + lane] = list.i0;
    list_v[slot * kMaxK + lane + 32] = list.v1;
    list_i[slot * kMaxK + lane + 32] = list.i1;
  };
  if (warps_per_query > 1) {  // block-uniform
    publish(warp);
    __syncthreads();
    if (j == 0 && qi < b)
      for (int o = 1; o < warps_per_query; ++o)
        fold(list_v + (warp + o) * kMaxK, list_i + (warp + o) * kMaxK);
  }
  if (cluster > 1) {  // one query a block: warp 0 holds the block's list
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    if (warp == 0) publish(0);
    cl.sync();
    if (rank == 0 && warp == 0)
      for (int r = 1; r < cluster; ++r)
        fold(cl.map_shared_rank(list_v, r), cl.map_shared_rank(list_i, r));
    // no member leaves while the first block reads its shared memory
    cl.sync();
  }
  if (rank == 0 && j == 0 && qi < b)
    list.store(out_v + static_cast<size_t>(qi) * k,
               out_i + static_cast<size_t>(qi) * k, k, lane);
}

template <class S>
cudaError_t launch_scan(dim3 grid, cudaStream_t s, const float* q,
                        const float* db, float* part_v, int32_t* part_i,
                        int b, int n, int d, int k, int rows_per_range,
                        int n_ranges) {
  // the > 48 KB opt-in, once per variant and device
  static unsigned long long sized = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(sized & bit)) {
    err = cudaFuncSetAttribute(mips_scan_kernel<S::kM, S::kN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kSmemBytes);
    if (err != cudaSuccess) return err;
    sized |= bit;
  }
  grid.y = (b + S::kBQ - 1) / S::kBQ;
  mips_scan_kernel<S::kM, S::kN><<<grid, kScanThreads, S::kSmemBytes, s>>>(
      q, db, part_v, part_i, b, n, d, k, rows_per_range, n_ranges);
  return cudaGetLastError();
}

// The scan variants by (queries per block, rows per tile): 512-row tiles
// where they fill the card, 256-row tiles where they would leave SMs
// idle.
using ScanA = Scan<8, 16>;
using ScanB = Scan<4, 16>;
using ScanC = Scan<8, 4>;
using ScanD = Scan<4, 4>;

}  // namespace

// part_v / part_i: (b, n_ranges, k) scratch; out_v / out_i: (b, k).
// (query_tile, tile_rows) names a variant: (64, 512), (64, 256),
// (16, 512) or (16, 256); rows_per_range must be a multiple of
// tile_rows with n_ranges == ceil(n / rows_per_range).  q and db need
// only the 4-byte alignment of any fp32 tensor.
extern "C" int mips_topk_launch(const float* q, const float* db,
                                float* part_v, int32_t* part_i,
                                float* out_v, int32_t* out_i, int b, int n,
                                int d, int k, int query_tile, int tile_rows,
                                int rows_per_range, int n_ranges,
                                void* stream) {
  auto is = [&](auto variant) {
    using S = decltype(variant);
    return query_tile == S::kBQ && tile_rows == S::kRows;
  };
  const bool known = is(ScanA{}) || is(ScanB{}) || is(ScanC{}) || is(ScanD{});
  if (b <= 0 || n <= 0 || d <= 0 || k < 1 || k > kMaxK || k > n || !known ||
      rows_per_range <= 0 || rows_per_range % tile_rows != 0 ||
      n_ranges != (n + rows_per_range - 1) / rows_per_range) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_ranges);
  cudaError_t err;
  if (is(ScanA{}))
    err = launch_scan<ScanA>(grid, s, q, db, part_v, part_i, b, n, d, k,
                                rows_per_range, n_ranges);
  else if (is(ScanB{}))
    err = launch_scan<ScanB>(grid, s, q, db, part_v, part_i, b, n, d, k,
                                rows_per_range, n_ranges);
  else if (is(ScanC{}))
    err = launch_scan<ScanC>(grid, s, q, db, part_v, part_i, b, n, d, k,
                                rows_per_range, n_ranges);
  else
    err = launch_scan<ScanD>(grid, s, q, db, part_v, part_i, b, n, d, k,
                               rows_per_range, n_ranges);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 merge_grid((b + kWarps - 1) / kWarps);
  mips_merge_kernel<<<merge_grid, kThreads, 0, s>>>(
      part_v, part_i, out_v, out_i, b, n_ranges * k, k);
  return static_cast<int>(cudaGetLastError());
}

// q: (b, d) augmented queries; cand: (b, n_cand) row indices into db
// (n, d); out_v / out_i: (b, k).  The grid is rescore_grid's
// (kernels/common.py): queries_per_block x warps_per_query warps a
// block (at most kRescoreMaxWarps), cands_per_block candidates of each
// query a block, and a cluster of ceil(n_cand / cands_per_block) blocks
// a query (at most kMaxCluster; one query a block where it is above 1).
// One launch, no scratch; a cluster launch the card refuses returns its
// error.
extern "C" int mips_rescore_launch(const float* q, const float* db,
                                   const int32_t* cand, float* out_v,
                                   int32_t* out_i, int b, int n, int d,
                                   int n_cand, int k, int queries_per_block,
                                   int warps_per_query, int cands_per_block,
                                   int cluster, void* stream) {
  const long long warps =
      static_cast<long long>(queries_per_block) * warps_per_query;
  if (b <= 0 || n <= 0 || d <= 0 || n_cand < 1 || k < 1 || k > kMaxK ||
      k > n_cand || queries_per_block < 1 || warps_per_query < 1 ||
      warps > kRescoreMaxWarps || cands_per_block < 1 || cluster < 1 ||
      cluster > kMaxCluster ||
      cluster != (n_cand + cands_per_block - 1) / cands_per_block ||
      (cluster > 1 && queries_per_block != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the > 48 KB opt-in, once per device
  static unsigned long long sized = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(sized & bit)) {
    err = cudaFuncSetAttribute(mips_rescore_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRescoreMaxWarps * kRescoreWarpBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(
      static_cast<unsigned>((b + queries_per_block - 1) / queries_per_block) *
      cluster);
  cfg.blockDim = dim3(static_cast<unsigned>(32 * warps));
  cfg.dynamicSmemBytes = static_cast<size_t>(warps) * kRescoreWarpBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, mips_rescore_kernel, q, db, cand, out_v,
                           out_i, b, n, d, n_cand, k, queries_per_block,
                           warps_per_query, cands_per_block, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mips_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
