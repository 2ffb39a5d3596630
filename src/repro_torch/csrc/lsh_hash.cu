// Packed hyperplane LSH codes: pack(sign(V @ H)) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lsh_hash/kernel.py :: lsh_hash_pallas
// (body _lsh_hash_kernel, pallas_call at kernel.py:77).
//
// Computes, for V (n, d) fp32 and H (d, k) fp32 with k <= 512, the codes
// (n, ceil(k/32)) of 32-bit words: bit j of word w is 1 iff
// V[r] . H[:, 32w + j] >= 0 (so a zero projection sets the bit), packed
// little-endian; bits at positions >= k are 0.
//
// The chain.  Each (row, plane) projection is one fmaf chain in one
// thread: it starts at 0.f and runs over features 0 .. d-1 in order; d
// is never split across threads and nothing past d enters the sum.  So a
// row's code depends on nothing but the row and the planes: not on n, on
// the row's place in the batch, on the grid or on how the planes are
// split (card test test_lsh_code_is_invariant).  Work is split by rows
// and planes only.
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s fp32 off the tensor
// cores): n*d*4 bytes read once, 2*n*d*k operations.  At d = 256 the
// two meet at k = 40: the main path's k = 12 is bound by bytes, k >= 64
// by operations.  Two more limits bound what reaches them:
//   * shared memory returns 128 bytes a clock to an SM, 32 lanes x 4
//     bytes, broadcast or not, and every FMA needs a row value and a
//     plane value from it: a thread holding one row and all planes reads
//     a plane value per FMA, which caps it at a quarter of the FMA rate;
//   * a warp that issues cp.async copies stalls once the memory system
//     is full, so copies and FMAs issued by the same warps run one after
//     the other (measured: their times added), and one warp issuing all
//     the copies moves about 1.1 TB/s.
// What the design does about each:
//   * Bytes.  Rows stream through a ring of `stages` buffers filled by
//     the Tensor Memory Accelerator (TMA): one thread of a producer warp
//     asks for boxes of 32 features x up to 256 rows, which land with
//     the 128-byte swizzle and complete on the buffer's mbarrier; the
//     consumer warps wait on that barrier, run the FMAs and release the
//     buffer.  No consumer issues a copy, so the FMAs of one buffer run
//     while the next ones are in flight.  Each row is read from device
//     memory once at every k (all plane groups of a tile share its
//     staged rows).  At large n the grid is persistent: one block a SM
//     walking a contiguous range of rows in tiles.
//   * Operations and shared memory.  A thread owns R rows (R = 1 .. 8) x
//     KP planes (KP = 8, or 12 for k <= 12): per feature it reads R + KP
//     values (float4s over 4 features) for R * KP FMAs.  The swizzle puts
//     the 16-byte pieces of 8 consecutive rows in 8 distinct bank groups,
//     so the row reads do not conflict.
//   * Parallelism at small n.  The planes split across threads
//     (plane_groups threads a row, KP each) and tiles shrink, so a batch of
//     64 queries still spreads over 64 blocks.
//   * The hyperplanes stream beside the rows: each buffer holds the
//     chunk's 32 features of every plane, asked for with the chunk's rows
//     (staging them whole once a block measured no faster; PERF.md).
//
// Where it stands (PERF.md has the figures): at 2^22 rows the ring
// streams at about 90 % of the byte bound with the FMAs hidden under it;
// at k >= 64 the FMAs and their shared-memory reads contend (R = KP = 8
// reads as many bytes as the FMAs can use); below a few hundred rows an
// SM, a fixed cost of launch, barriers and the first boxes' latency and
// one thread's 256-step chain per row take most of the time.
//
// The grid (KP, R, plane groups, row lanes, stages, rows a block) is
// chosen by shape in Python
// (kernels/common.py lsh_grid) and passed to the launcher, which checks
// it and returns the CUDA error of a refused launch.  One launch a call.
//
// Alignment: TMA needs a 16-byte-aligned base and rows of a multiple of
// 16 bytes.  Where V (d % 4 != 0, or a base such as v[1:]) or H (k % 4
// != 0) is not so, the producer warp copies it 4 bytes at a time with
// cp.async into the same layout; any 4-byte-aligned base is taken.  An
// input that TMA can take always goes through TMA: if its tensor map
// cannot be made, the launch is refused (cudaErrorNotSupported) rather
// than served by the 4-byte copies.
#include <cuda.h>  // CUtensorMap and its encoder's types
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 512;
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90
constexpr int kChunk = 32;        // features a stage: one 128-byte row piece
constexpr int kBoxRows = 256;     // rows of a TMA box, at most
constexpr int kBoxPlanes = 256;   // planes of a TMA box, at most
constexpr int kAlign = 1024;      // the 128-byte swizzle's atom
constexpr long long kWaitCycles = 20000000000LL;  // ~10 s, then trap

struct LshArgs {
  int32_t* out;
  const float* v;  // for the 4-byte copies
  const float* h;
  int n, d, k, n_words;
  int groups, lanes, stages, rows_per_block;
  int tma_rows, tma_planes;
};

// a block's threads (the producer warp included) for R rows x KP planes a
// thread: the R * KP accumulators, 4R row values and KP plane values stay
// in registers (at most 64 a thread at 1024 threads, 128 at 512, 200 at
// 320, 255 at 256: no spill)
__host__ __device__ constexpr int max_threads(int kp, int r) {
  return r * kp <= 8 ? 1024 : r * kp <= 32 ? 512 : r * kp <= 64 ? 320 : 256;
}

__host__ __device__ constexpr int align_up(int x) {
  return (x + kAlign - 1) / kAlign * kAlign;
}

// The block's shared memory, in bytes from a 1024-byte-aligned base:
// the mbarriers; `stages` buffers, each of a tile's rows (32 features,
// 128 bytes a row, swizzled) and the chunk's planes; the code words of a
// tile where several threads share a row.  Planes are held as boxes of
// up to 256 planes: plane p of feature f at (p / hbox) * 32 * hbox +
// f * hbox + p % hbox floats.
struct Layout {
  int tile, box_rows, row_boxes, hbox, plane_boxes;
  int ring, rows_bytes, stage_bytes, words, bytes;

  __host__ __device__ Layout(int k, int kp, int r, int groups, int lanes,
                             int stages) {
    tile = r * lanes;
    box_rows = tile < kBoxRows ? tile : kBoxRows;
    row_boxes = (tile + box_rows - 1) / box_rows;
    const int kpad = groups * kp;
    hbox = kpad < kBoxPlanes ? kpad : kBoxPlanes;
    plane_boxes = (kpad + hbox - 1) / hbox;
    ring = kAlign;  // after the mbarriers
    rows_bytes = align_up(row_boxes * box_rows * kChunk * 4);
    stage_bytes = rows_bytes + align_up(plane_boxes * kChunk * hbox * 4);
    words = ring + stages * stage_bytes;
    // the words, and the slack that aligns the base
    bytes = words + (groups > 1 ? tile * ((k + 31) / 32) * 4 : 0) + kAlign;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// an arrival on `bar` once every cp.async this thread issued so far has
// landed (the barrier's count includes it)
__device__ __forceinline__ void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that
// outlasts kWaitCycles traps (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// a box of a 2-D tensor map at coordinates (c0 inner, c1) into shared
// memory; its bytes complete on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the consumers' own barrier (the producer warp does not take part)
__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// The planes of features [f0, f0 + len) into the buffer's planes at
// `dst`, 4 bytes a copy: copies first, first + stride, ...
__device__ __forceinline__ void copy_planes(const LshArgs& a, const Layout& L,
                                            uint32_t dst, int f0, int len,
                                            int first, int stride) {
  for (int e = first; e < len * a.k; e += stride) {
    const int f = e / a.k, p = e - f * a.k;
    cp_async4(dst + 4 * ((p / L.hbox) * kChunk * L.hbox + f * L.hbox +
                         p % L.hbox),
              a.h + static_cast<size_t>(f0 + f) * a.k + p);
  }
}

// A block: `consumers` threads (plane_groups x row_lanes computing, the
// rest of their last warp idle) and one producer warp.  The producer
// fills the ring: step s stages features [32c, 32c + 32) of the block's
// tile t (s = t * n_chunks + c) into buffer s % stages, and the buffer's
// full barrier completes when the copies land; the consumers wait on it,
// run the FMAs, and arrive on the buffer's empty barrier, which the
// producer waits on before refilling it.
template <int KP, int R>
__global__ void __launch_bounds__(max_threads(KP, R), 1)
lsh_hash_kernel(const __grid_constant__ LshArgs a,
                const __grid_constant__ CUtensorMap tm_rows,
                const __grid_constant__ CUtensorMap tm_planes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int consumers = blockDim.x - 32;
  const Layout L(a.k, KP, R, a.groups, a.lanes, a.stages);
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base;              // full[s] at full + 8 s
  const uint32_t empty = base + 8 * kMaxStages;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + L.words);

  const int row_begin = blockIdx.x * a.rows_per_block;
  const int row_end = min(a.n, row_begin + a.rows_per_block);
  const int n_chunks = (a.d + kChunk - 1) / kChunk;
  const int n_steps =
      ((row_end - row_begin + L.tile - 1) / L.tile) * n_chunks;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + 8 * s, 33);  // the TMA arrival, 32 copy arrivals
      mbar_init(empty + 8 * s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // planes that TMA does not write (4-byte copies) read as 0 past k;
  // the code words start at 0
  if (!a.tma_planes) {
    const int pad = L.plane_boxes * L.hbox - a.k;
    for (int e = tid; e < a.stages * kChunk * pad; e += blockDim.x) {
      const int b = e / (kChunk * pad), x = e - b * kChunk * pad;
      const int f = x / pad, p = a.k + (x - f * pad);
      reinterpret_cast<float*>(smem + L.ring + b * L.stage_bytes +
                               L.rows_bytes)[(p / L.hbox) * kChunk * L.hbox +
                                             f * L.hbox + p % L.hbox] = 0.f;
    }
  }
  if (a.groups > 1)
    for (int e = tid; e < L.tile * a.n_words; e += blockDim.x) words[e] = 0u;
  __syncthreads();

  if (tid >= consumers) {
    // the producer warp: lane 0 asks for the TMA boxes; every lane takes
    // its share of the 4-byte copies where TMA cannot serve
    const int lane = tid - consumers;
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_rows))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_planes))
                   : "memory");
    }
    const uint32_t rows_tx =
        a.tma_rows ? L.row_boxes * L.box_rows * kChunk * 4 : 0;
    const uint32_t planes_tx =
        a.tma_planes ? L.plane_boxes * kChunk * L.hbox * 4 : 0;
    int t = 0, chunk = 0, buf = 0, round = 0;
    for (int s = 0; s < n_steps; ++s) {
      if (round > 0) mbar_wait(empty + 8 * buf, (round - 1) & 1);
      const int f0 = chunk * kChunk;
      const int t0 = row_begin + t * L.tile;
      const uint32_t st = base + L.ring + buf * L.stage_bytes;
      const uint32_t bar = full + 8 * buf;
      if (lane == 0) {
        mbar_expect_tx(bar, rows_tx + planes_tx);
        if (a.tma_rows)
          for (int b = 0; b < L.row_boxes; ++b)
            tma_load(st + b * L.box_rows * kChunk * 4, &tm_rows, bar, f0,
                     t0 + b * L.box_rows);
        if (planes_tx)
          for (int pb = 0; pb < L.plane_boxes; ++pb)
            tma_load(st + L.rows_bytes + pb * kChunk * L.hbox * 4,
                     &tm_planes, bar, pb * L.hbox, f0);
      }
      const int len = min(kChunk, a.d - f0);
      if (!a.tma_rows) {
        // row r's feature c at the swizzled place of its 16-byte piece
        const int rows = min(L.tile, row_end - t0);
        for (int e = lane; e < rows * kChunk; e += 32) {
          const int r = e / kChunk, c = e % kChunk;
          if (c < len)
            cp_async4(st + 4 * (r * kChunk + (((c >> 2) ^ (r & 7)) << 2) +
                                (c & 3)),
                      a.v + static_cast<size_t>(t0 + r) * a.d + f0 + c);
        }
      }
      if (!a.tma_planes)
        copy_planes(a, L, st + L.rows_bytes, f0, len, lane, 32);
      mbar_arrive_on_copies(bar);
      if (++chunk == n_chunks) chunk = 0, ++t;
      if (++buf == a.stages) buf = 0, ++round;
    }
    cp_async_wait_all();
    return;
  }

  const int g = tid / a.lanes;        // this thread's plane group
  const int rl = tid - g * a.lanes;   // and its row lane
  const bool active = g < a.groups;   // the last warp's spare threads idle
  // this thread's planes in their box of planes, features hbox apart
  const int p0 = g * KP;
  const int hoff = (p0 / L.hbox) * L.hbox * kChunk + p0 % L.hbox;
  int sw[R];  // the swizzle of each of the thread's rows
#pragma unroll
  for (int i = 0; i < R; ++i) sw[i] = (rl + i * a.lanes) & 7;
  float acc[R][KP];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < KP; ++j) acc[i][j] = 0.f;

  int t = 0, chunk = 0, buf = 0, round = 0;
  for (int s = 0; s < n_steps; ++s) {
    mbar_wait(full + 8 * buf, round & 1);
    const int f0 = chunk * kChunk;
    const int len = min(kChunk, a.d - f0);
    const float* st =
        reinterpret_cast<const float*>(smem + L.ring + buf * L.stage_bytes);
    const float* x0 = st + rl * kChunk;      // row i at x0 + i * xs
    const int xs = a.lanes * kChunk;
    const float* hs = st + L.rows_bytes / 4 + hoff;
    const int len4 = active ? len & ~3 : 0;
#pragma unroll 2
    for (int c = 0; c < len4; c += 4) {
      float4 x[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        x[i] = *reinterpret_cast<const float4*>(
            x0 + i * xs + (((c >> 2) ^ sw[i]) << 2));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float w[KP];
#pragma unroll
        for (int j4 = 0; j4 < KP / 4; ++j4) {
          const float4 q = *reinterpret_cast<const float4*>(
              hs + (c + e) * L.hbox + 4 * j4);
          w[4 * j4] = q.x;
          w[4 * j4 + 1] = q.y;
          w[4 * j4 + 2] = q.z;
          w[4 * j4 + 3] = q.w;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float xe = e == 0 ? x[i].x : e == 1 ? x[i].y
                         : e == 2 ? x[i].z : x[i].w;
#pragma unroll
          for (int j = 0; j < KP; ++j) acc[i][j] = fmaf(xe, w[j], acc[i][j]);
        }
      }
    }
    // the last chunk's features past a multiple of 4 (d % 4 != 0 only)
    for (int c = len4; c < (active ? len : 0); ++c) {
      float w[KP];
#pragma unroll
      for (int j = 0; j < KP; ++j) w[j] = hs[c * L.hbox + j];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float xe = x0[i * xs + (((c >> 2) ^ sw[i]) << 2) + (c & 3)];
#pragma unroll
        for (int j = 0; j < KP; ++j) acc[i][j] = fmaf(xe, w[j], acc[i][j]);
      }
    }
    mbar_arrive(empty + 8 * buf);  // this thread is done with the buffer

    const int tile_t = t;
    if (++buf == a.stages) buf = 0, ++round;
    if (++chunk < n_chunks) continue;
    chunk = 0;
    ++t;
    // the tile's codes: this thread's KP planes start at bit p0 % 32 of
    // word p0 / 32 and may run into the next word (KP = 12)
    const int t0 = row_begin + tile_t * L.tile;
    const int w0 = p0 >> 5, sh = p0 & 31;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      uint32_t bits = 0u;
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        if (p0 + j < a.k && acc[i][j] >= 0.f) bits |= 1u << j;
        acc[i][j] = 0.f;
      }
      const int r = rl + i * a.lanes;
      if (!active) continue;
      if (a.groups == 1) {  // one word a row, all of it this thread's
        if (t0 + r < row_end)
          a.out[static_cast<size_t>(t0 + r)] = static_cast<int32_t>(bits);
      } else {
        atomicOr(words + r * a.n_words + w0, bits << sh);
        if (sh + KP > 32)
          atomicOr(words + r * a.n_words + w0 + 1, bits >> (32 - sh));
      }
    }
    if (a.groups > 1) {
      consumers_sync(consumers);
      const int rows = min(L.tile, row_end - t0);
      for (int e = tid; e < L.tile * a.n_words; e += consumers) {
        if (e < rows * a.n_words)
          a.out[static_cast<size_t>(t0) * a.n_words + e] =
              static_cast<int32_t>(words[e]);
        words[e] = 0u;
      }
      consumers_sync(consumers);  // zeroed before the next tile's ORs
    }
  }
}

using Kernel = void (*)(const LshArgs, const CUtensorMap, const CUtensorMap);

// instantiations: KP 12 (k <= 12, one group) with R in {1, 2, 4}, and
// KP 8 with R in {1, 2, 4, 8}
constexpr int kKps[] = {8, 12};
constexpr int kRs[] = {1, 2, 4, 8};
const Kernel kKernels[2][4] = {
    {lsh_hash_kernel<8, 1>, lsh_hash_kernel<8, 2>, lsh_hash_kernel<8, 4>,
     lsh_hash_kernel<8, 8>},
    {lsh_hash_kernel<12, 1>, lsh_hash_kernel<12, 2>, lsh_hash_kernel<12, 4>,
     nullptr},
};
int configured_smem[2][4];  // dynamic shared memory each kernel allows

int index_of(const int* values, int count, int value) {
  for (int i = 0; i < count; ++i)
    if (values[i] == value) return i;
  return -1;
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

// A 2-D map of a contiguous (outer, inner) fp32 tensor in boxes of
// box_inner x box_outer; elements past its edges read 0.
bool tensor_map(CUtensorMap* map, const float* ptr, int inner, int outer,
                int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Shared memory of one block of the grid, in bytes (mirrored by
// kernels/common.py lsh_smem_bytes).
extern "C" int lsh_hash_smem_bytes(int k, int planes_per_thread,
                                   int rows_per_thread, int plane_groups,
                                   int row_lanes, int stages) {
  return Layout(k, planes_per_thread, rows_per_thread, plane_groups,
                row_lanes, stages)
      .bytes;
}

// One launch: the grid of kernels/common.py lsh_grid.  Returns the CUDA
// error of a refused launch (cudaErrorInvalidValue for a grid the kernel
// was not built for, cudaErrorNotSupported for an input TMA can take
// whose tensor map cannot be made), 0 on success.
extern "C" int lsh_hash_launch(const float* v, const float* h, int32_t* out,
                               int n, int d, int k, int planes_per_thread,
                               int rows_per_thread, int plane_groups,
                               int row_lanes, int stages, int rows_per_block,
                               void* stream) {
  const int ki = index_of(kKps, 2, planes_per_thread);
  const int ri = index_of(kRs, 4, rows_per_thread);
  const int tile = rows_per_thread * row_lanes;
  if (n <= 0 || d <= 0 || k < 1 || k > kMaxK || ki < 0 || ri < 0 ||
      plane_groups < 1 || plane_groups * planes_per_thread < k ||
      (plane_groups - 1) * planes_per_thread >= k || row_lanes < 1 ||
      plane_groups * row_lanes >
          max_threads(planes_per_thread, rows_per_thread) - 32 ||
      (tile > kBoxRows && tile % kBoxRows != 0) || stages < 2 ||
      stages > kMaxStages || rows_per_block < 1 ||
      kKernels[ki][ri] == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout layout(k, planes_per_thread, rows_per_thread, plane_groups,
                      row_lanes, stages);
  if (layout.bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = kKernels[ki][ri];
  if (layout.bytes > configured_smem[ki][ri]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, layout.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured_smem[ki][ri] = layout.bytes;
  }
  LshArgs a;
  a.out = out;
  a.v = v;
  a.h = h;
  a.n = n;
  a.d = d;
  a.k = k;
  a.n_words = (k + 31) / 32;
  a.groups = plane_groups;
  a.lanes = row_lanes;
  a.stages = stages;
  a.rows_per_block = rows_per_block;
  // TMA wherever it can serve (a 16-byte-aligned base, rows a multiple of
  // 16 bytes); a map that cannot be made there refuses the launch
  CUtensorMap tm_rows = {}, tm_planes = {};
  a.tma_rows = reinterpret_cast<uintptr_t>(v) % 16 == 0 && d % 4 == 0;
  a.tma_planes = reinterpret_cast<uintptr_t>(h) % 16 == 0 && k % 4 == 0;
  if ((a.tma_rows && !tensor_map(&tm_rows, v, d, n, kChunk, layout.box_rows,
                                 CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (a.tma_planes && !tensor_map(&tm_planes, h, k, d, layout.hbox, kChunk,
                                   CU_TENSOR_MAP_SWIZZLE_NONE)))
    return static_cast<int>(cudaErrorNotSupported);
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  // the consumers in whole warps, and the producer warp
  const int threads = (plane_groups * row_lanes + 31) / 32 * 32 + 32;
  kernel<<<blocks, threads, static_cast<size_t>(layout.bytes),
           static_cast<cudaStream_t>(stream)>>>(a, tm_rows, tm_planes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lsh_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
