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
// What bounds it on the H100: it reads n*d*4 bytes once and writes
// n*ceil(k/32)*4, so at the main path's k = 12 it is memory-bound
// (2*n*d*k FLOP is ~3x below the fp32 non-tensor peak for the time the
// bytes take at 3.35 TB/s).  The (n, k) projection never leaves
// registers.
//
// Design: one thread per row, 128 rows per block.  The block streams
// its rows through shared memory in chunks of 32 features with
// coalesced loads (a warp reads 32 consecutive floats of one row), and
// the matching 32 x KP slice of its hyperplanes sits in shared memory
// beside it (read as broadcast float4s).  A block covers one group of
// at most 64 hyperplanes, picked by blockIdx.y: k > 64 launches
// ceil(k / 64) groups, each re-reading the rows, and k <= 64 is the one
// group at offset 0, so its codes are what they were before wider k.
// Each thread keeps KP fp32 accumulators (KP = 16, 32 or 64, the
// smallest that holds k, or 64 for k > 64) and sums its row's
// products in one fixed order, feature 0 to d-1, with fmaf: the code of
// a row never depends on n or on the block the row falls in.  Bits are
// packed in registers and one word per 32 hyperplanes is written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // rows per block, one per thread
constexpr int kDC = 32;        // features staged per chunk
constexpr int kMaxK = 512;     // 8 groups of 64 hyperplanes

// kGrouped: blockIdx.y picks a group of KP hyperplanes (k > 64 only);
// without it the group offset is the constant 0, so the kernel of
// k <= 64 compiles to the single-group code it always was.
template <int KP, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
lsh_hash_kernel(const float* __restrict__ v, const float* __restrict__ h,
                int32_t* __restrict__ out, int n, int d, int k,
                int n_words) {
  __shared__ float rows_s[kThreads][kDC + 1];
  __shared__ __align__(16) float h_s[kDC][KP];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kThreads;
  const int g0 = kGrouped ? blockIdx.y * KP : 0;  // group's first plane

  float acc[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) acc[j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kDC) {
    __syncthreads();
#pragma unroll 8
    for (int e = tid; e < kThreads * kDC; e += kThreads) {
      const int r = e / kDC, c = e % kDC;
      const int row = row0 + r, col = d0 + c;
      rows_s[r][c] = (row < n && col < d)
                         ? v[static_cast<size_t>(row) * d + col] : 0.f;
    }
    for (int e = tid; e < kDC * KP; e += kThreads) {
      const int c = e / KP, j = e % KP;
      const int col = d0 + c;
      h_s[c][j] = (col < d && g0 + j < k)
                      ? h[static_cast<size_t>(col) * k + g0 + j] : 0.f;
    }
    __syncthreads();
    // zero-padded features (col >= d) add fmaf(0, 0, acc) == acc
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const float x = rows_s[tid][c];
      const float4* hv = reinterpret_cast<const float4*>(&h_s[c][0]);
#pragma unroll
      for (int j4 = 0; j4 < KP / 4; ++j4) {
        const float4 w = hv[j4];
        acc[4 * j4 + 0] = fmaf(x, w.x, acc[4 * j4 + 0]);
        acc[4 * j4 + 1] = fmaf(x, w.y, acc[4 * j4 + 1]);
        acc[4 * j4 + 2] = fmaf(x, w.z, acc[4 * j4 + 2]);
        acc[4 * j4 + 3] = fmaf(x, w.w, acc[4 * j4 + 3]);
      }
    }
  }

  const int row = row0 + tid;
  if (row >= n) return;
  constexpr int kWords = (KP + 31) / 32;
  uint32_t words[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) words[w] = 0u;
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    if (g0 + j < k && acc[j] >= 0.f) words[j / 32] |= 1u << (j % 32);
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    if (g0 / 32 + w < n_words) {
      out[static_cast<size_t>(row) * n_words + g0 / 32 + w] =
          static_cast<int32_t>(words[w]);
    }
  }
}

}  // namespace

extern "C" int lsh_hash_launch(const float* v, const float* h,
                               int32_t* out, int n, int d, int k,
                               void* stream) {
  if (n <= 0 || d <= 0 || k < 1 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_words = (k + 31) / 32;
  const int row_tiles = (n + kThreads - 1) / kThreads;
  const dim3 grid(row_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 16) {
    lsh_hash_kernel<16, false><<<grid, kThreads, 0, s>>>(v, h, out, n, d,
                                                          k, n_words);
  } else if (k <= 32) {
    lsh_hash_kernel<32, false><<<grid, kThreads, 0, s>>>(v, h, out, n, d,
                                                          k, n_words);
  } else if (k <= 64) {
    lsh_hash_kernel<64, false><<<grid, kThreads, 0, s>>>(v, h, out, n, d,
                                                          k, n_words);
  } else {
    const dim3 groups(row_tiles, (k + 63) / 64);
    lsh_hash_kernel<64, true><<<groups, kThreads, 0, s>>>(v, h, out, n, d,
                                                           k, n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lsh_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
