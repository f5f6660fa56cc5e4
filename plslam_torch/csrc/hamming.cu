// Packed-bit Hamming distance matrix on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel `_hamming_kernel` / `hamming_matrix_pallas` of
// plslam/ops/kernels/hamming.py and computes what it computes:
//   out[i, j] = sum_w popcount(d1[i, w] ^ d2[j, w]),  w < 8,
// for 256-bit descriptors packed into 8 32-bit words ([N1,8] x [N2,8] ->
// [N1,N2] int32). The words arrive as int32 tensors that carry the uint32 bit
// patterns; the kernel reads them as uint32.
//
// Design. popcount(a ^ b) = popcount(a) + popcount(b) - 2 popcount(a & b),
// exactly, in integers. A 256-bit descriptor is one k256 row of the 1-bit
// tensor-core product `mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32
// .and.popc`, so one instruction gives popcount(a & b) over all 256 bits for
// a 16x8 block of pairs; each descriptor's own popcount is taken once a warp
// that uses it (8 __popc, where a CUDA-core kernel takes 8 for each pair).
//   - One CTA of 4 warps computes a 32x32 output tile; each warp 16 rows x
//     16 columns, as 2 MMAs on one A fragment. grid.x walks the tiles of d2
//     (the longer side in the loop-closure search, 128 x 256), grid.y those
//     of d1 (at most 65535 x 32 descriptors). The line matcher's 64x64 is
//     4 CTAs, 128x256 is 32, 1000x1000 is 1024.
//   - Every warp loads its fragments straight from global memory, one word
//     a load (any 4-B aligned view works: a contiguous int32 view may start
//     at any word), rows and columns past the matrix read as zero. The
//     popcounts are summed over the 4 lanes that hold a descriptor's words
//     by warp shuffles. Nothing is staged in shared memory and no barrier is
//     taken: at the callers' shapes the time is one chain of latencies, and
//     on an H100 a version that staged the descriptors by cp.async (two
//     barriers) took 0.3 us more a launch at 64x64 and 128x256 (1.60-1.83
//     against 1.31-1.37 us; PERF.md, `scripts/hamming_time.py`).
//   - Fragments (PTX ISA, mma m16n8k256 .b1): lane (g = lane/4, t = lane%4)
//     holds a0..a3 = A[g][t], A[g+8][t], A[g][4+t], A[g+8][4+t] (word t of
//     a row is bits 32t..32t+31), b0, b1 = B[g][t], B[g][4+t] (descriptor g
//     of the 8-column block, `.col`), and the sums c0..c3 = rows g, g, g+8,
//     g+8 and columns 2t, 2t+1, 2t, 2t+1.
//   - Epilogue: H = pa[r] + pb[c] - 2 acc, stored from the fragments:
//     each lane writes columns 2t, 2t+1 of rows g and g+8 of each 8-column
//     block, as one 8-B store where N2 is even and the output 8-B aligned
//     (a warp's store then fills whole 32-B sectors), as two 4-B stores
//     otherwise. On an H100 the 8-B stores took 0.06-0.2 us less a launch
//     at the callers' shapes and 1.6 us less at 1000x1000 (2.65 against
//     4.25 us). Out-of-range rows and columns are not written, so no padded
//     copy is made and nothing is sliced. TMA does not fit the store: a row
//     pitch of 4 N2 bytes is not a multiple of 16 in general.
//   - Why mma.sync and not wgmma: a 32x32 tile is 2 MMAs a warp. At these
//     shapes the kernel is bound by its launch and its output stores, not by
//     the rate of MMA instructions; wgmma's shared-memory descriptors,
//     fences and commit/wait would buy nothing.
//
// What bounds it (`chip_smoke.py`'s `hamming_bound`: inputs read once, the
// int32 output written once at 3.35 TB/s; 2 x 256 operations an output at the
// H100 SXM's dense INT8 tensor-core rate, 1,979 T/s, since the data sheet
// gives no 1-bit rate): the bytes, at every shape — 64x64 ~20 KB (6 ns),
// 128x256 ~140 KB (0.04 us), 1000x1000 ~4.06 MB (1.21 us). At 64x64 and
// 128x256 the launch's fixed cost and one chain of dependent latencies
// (loads, shuffles and MMA, stores) set the time, 1.31-1.37 us on an H100;
// at 1000x1000 the 4 MB of output stores add theirs, 2.65 us in all.
// ptxas (sm_90a): 34 registers, no shared memory, no barrier, no spills.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 8;                     // 256 bits a descriptor
constexpr int TILE_M = 32, TILE_N = 32;      // output tile a CTA: rows of d1 x columns of d2
constexpr int WARPS_M = 2, WARPS_N = 2;      // warps a CTA, each 16 rows x WARP_N columns
constexpr int WARP_N = TILE_N / WARPS_N;
constexpr int NB = WARP_N / 8;               // 8-column blocks a warp
constexpr int THREADS = WARPS_M * WARPS_N * 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(TILE_M == 16 * WARPS_M && WARP_N % 8 == 0, "a warp computes 16 rows x WARP_N columns");

// Word w of descriptor i of d (n of them); 0 past the end.
__device__ __forceinline__ uint32_t word(const uint32_t* d, int i, int n, int w) {
  return i < n ? __ldg(d + static_cast<size_t>(i) * WORDS + w) : 0u;
}

// The sum of v over the 4 lanes of a quad (lanes 4g .. 4g + 3).
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

__global__ void __launch_bounds__(THREADS)
hamming_kernel(const uint32_t* __restrict__ d1, const uint32_t* __restrict__ d2,
               int32_t* __restrict__ out, int n1, int n2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = blockIdx.y * TILE_M + (warp % WARPS_M) * 16 + g;     // rows r, r + 8
  const int c0 = blockIdx.x * TILE_N + (warp / WARPS_M) * WARP_N;    // the warp's first column

  const uint32_t a0 = word(d1, r, n1, t), a1 = word(d1, r + 8, n1, t);
  const uint32_t a2 = word(d1, r, n1, 4 + t), a3 = word(d1, r + 8, n1, 4 + t);
  uint32_t b[NB][2];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    b[j][0] = word(d2, c0 + 8 * j + g, n2, t);
    b[j][1] = word(d2, c0 + 8 * j + g, n2, 4 + t);
  }

  const int zero = 0;
  int acc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=r"(acc[j][0]), "=r"(acc[j][1]), "=r"(acc[j][2]), "=r"(acc[j][3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b[j][0]), "r"(b[j][1]), "r"(zero));

  // popcounts: rows r and r + 8 (every lane of quad g holds them), and
  // columns 2t, 2t + 1 of each block (held by quads 2t and 2t + 1)
  const int pa[2] = {quad_sum(__popc(a0) + __popc(a2)), quad_sum(__popc(a1) + __popc(a3))};
  int pb[NB][2];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int p = quad_sum(__popc(b[j][0]) + __popc(b[j][1]));  // column g of block j
    pb[j][0] = __shfl_sync(FULL, p, 8 * t);
    pb[j][1] = __shfl_sync(FULL, p, 8 * t + 4);
  }

  const bool pairs = (n2 & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= n1) continue;
    int32_t* orow = out + static_cast<size_t>(row) * n2;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      const int v0 = pa[h] + pb[j][0] - 2 * acc[j][2 * h];
      const int v1 = pa[h] + pb[j][1] - 2 * acc[j][2 * h + 1];
      if (pairs) {
        if (c < n2) *reinterpret_cast<int2*>(orow + c) = make_int2(v0, v1);
      } else {
        if (c < n2) orow[c] = v0;
        if (c + 1 < n2) orow[c + 1] = v1;
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). d1 [n1,8], d2 [n2,8] and out
// [n1,n2] are device pointers to contiguous 32-bit words (any 4-B alignment);
// n1 <= 65535 * TILE_M; `stream` is a cudaStream_t. Returns cudaGetLastError().
extern "C" int plslam_hamming_u32x8(const void* d1, const void* d2, void* out, int n1, int n2,
                                    void* stream) {
  if (n1 > 0 && n2 > 0) {
    const dim3 grid((n2 + TILE_N - 1) / TILE_N, (n1 + TILE_M - 1) / TILE_M);
    hamming_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(d1), static_cast<const uint32_t*>(d2),
        static_cast<int32_t*>(out), n1, n2);
  }
  return static_cast<int>(cudaGetLastError());
}
