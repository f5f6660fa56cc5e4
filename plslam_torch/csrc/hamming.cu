// Packed-bit Hamming distance matrix, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_hamming_kernel` / `hamming_matrix_pallas` of
// plslam/ops/kernels/hamming.py and computes what it computes:
//   out[i, j] = sum_w popcount(d1[i, w] ^ d2[j, w]),  w < 8,
// for 256-bit descriptors packed into 8 32-bit words ([N1,8] x [N2,8] ->
// [N1,N2] int32). The words arrive as int32 tensors that carry the uint32 bit
// patterns; the kernel reads them as uint32.
//
// Design: one block per 32x32 output tile, 32x8 threads, 4 outputs per
// thread. The tile's 32 row and 32 column descriptors (8 words each) are
// staged in shared memory, one word per thread; each thread keeps its
// column's 8 words in registers and walks 4 rows. The ragged edges are
// masked in the kernel (zero words are staged, out-of-range outputs are not
// written), so no padded copy is made — where the Pallas wrapper pads to 128
// and slices. Rows are padded to 9 words in shared memory so that the 32
// column reads of a warp fall in 32 different banks.
//
// What bounds it: on the line matcher's path N1 = N2 = 64, so a call moves
// 2 x 64 x 32 B in and 64 x 64 x 4 B out, about 20 KB, and does 32 K
// popcounts: launch latency bounds it, not bytes or operations. At a
// loop-closure size (1000 x 1000) the popcounts bound it: __popc issues 16
// results per clock per SM on sm_90, so 8 M of them take about 1.9 us on an
// H100 SXM, above the about 1.2 us of the 4 MB of output writes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 8;
constexpr int TILE = 32;
constexpr int TY = 8;  // thread rows; each thread computes TILE / TY outputs

__global__ void __launch_bounds__(TILE * TY)
hamming_kernel(const uint32_t* __restrict__ d1, const uint32_t* __restrict__ d2,
               int32_t* __restrict__ out, int n1, int n2) {
  __shared__ uint32_t a[TILE][WORDS + 1];
  __shared__ uint32_t b[TILE][WORDS + 1];
  const int r0 = blockIdx.y * TILE;
  const int c0 = blockIdx.x * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;  // 0 .. 255 = TILE * WORDS - 1
  {
    const int row = tid / WORDS, w = tid % WORDS;
    a[row][w] = (r0 + row < n1) ? __ldg(d1 + (size_t)(r0 + row) * WORDS + w) : 0u;
    b[row][w] = (c0 + row < n2) ? __ldg(d2 + (size_t)(c0 + row) * WORDS + w) : 0u;
  }
  __syncthreads();

  const int col = c0 + threadIdx.x;
  uint32_t bw[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) bw[w] = b[threadIdx.x][w];
#pragma unroll
  for (int i = 0; i < TILE / TY; ++i) {
    const int r = threadIdx.y + i * TY;
    int s = 0;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) s += __popc(a[r][w] ^ bw[w]);
    if (r0 + r < n1 && col < n2) out[(size_t)(r0 + r) * n2 + col] = s;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). d1 [n1,8], d2 [n2,8] and out
// [n1,n2] are device pointers to contiguous 32-bit words; `stream` is a
// cudaStream_t. Returns cudaGetLastError().
extern "C" int plslam_hamming_u32x8(const void* d1, const void* d2, void* out, int n1, int n2,
                                    void* stream) {
  if (n1 > 0 && n2 > 0) {
    const dim3 block(TILE, TY);
    const dim3 grid((n2 + TILE - 1) / TILE, (n1 + TILE - 1) / TILE);
    hamming_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(d1), static_cast<const uint32_t*>(d2),
        static_cast<int32_t*>(out), n1, n2);
  }
  return (int)cudaGetLastError();
}
