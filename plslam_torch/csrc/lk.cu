// Inverse-compositional Lucas-Kanade, one pyramid level, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_lk_kernel` / `lk_level_pallas` of
// plslam/ops/kernels/lk.py and computes exactly what it computes, per feature:
//   * a 23x23 bilinear template at the previous point (top-left p - HALF - 1),
//     central-difference gradients Tx/Ty over the inner 21x21, the 2x2
//     Gauss-Newton Hessian; det <= 1e-6 gives err = 1e9;
//   * `iters` inverse-compositional updates of the subpixel guess;
//   * err = mean |I - T| over the final 21x21 patch.
// Border semantics follow the Pallas kernel: the image is edge-padded to
// (ceil8(H), ceil128(W)); the patch's integer top-left is clamped to
// [0, Hp-(s+1)] x [0, Wp-(s+1)] with the UNclamped fraction kept, and every
// read replicates the edge (index clamped to [0,H-1] x [0,W-1]). Bilinear
// weights are computed by hand in fp32: texture units interpolate with 8-bit
// fractions and would not match.
//
// Design: one warp per feature, WARPS features per block. Each lane owns
// the patch points p = lane + 32k (k < 14) and keeps their T, Tx, Ty in
// registers; the template goes through shared memory once. Each iteration
// the lanes sample their points from global memory (a level is at most
// 1.4 MB and stays in L2) and the partial sums b0/b1 are all-reduced with
// __shfl_xor_sync, so every lane computes the same update.
//
// What bounds it: the latency of dependent loads over `iters` sequential
// iterations, not FLOPs or bandwidth — at 150 features there are ~150 warps,
// under one wave on 132 SMs. One launch per pyramid level, as with
// lk_level_pallas; fusing the levels into one launch is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 21;
constexpr int HALF = WIN / 2;
constexpr int TS = WIN + 2;                 // template side (gradient ring)
constexpr int NPTS = WIN * WIN;             // 441
constexpr int PER_LANE = (NPTS + 31) / 32;  // 14
constexpr int WARPS = 4;

struct Patch {
  int iy, ix;     // clamped integer top-left
  float fy, fx;   // fractional part of the unclamped top-left
};

__device__ __forceinline__ Patch patch_at(float y0f, float x0f, int s, int Hp, int Wp) {
  float iy = floorf(y0f), ix = floorf(x0f);
  Patch p;
  p.fy = y0f - iy;
  p.fx = x0f - ix;
  int iyi = (int)iy, ixi = (int)ix;
  p.iy = min(max(iyi, 0), Hp - (s + 1));
  p.ix = min(max(ixi, 0), Wp - (s + 1));
  return p;
}

__device__ __forceinline__ float pix(const float* __restrict__ img, int H, int W, int y, int x) {
  y = min(y, H - 1);
  x = min(x, W - 1);
  return __ldg(img + (size_t)y * W + x);
}

// bilinear sample of patch point (r, c), the same 4-term sum as the Pallas
// kernel: w00*I00 + w01*I01 + w10*I10 + w11*I11
__device__ __forceinline__ float sample(const float* __restrict__ img, int H, int W,
                                        const Patch& p, int r, int c) {
  float w00 = (1.0f - p.fy) * (1.0f - p.fx);
  float w01 = (1.0f - p.fy) * p.fx;
  float w10 = p.fy * (1.0f - p.fx);
  float w11 = p.fy * p.fx;
  int y = p.iy + r, x = p.ix + c;
  return w00 * pix(img, H, W, y, x) + w01 * pix(img, H, W, y, x + 1)
       + w10 * pix(img, H, W, y + 1, x) + w11 * pix(img, H, W, y + 1, x + 1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * WARPS)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                int H, int W, int Hp, int Wp,
                const float* __restrict__ pts, const float* __restrict__ guess,
                float* __restrict__ out, float* __restrict__ err, int n, int iters) {
  __shared__ float tmpl[WARPS][TS * TS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + warp;
  if (i >= n) return;  // whole warp exits together

  const float cx = pts[2 * i], cy = pts[2 * i + 1];
  float* T23 = tmpl[warp];
  const Patch pt = patch_at(cy - HALF - 1.0f, cx - HALF - 1.0f, TS, Hp, Wp);
  for (int k = lane; k < TS * TS; k += 32) T23[k] = sample(prev, H, W, pt, k / TS, k % TS);
  __syncwarp();

  float T[PER_LANE], Tx[PER_LANE], Ty[PER_LANE];
  float h00 = 0.f, h01 = 0.f, h11 = 0.f;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int q = lane + 32 * k;
    T[k] = Tx[k] = Ty[k] = 0.f;
    if (q < NPTS) {
      const int r = q / WIN + 1, c = q % WIN + 1;
      T[k] = T23[r * TS + c];
      Tx[k] = 0.5f * (T23[r * TS + c + 1] - T23[r * TS + c - 1]);
      Ty[k] = 0.5f * (T23[(r + 1) * TS + c] - T23[(r - 1) * TS + c]);
      h00 += Tx[k] * Tx[k];
      h01 += Tx[k] * Ty[k];
      h11 += Ty[k] * Ty[k];
    }
  }
  const float H00 = warp_sum(h00), H01 = warp_sum(h01), H11 = warp_sum(h11);
  const float det = H00 * H11 - H01 * H01;
  const bool ok = det > 1e-6f;
  const float det_safe = ok ? det : 1.0f;

  float gx = guess[2 * i], gy = guess[2 * i + 1];
  for (int it = 0; it < iters; ++it) {
    const Patch pc = patch_at(gy - HALF, gx - HALF, WIN, Hp, Wp);
    float b0 = 0.f, b1 = 0.f;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int q = lane + 32 * k;
      if (q < NPTS) {
        const float e = sample(cur, H, W, pc, q / WIN, q % WIN) - T[k];
        b0 += e * Tx[k];
        b1 += e * Ty[k];
      }
    }
    b0 = warp_sum(b0);
    b1 = warp_sum(b1);
    const float du = (H11 * b0 - H01 * b1) / det_safe;
    const float dv = (-H01 * b0 + H00 * b1) / det_safe;
    gx = gx - du;
    gy = gy - dv;
  }

  const Patch pf = patch_at(gy - HALF, gx - HALF, WIN, Hp, Wp);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int q = lane + 32 * k;
    if (q < NPTS) s += fabsf(sample(cur, H, W, pf, q / WIN, q % WIN) - T[k]);
  }
  s = warp_sum(s);
  if (lane == 0) {
    out[2 * i] = gx;
    out[2 * i + 1] = gy;
    err[i] = ok ? s / (float)NPTS : 1e9f;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device pointers
// to contiguous float32; `stream` is a cudaStream_t. Returns cudaGetLastError().
extern "C" int plslam_lk_level_f32(const float* prev, const float* cur, int H, int W,
                                   const float* pts, const float* guess, float* out, float* err,
                                   int n, int iters, void* stream) {
  if (n > 0) {
    const int Hp = (H + 7) / 8 * 8;
    const int Wp = (W + 127) / 128 * 128;
    const int blocks = (n + WARPS - 1) / WARPS;
    lk_level_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        prev, cur, H, W, Hp, Wp, pts, guess, out, err, n, iters);
  }
  return (int)cudaGetLastError();
}
