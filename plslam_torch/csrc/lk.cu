// Pyramidal inverse-compositional Lucas-Kanade, a whole track in one launch,
// for Hopper (sm_90a).
//
// One kernel, templated on the formulation, tracks every feature through all
// pyramid levels, coarse to fine; nothing runs on the host between levels.
//   * FAST (the main path's) computes the JAX package's default tracker
//     `lk_track_fast` (plslam/models/frontend_points.py). Per level: a 23x23
//     bilinear template from the 24x24 window at p0 - 11 (top-left clipped
//     to the level, fraction kept), a 30x30 search window at
//     floor(g - 10) - LK_MARGIN (clipped to the level), `iters`
//     Gauss-Newton steps with the guess clamped to [c_tl + 10, c_tl + 18],
//     err = mean |I - T| at the clamped result; the det gate is ANDed over
//     the levels. The JAX function blends through one-hot selection matmuls
//     (for the TPU's matrix unit); here the same 4-tap bilinear blend is
//     read straight from the staged windows.
//   * PALLAS computes the TPU kernel `_lk_kernel` / `lk_level_pallas`
//     (plslam/ops/kernels/lk.py), driven over the levels as
//     `lk_track_pallas` drives it: the guess is unbounded, a patch's integer
//     top-left is clamped inside the (8,128)-padded level with the unclamped
//     fraction kept, reads replicate the edge, and det <= 1e-6 at the last
//     level gives err = 1e9.
// Both: central-difference Tx/Ty over the template's inner 21x21, the 2x2
// Gauss-Newton Hessian, status = valid & in-bounds (HALF) & err < thresh
// (& every level's det gate for FAST). Bilinear weights are computed by hand
// in fp32: texture units interpolate with 8-bit fractions and would not match.
//
// What bounds it: not bytes or FLOPs (a 4-level track of 150 features reads
// ~1.3 MB and does ~40 M operations: well under a microsecond of the card's
// peaks) but the latency of `iters` dependent Gauss-Newton steps per level,
// each a sample, a reduction and an update. The design shortens that chain:
//   * one launch per track instead of one per level (and no host ops between);
//   * FAST stages both of a level's windows (24x24 + 30x30 floats, 5.9 KB a
//     feature) into shared memory once, with coalesced row loads, so no
//     global load happens inside the iteration loop (TMA does not fit: the
//     windows start at any pixel, and a coarse level's row pitch, e.g. 94
//     floats, is not a multiple of 16 bytes). PALLAS cannot: its guess is
//     unbounded, so it keeps sampling the level from global memory (L2);
//   * one CTA of 4 warps per feature: each thread owns ceil(441 / 128) = 4
//     patch points with their T, Tx, Ty in registers; the partial sums are
//     reduced with __shfl_xor_sync and, across the warps, through a
//     double-buffered shared array (one __syncthreads per reduction). Every
//     thread ends with the same bits, so every thread carries the same
//     guess. 150 features are then 600 warps on 132 SMs, not 150 warps of
//     14 patch points a thread.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_LEVELS = 4;

// Per-level device pointers and shapes of the two pyramids (level 0 is the
// full image); passed to the kernel by value.
struct LkPyramid {
  const float* prev[MAX_LEVELS];
  const float* cur[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int levels;
};

namespace {

constexpr int WIN = 21;
constexpr int HALF = WIN / 2;
constexpr int TS = WIN + 2;                  // template side (gradient ring)
constexpr int NPTS = WIN * WIN;              // 441
constexpr int LK_MARGIN = 4;
constexpr int S_T = WIN + 3;                 // FAST template window (24)
constexpr int S_C = WIN + 2 * LK_MARGIN + 1; // FAST search window (30)
constexpr int WARPS = 4;                     // warps per feature
constexpr int NT = 32 * WARPS;               // threads per feature
constexpr int THREADS = 128;                 // threads per block
constexpr int FPB = THREADS / NT;            // features per block (1)
constexpr int PER = (NPTS + NT - 1) / NT;    // patch points per thread (4)
constexpr int FAST = 0, PALLAS = 1;

struct Patch {
  int iy, ix;     // clamped integer top-left
  float fy, fx;   // fractional part of the unclamped top-left
};

__device__ __forceinline__ Patch patch_at(float y0f, float x0f, int s, int Hp, int Wp) {
  float iy = floorf(y0f), ix = floorf(x0f);
  Patch p;
  p.fy = y0f - iy;
  p.fx = x0f - ix;
  p.iy = min(max((int)iy, 0), Hp - (s + 1));
  p.ix = min(max((int)ix, 0), Wp - (s + 1));
  return p;
}

__device__ __forceinline__ float pix(const float* __restrict__ img, int H, int W, int y, int x) {
  y = min(y, H - 1);
  x = min(x, W - 1);
  return __ldg(img + (size_t)y * W + x);
}

// PALLAS: bilinear sample of patch point (r, c) from the level in global
// memory, the same 4-term sum as the Pallas kernel
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

// FAST: the bilinear weights at a fractional offset, and a sample of a
// staged window of row pitch P at element offset o
struct Taps {
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Taps taps(float fy, float fx) {
  return {(1.0f - fy) * (1.0f - fx), (1.0f - fy) * fx, fy * (1.0f - fx), fy * fx};
}

template <int P>
__device__ __forceinline__ float blend(const float* w, int o, const Taps& t) {
  return t.w00 * w[o] + t.w01 * w[o + 1] + t.w10 * w[o + P] + t.w11 * w[o + P + 1];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum K values over the feature's NT threads; every thread gets the same
// bits (the xor butterfly is symmetric; the warps' partials are added in one
// order). `red` alternates between two buffers, so one barrier suffices.
template <int K>
__device__ __forceinline__ void feature_sum(float (&v)[K], float (*red)[WARPS][3], int& parity, int t) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if ((t & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[parity][t >> 5][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) s += red[parity][j][k];
    v[k] = s;
  }
  parity ^= 1;
}

// The feature index is per thread (fl) and bounds-checked although a block
// holds one feature: written as i = blockIdx.x, the same kernel took 20 %
// (FAST) and 33 % (PALLAS) longer on the card, with fewer registers and
// another schedule from ptxas (PERF.md).
template <int F>
__global__ void __launch_bounds__(THREADS)
lk_track_kernel(LkPyramid pyr, const float* __restrict__ pts, const uint8_t* __restrict__ valid,
                float* __restrict__ out, uint8_t* __restrict__ status, float* __restrict__ err_out,
                int n, int iters, float err_thresh) {
  constexpr int TW = F == FAST ? S_T * S_T : 1;
  constexpr int CW = F == FAST ? S_C * S_C : 1;
  __shared__ float s_tw[FPB][TW];             // FAST: template window
  __shared__ float s_cw[FPB][CW];             // FAST: search window
  __shared__ float s_t23[FPB][TS * TS];       // the 23x23 template
  __shared__ float s_red[FPB][2][WARPS][3];
  const int fl = threadIdx.x / NT;
  const int t = threadIdx.x % NT;
  const int i = blockIdx.x * FPB + fl;
  if (i >= n) return;
  float* tw = s_tw[fl];
  float* cw = s_cw[fl];
  float* t23 = s_t23[fl];

  int qr[PER], qc[PER];  // this thread's patch points (row, col); qr < 0 past the patch
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int q = t + NT * k;
    qr[k] = q < NPTS ? q / WIN : -1;
    qc[k] = q < NPTS ? q % WIN : 0;
  }

  const float px = pts[2 * i], py = pts[2 * i + 1];
  float gx = px, gy = py;  // the guess in level-0 pixels
  float err = 0.f;
  bool ok_all = true;
  int parity = 0;
  for (int level = pyr.levels - 1; level >= 0; --level) {
    const float scale = (float)(1 << level);
    const int H = pyr.h[level], W = pyr.w[level];
    const float* __restrict__ prev = pyr.prev[level];
    const float* __restrict__ cur = pyr.cur[level];
    const float p0x = px / scale, p0y = py / scale;
    float lx = gx / scale, ly = gy / scale;  // the level's guess
    const int Hp = (H + 7) / 8 * 8, Wp = (W + 127) / 128 * 128;
    int cx = 0, cy = 0;
    __syncthreads();  // the previous level's reads of the windows are done

    // ---- the 23x23 template ----
    if constexpr (F == FAST) {
      const float tfx = p0x - (HALF + 1), tfy = p0y - (HALF + 1);
      const float tix = floorf(tfx), tiy = floorf(tfy);
      const Taps tt = taps(tfy - tiy, tfx - tix);
      const int tlx = min(max((int)tix, 0), W - S_T), tly = min(max((int)tiy, 0), H - S_T);
      cx = min(max((int)floorf(lx - HALF) - LK_MARGIN, 0), W - S_C);
      cy = min(max((int)floorf(ly - HALF) - LK_MARGIN, 0), H - S_C);
      for (int k = t; k < S_T * S_T; k += NT)
        tw[k] = __ldg(prev + (size_t)(tly + k / S_T) * W + tlx + k % S_T);
      for (int k = t; k < S_C * S_C; k += NT)
        cw[k] = __ldg(cur + (size_t)(cy + k / S_C) * W + cx + k % S_C);
      __syncthreads();
      for (int k = t; k < TS * TS; k += NT) t23[k] = blend<S_T>(tw, (k / TS) * S_T + k % TS, tt);
    } else {
      const Patch pt = patch_at(p0y - HALF - 1.0f, p0x - HALF - 1.0f, TS, Hp, Wp);
      for (int k = t; k < TS * TS; k += NT) t23[k] = sample(prev, H, W, pt, k / TS, k % TS);
    }
    __syncthreads();

    // ---- T, Tx, Ty in registers; the Hessian ----
    float T[PER], Tx[PER], Ty[PER];
    float hs[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      T[k] = Tx[k] = Ty[k] = 0.f;
      if (qr[k] >= 0) {
        const int o = (qr[k] + 1) * TS + qc[k] + 1;
        T[k] = t23[o];
        Tx[k] = 0.5f * (t23[o + 1] - t23[o - 1]);
        Ty[k] = 0.5f * (t23[o + TS] - t23[o - TS]);
        hs[0] += Tx[k] * Tx[k];
        hs[1] += Tx[k] * Ty[k];
        hs[2] += Ty[k] * Ty[k];
      }
    }
    feature_sum(hs, s_red[fl], parity, t);
    const float H00 = hs[0], H01 = hs[1], H11 = hs[2];
    const float det = H00 * H11 - H01 * H01;
    const bool ok = det > 1e-6f;
    // one reciprocal a level instead of two IEEE divisions (a slow
    // subroutine) on every step's critical path
    const float inv_det = 1.0f / (ok ? det : 1.0f);

    // ---- Gauss-Newton steps, then the residual ----
    float s[1] = {0.f};
    if constexpr (F == FAST) {
      const float cxf = (float)cx, cyf = (float)cy;
      const float lox = cxf + HALF, hix = cxf + (S_C - 2 - HALF);
      const float loy = cyf + HALF, hiy = cyf + (S_C - 2 - HALF);
      for (int it = 0; it < iters; ++it) {
        const float gcx = fminf(fmaxf(lx, lox), hix), gcy = fminf(fmaxf(ly, loy), hiy);
        const float ax = gcx - HALF - cxf, ay = gcy - HALF - cyf;
        const float iax = floorf(ax), iay = floorf(ay);
        const Taps tc = taps(ay - iay, ax - iax);
        const int base = (int)iay * S_C + (int)iax;
        float b[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          if (qr[k] >= 0) {
            const float e = blend<S_C>(cw, base + qr[k] * S_C + qc[k], tc) - T[k];
            b[0] += e * Tx[k];
            b[1] += e * Ty[k];
          }
        }
        feature_sum(b, s_red[fl], parity, t);
        lx = gcx - (H11 * b[0] - H01 * b[1]) * inv_det;
        ly = gcy - (-H01 * b[0] + H00 * b[1]) * inv_det;
      }
      lx = fminf(fmaxf(lx, lox), hix);
      ly = fminf(fmaxf(ly, loy), hiy);
      ok_all = ok_all && ok;
      if (level == 0) {  // only the last level's err is read
        const float ax = lx - HALF - cxf, ay = ly - HALF - cyf;
        const float iax = floorf(ax), iay = floorf(ay);
        const Taps tc = taps(ay - iay, ax - iax);
        const int base = (int)iay * S_C + (int)iax;
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (qr[k] >= 0) s[0] += fabsf(blend<S_C>(cw, base + qr[k] * S_C + qc[k], tc) - T[k]);
        feature_sum(s, s_red[fl], parity, t);
        err = s[0] / (float)NPTS;
      }
    } else {
      for (int it = 0; it < iters; ++it) {
        const Patch pc = patch_at(ly - HALF, lx - HALF, WIN, Hp, Wp);
        float b[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          if (qr[k] >= 0) {
            const float e = sample(cur, H, W, pc, qr[k], qc[k]) - T[k];
            b[0] += e * Tx[k];
            b[1] += e * Ty[k];
          }
        }
        feature_sum(b, s_red[fl], parity, t);
        lx = lx - (H11 * b[0] - H01 * b[1]) * inv_det;
        ly = ly - (-H01 * b[0] + H00 * b[1]) * inv_det;
      }
      if (level == 0) {  // only the last level's err is read
        const Patch pf = patch_at(ly - HALF, lx - HALF, WIN, Hp, Wp);
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (qr[k] >= 0) s[0] += fabsf(sample(cur, H, W, pf, qr[k], qc[k]) - T[k]);
        feature_sum(s, s_red[fl], parity, t);
        err = ok ? s[0] / (float)NPTS : 1e9f;
      }
    }
    gx = lx * scale;
    gy = ly * scale;
  }

  if (t == 0) {
    const int H0 = pyr.h[0], W0 = pyr.w[0];
    const bool inb = gx > (float)HALF && gx < (float)(W0 - HALF)
                  && gy > (float)HALF && gy < (float)(H0 - HALF);
    out[2 * i] = gx;
    out[2 * i + 1] = gy;
    err_out[i] = err;
    status[i] = (valid[i] != 0) && ok_all && inb && err < err_thresh;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `pyr` is a host struct of device
// pointers to contiguous float32 levels; pts [n,2] float32, valid [n] bytes
// (torch.bool), out [n,2] float32, status [n] bytes, err [n] float32 are
// device pointers; formulation 0 = FAST, 1 = PALLAS; `stream` is a
// cudaStream_t. Returns a cudaError_t.
extern "C" int plslam_lk_track_f32(const LkPyramid* pyr, const float* pts, const uint8_t* valid,
                                   float* out, uint8_t* status, float* err, int n, int iters,
                                   float err_thresh, int formulation, void* stream) {
  if (pyr->levels < 1 || pyr->levels > MAX_LEVELS || (formulation != FAST && formulation != PALLAS))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int blocks = (n + FPB - 1) / FPB;
    if (formulation == FAST)
      lk_track_kernel<FAST><<<blocks, THREADS, 0, s>>>(*pyr, pts, valid, out, status, err, n, iters, err_thresh);
    else
      lk_track_kernel<PALLAS><<<blocks, THREADS, 0, s>>>(*pyr, pts, valid, out, status, err, n, iters, err_thresh);
  }
  return (int)cudaGetLastError();
}
