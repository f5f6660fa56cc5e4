"""Pyramidal inverse-compositional Lucas-Kanade: the hand-written Hopper
kernel (`plslam_torch/csrc/lk.cu`) and its plain PyTorch version.

Both compute what the TPU kernel `lk_level_pallas` (`plslam/ops/kernels/lk.py`)
computes, one pyramid level at a time:
  * a 23×23 bilinear template at the previous point, central-difference
    Tx/Ty over the inner 21×21, the 2×2 Gauss-Newton Hessian (det ≤ 1e-6
    gives err = 1e9);
  * `iters` inverse-compositional updates of the subpixel guess;
  * err = mean |I − T| over the final patch.
Borders: the image is edge-padded to multiples of (8, 128); the patch's
integer top-left is clamped inside the padded image and the unclamped
fraction kept (`_bilinear_patch` + `_pad_image` there).

`lk_level` dispatches on the device of its inputs: CPU tensors take the
plain version, CUDA tensors the kernel (or an error — there is no fallback).
`LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from plslam_torch.ops.kernels import _build

WIN = 21  # patch size (cv::calcOpticalFlowPyrLK default)
HALF = WIN // 2
LAUNCHES = 0  # kernel launches (plain-version calls do not count)


# ---------------------------------------------------------------- plain torch
def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def _bilinear_patch(img, y0f, x0f, s: int):
    """[N,s,s] patches of `img` [H,W] at float top-lefts (y0f, x0f) [N]:
    integer top-left clamped to the (8,128)-padded image, fraction kept,
    reads replicate the edge."""
    H, W = img.shape
    iy = torch.floor(y0f)
    ix = torch.floor(x0f)
    fy = (y0f - iy)[:, None, None]
    fx = (x0f - ix)[:, None, None]
    iyc = torch.clamp(iy.to(torch.int64), 0, _ceil(H, 8) - (s + 1))
    ixc = torch.clamp(ix.to(torch.int64), 0, _ceil(W, 128) - (s + 1))
    r = torch.arange(s + 1, device=img.device)
    rows = torch.clamp(iyc[:, None] + r, max=H - 1)
    cols = torch.clamp(ixc[:, None] + r, max=W - 1)
    win = img[rows[:, :, None], cols[:, None, :]]  # [N,s+1,s+1]
    return ((1.0 - fy) * (1.0 - fx) * win[:, :s, :s] + (1.0 - fy) * fx * win[:, :s, 1:]
            + fy * (1.0 - fx) * win[:, 1:, :s] + fy * fx * win[:, 1:, 1:])


def lk_level_torch(prev, cur, pts, guess, iters: int = 10):
    """One level, all features batched: returns (pts_out [N,2], err [N])."""
    T23 = _bilinear_patch(prev, pts[:, 1] - HALF - 1.0, pts[:, 0] - HALF - 1.0, WIN + 2)
    T = T23[:, 1:WIN + 1, 1:WIN + 1]
    Tx = 0.5 * (T23[:, 1:WIN + 1, 2:WIN + 2] - T23[:, 1:WIN + 1, 0:WIN])
    Ty = 0.5 * (T23[:, 2:WIN + 2, 1:WIN + 1] - T23[:, 0:WIN, 1:WIN + 1])
    H00 = torch.sum(Tx * Tx, dim=(1, 2))
    H01 = torch.sum(Tx * Ty, dim=(1, 2))
    H11 = torch.sum(Ty * Ty, dim=(1, 2))
    det = H00 * H11 - H01 * H01
    ok = det > 1e-6
    det_safe = torch.where(ok, det, torch.ones_like(det))
    gx, gy = guess[:, 0], guess[:, 1]
    for _ in range(iters):
        e = _bilinear_patch(cur, gy - HALF, gx - HALF, WIN) - T
        b0 = torch.sum(e * Tx, dim=(1, 2))
        b1 = torch.sum(e * Ty, dim=(1, 2))
        gx = gx - (H11 * b0 - H01 * b1) / det_safe
        gy = gy - (-H01 * b0 + H00 * b1) / det_safe
    err = torch.mean(torch.abs(_bilinear_patch(cur, gy - HALF, gx - HALF, WIN) - T), dim=(1, 2))
    return torch.stack([gx, gy], dim=1), torch.where(ok, err, torch.full_like(err, 1e9))


# --------------------------------------------------------------- CUDA kernel
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _check(t, name, shape):
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 CUDA tensor, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def lk_level_cuda(prev, cur, pts, guess, iters: int = 10):
    """One level on the card through `plslam_lk_level_f32`."""
    global LAUNCHES
    if prev.ndim != 2:
        raise ValueError(f"prev: expected [H,W], got {tuple(prev.shape)}")
    H, W = prev.shape
    n = pts.shape[0]
    _check(prev, "prev", (H, W))
    _check(cur, "cur", (H, W))
    _check(pts, "pts", (n, 2))
    _check(guess, "guess", (n, 2))
    if len({t.device for t in (prev, cur, pts, guess)}) != 1:
        raise ValueError("prev, cur, pts and guess must be on one device")
    fn = _build.bind("plslam_lk_level_f32", _ARGTYPES)
    out = torch.empty((n, 2), dtype=torch.float32, device=pts.device)
    err = torch.empty((n,), dtype=torch.float32, device=pts.device)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    rc = fn(prev.data_ptr(), cur.data_ptr(), H, W, pts.data_ptr(), guess.data_ptr(),
            out.data_ptr(), err.data_ptr(), n, int(iters), stream)
    if rc != 0:
        raise RuntimeError(f"lk kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out, err


def lk_level(prev, cur, pts, guess, iters: int = 10):
    """One pyramid level: the kernel for CUDA tensors, the plain version for CPU ones."""
    if pts.is_cuda:
        return lk_level_cuda(prev, cur, pts, guess, iters)
    if pts.device.type != "cpu":
        raise ValueError(f"lk_level: unsupported device {pts.device}")
    return lk_level_torch(prev, cur, pts, guess, iters)


def lk_track(pyr_prev, pyr_cur, pts_prev, valid, levels: int | None = None, iters: int = 10,
             err_thresh: float = 0.12):
    """Full pyramidal tracker, coarse to fine (drop-in for `lk_track_pallas`).
    Status = valid & in-bounds (HALF) & last-level err < err_thresh."""
    return _track(lk_level, pyr_prev, pyr_cur, pts_prev, valid, levels, iters, err_thresh)


def lk_track_torch(pyr_prev, pyr_cur, pts_prev, valid, levels: int | None = None, iters: int = 10,
                   err_thresh: float = 0.12):
    """`lk_track` with the plain version at every level, on any device."""
    return _track(lk_level_torch, pyr_prev, pyr_cur, pts_prev, valid, levels, iters, err_thresh)


def _track(level_fn, pyr_prev, pyr_cur, pts_prev, valid, levels, iters, err_thresh):
    levels = len(pyr_prev) if levels is None else levels
    guess = pts_prev
    err = torch.zeros(pts_prev.shape[0], dtype=pts_prev.dtype, device=pts_prev.device)
    for level in range(levels - 1, -1, -1):
        scale = 2.0 ** level
        out, err = level_fn(pyr_prev[level], pyr_cur[level], pts_prev / scale, guess / scale, iters)
        guess = out * scale
    H, W = pyr_cur[0].shape
    inb = ((guess[:, 0] > HALF) & (guess[:, 0] < W - HALF)
           & (guess[:, 1] > HALF) & (guess[:, 1] < H - HALF))
    return guess, valid & inb & (err < err_thresh)
