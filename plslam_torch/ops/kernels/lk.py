"""Pyramidal inverse-compositional Lucas-Kanade: the hand-written Hopper
kernel (`plslam_torch/csrc/lk.cu`) and its plain PyTorch versions.

One call tracks all features through every pyramid level, coarse to fine,
in one of two formulations (`FORMULATIONS`):

* `"fast"`, the default and the main path's: what the JAX package's default
  tracker `lk_track_fast` (`plslam/models/frontend_points.py`) computes.
  Per level, a 23×23 bilinear template from the 24×24 window at the point
  (top-left clipped to the level, the fraction kept), a 30×30 search window
  at the level's initial guess (LK_MARGIN = 4 px each side, clipped to the
  level) and `iters` Gauss-Newton steps with the guess clamped inside it;
  the det gate is ANDed over the levels. The JAX function samples through
  one-hot selection matmuls (for the TPU's matrix unit); the same 4-tap
  bilinear blend is taken here directly from the windows.
* `"pallas"`: what the TPU kernel `lk_level_pallas` (`plslam/ops/kernels/lk.py`)
  computes, driven over the levels as `lk_track_pallas` drives it. The
  guess is unbounded; the image is edge-padded to multiples of (8, 128), a
  patch's integer top-left is clamped inside the padded image with the
  unclamped fraction kept, and det ≤ 1e-6 gives err = 1e9 (last level only).

Both: 21×21 patch, central-difference Tx/Ty over the template's inner
21×21, the 2×2 Gauss-Newton Hessian, err = mean |I − T| at the last level,
status = valid & in-bounds (HALF) & err < err_thresh (& the det gate of
every level for `"fast"`).

`lk_track` dispatches on the device of its inputs: CPU tensors take the
plain version of the formulation, CUDA tensors the kernel (one launch per
call, all levels) or an error — there is no fallback. `LAUNCHES` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from plslam_torch.ops.kernels import _build

WIN = 21  # patch size (cv::calcOpticalFlowPyrLK default)
HALF = WIN // 2
LK_MARGIN = 4  # "fast": max integer motion per level inside one search window (px)
S_T = WIN + 3  # "fast": template window side (23×23 template + 1 for the blend)
S_C = WIN + 2 * LK_MARGIN + 1  # "fast": search window side (30)
MAX_LEVELS = 4
FORMULATIONS = ("fast", "pallas")
LAUNCHES = 0  # kernel launches (plain-version calls do not count)


# ---------------------------------------------------------------- plain torch
def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def _taps(win, fy, fx, s: int):
    """[N,s,s] bilinear blend of the [N,s+1,s+1] windows `win` at fractions
    (fy, fx) [N]: w00*I00 + w01*I01 + w10*I10 + w11*I11."""
    fy, fx = fy[:, None, None], fx[:, None, None]
    return ((1.0 - fy) * (1.0 - fx) * win[:, :s, :s] + (1.0 - fy) * fx * win[:, :s, 1:]
            + fy * (1.0 - fx) * win[:, 1:, :s] + fy * fx * win[:, 1:, 1:])


def _bilinear_patch(img, y0f, x0f, s: int):
    """[N,s,s] patches of `img` [H,W] at float top-lefts (y0f, x0f) [N]:
    integer top-left clamped to the (8,128)-padded image, fraction kept,
    reads replicate the edge."""
    H, W = img.shape
    iy = torch.floor(y0f)
    ix = torch.floor(x0f)
    iyc = torch.clamp(iy.to(torch.int64), 0, _ceil(H, 8) - (s + 1))
    ixc = torch.clamp(ix.to(torch.int64), 0, _ceil(W, 128) - (s + 1))
    r = torch.arange(s + 1, device=img.device)
    rows = torch.clamp(iyc[:, None] + r, max=H - 1)
    cols = torch.clamp(ixc[:, None] + r, max=W - 1)
    return _taps(img[rows[:, :, None], cols[:, None, :]], y0f - iy, x0f - ix, s)


def _template(T23):
    """T, Tx, Ty over the inner 21×21 of [N,23,23] templates, the Hessian's
    (H00, H01, H11), and the det gate (ok, det with 1 where it fails)."""
    T = T23[:, 1:WIN + 1, 1:WIN + 1]
    Tx = 0.5 * (T23[:, 1:WIN + 1, 2:WIN + 2] - T23[:, 1:WIN + 1, 0:WIN])
    Ty = 0.5 * (T23[:, 2:WIN + 2, 1:WIN + 1] - T23[:, 0:WIN, 1:WIN + 1])
    H00 = torch.sum(Tx * Tx, dim=(1, 2))
    H01 = torch.sum(Tx * Ty, dim=(1, 2))
    H11 = torch.sum(Ty * Ty, dim=(1, 2))
    det = H00 * H11 - H01 * H01
    ok = det > 1e-6
    return T, Tx, Ty, (H00, H01, H11), ok, torch.where(ok, det, torch.ones_like(det))


def _gn_step(I, T, Tx, Ty, Hs, det_safe):
    """(du, dv) of one inverse-compositional Gauss-Newton step."""
    H00, H01, H11 = Hs
    e = I - T
    b0 = torch.sum(e * Tx, dim=(1, 2))
    b1 = torch.sum(e * Ty, dim=(1, 2))
    return (H11 * b0 - H01 * b1) / det_safe, (-H01 * b0 + H00 * b1) / det_safe


def lk_level_torch(prev, cur, pts, guess, iters: int = 10):
    """One level of the `"pallas"` formulation, all features batched:
    returns (pts_out [N,2], err [N])."""
    T23 = _bilinear_patch(prev, pts[:, 1] - HALF - 1.0, pts[:, 0] - HALF - 1.0, WIN + 2)
    T, Tx, Ty, Hs, ok, det_safe = _template(T23)
    gx, gy = guess[:, 0], guess[:, 1]
    for _ in range(iters):
        du, dv = _gn_step(_bilinear_patch(cur, gy - HALF, gx - HALF, WIN), T, Tx, Ty, Hs, det_safe)
        gx = gx - du
        gy = gy - dv
    err = torch.mean(torch.abs(_bilinear_patch(cur, gy - HALF, gx - HALF, WIN) - T), dim=(1, 2))
    return torch.stack([gx, gy], dim=1), torch.where(ok, err, torch.full_like(err, 1e9))


def _status(pyr_cur, guess, valid, err, err_thresh):
    H, W = pyr_cur[0].shape
    inb = ((guess[:, 0] > HALF) & (guess[:, 0] < W - HALF)
           & (guess[:, 1] > HALF) & (guess[:, 1] < H - HALF))
    return valid & inb & (err < err_thresh)


def lk_track_torch(pyr_prev, pyr_cur, pts_prev, valid, levels: int | None = None, iters: int = 10,
                   err_thresh: float = 0.12):
    """The `"pallas"` formulation (`lk_track_pallas`), plain, on any device:
    returns (pts [N,2], status [N], the last level's err [N])."""
    levels = len(pyr_prev) if levels is None else levels
    guess = pts_prev
    err = torch.zeros(pts_prev.shape[0], dtype=pts_prev.dtype, device=pts_prev.device)
    for level in range(levels - 1, -1, -1):
        scale = 2.0 ** level
        out, err = lk_level_torch(pyr_prev[level], pyr_cur[level], pts_prev / scale, guess / scale,
                                  iters)
        guess = out * scale
    return guess, _status(pyr_cur, guess, valid, err, err_thresh), err


def _windows(img, tl, s: int):
    """[N,s,s] windows of `img` at integer top-lefts `tl` [N,2] (x, y)."""
    r = torch.arange(s, device=img.device)
    return img[(tl[:, 1:2] + r)[:, :, None], (tl[:, 0:1] + r)[:, None, :]]


def _window_patch(win, a, s: int = WIN):
    """[N,s,s] bilinear patches of the windows `win` [N,S,S] at float
    top-lefts `a` [N,2] (x, y) inside them."""
    ia = torch.floor(a)
    fa = a - ia
    ia = ia.to(torch.int64)
    r = torch.arange(s + 1, device=win.device)
    n = torch.arange(win.shape[0], device=win.device)[:, None, None]
    sub = win[n, (ia[:, 1:2] + r)[:, :, None], (ia[:, 0:1] + r)[:, None, :]]
    return _taps(sub, fa[:, 1], fa[:, 0], s)


def lk_track_fast_torch(pyr_prev, pyr_cur, pts_prev, valid, levels: int | None = None,
                        iters: int = 10, err_thresh: float = 0.12):
    """The `"fast"` formulation (`lk_track_fast`), plain, on any device:
    returns (pts [N,2], status [N], the last level's err [N])."""
    levels = len(pyr_prev) if levels is None else levels
    n, dtype, dev = pts_prev.shape[0], pts_prev.dtype, pts_prev.device
    guess = pts_prev
    err = torch.zeros(n, dtype=dtype, device=dev)
    ok_all = torch.ones(n, dtype=torch.bool, device=dev)
    for level in range(levels - 1, -1, -1):
        scale = 2.0 ** level
        prev, cur = pyr_prev[level], pyr_cur[level]
        H, W = prev.shape
        if min(H, W) < S_C:
            raise ValueError(f"lk_track fast: level {level} is {H}×{W}, smaller than the "
                             f"{S_C}×{S_C} search window")
        p0 = pts_prev / scale
        g = guess / scale

        # template: the 24×24 window at p0 − 11, clipped to the level; fraction kept
        t_f = p0 - (HALF + 1)
        t_i = torch.floor(t_f)
        tl_t = torch.clamp(t_i.to(torch.int64), min=0)
        tl_t = torch.minimum(tl_t, torch.tensor([W - S_T, H - S_T], device=dev))
        T23 = _taps(_windows(prev, tl_t, S_T), (t_f - t_i)[:, 1], (t_f - t_i)[:, 0], WIN + 2)
        T, Tx, Ty, Hs, ok, det_safe = _template(T23)

        # search window at the level's initial guess; the guess stays in [lo, hi]
        c_tl = torch.clamp(torch.floor(g - HALF).to(torch.int64) - LK_MARGIN, min=0)
        c_tl = torch.minimum(c_tl, torch.tensor([W - S_C, H - S_C], device=dev))
        Wc = _windows(cur, c_tl, S_C)
        c_f = c_tl.to(dtype)
        lo, hi = c_f + HALF, c_f + (S_C - 2 - HALF)
        for _ in range(iters):
            gc = torch.minimum(torch.maximum(g, lo), hi)
            du, dv = _gn_step(_window_patch(Wc, gc - HALF - c_f), T, Tx, Ty, Hs, det_safe)
            g = gc - torch.stack([du, dv], dim=1)
        g = torch.minimum(torch.maximum(g, lo), hi)
        err = torch.mean(torch.abs(_window_patch(Wc, g - HALF - c_f) - T), dim=(1, 2))
        ok_all = ok_all & ok
        guess = g * scale
    return guess, _status(pyr_cur, guess, valid & ok_all, err, err_thresh), err


# --------------------------------------------------------------- CUDA kernel
class _Pyramid(ctypes.Structure):
    """`LkPyramid` of csrc/lk.cu: per-level device pointers and shapes."""
    _fields_ = [("prev", ctypes.c_void_p * MAX_LEVELS), ("cur", ctypes.c_void_p * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS), ("w", ctypes.c_int * MAX_LEVELS),
                ("levels", ctypes.c_int)]


_ARGTYPES = (ctypes.POINTER(_Pyramid), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_void_p)
_FN = None  # the bound C entry, after the first launch


def _check(t, name, shape, dtype=torch.float32):
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_formulation(formulation):
    if formulation not in FORMULATIONS:
        raise ValueError(f"lk_track: formulation must be one of {FORMULATIONS}, got {formulation!r}")


def lk_track_cuda(pyr_prev, pyr_cur, pts_prev, valid, levels: int | None = None, iters: int = 10,
                  err_thresh: float = 0.12, formulation: str = "fast"):
    """The whole track on the card in one launch of `plslam_lk_track_f32`:
    returns (pts [N,2], status [N], the last level's err [N]). `"fast"`
    needs every level to hold its 30×30 search window; `"pallas"` needs
    17 rows (its 24-row template window inside the level padded to a
    multiple of 8 rows, as the Pallas kernel pads it)."""
    global LAUNCHES, _FN
    _check_formulation(formulation)
    levels = len(pyr_prev) if levels is None else levels
    if not 1 <= levels <= min(MAX_LEVELS, len(pyr_prev), len(pyr_cur)):
        raise ValueError(f"lk_track: {levels} levels; the kernel takes 1..{MAX_LEVELS} and "
                         f"the pyramids have {len(pyr_prev)} and {len(pyr_cur)}")
    n = pts_prev.shape[0]
    _check(pts_prev, "pts_prev", (n, 2))
    _check(valid, "valid", (n,), torch.bool)
    pyr = _Pyramid(levels=levels)
    for level in range(levels):
        prev, cur = pyr_prev[level], pyr_cur[level]
        if prev.ndim != 2:
            raise ValueError(f"prev[{level}]: need an [H,W] level, got {tuple(prev.shape)}")
        if formulation == "fast" and min(prev.shape) < S_C:
            raise ValueError(f"lk_track fast: level {level} is {prev.shape[0]}×{prev.shape[1]}, "
                             f"smaller than the {S_C}×{S_C} search window")
        if formulation == "pallas" and _ceil(prev.shape[0], 8) < WIN + 3:
            raise ValueError(f"lk_track pallas: level {level} has {prev.shape[0]} rows; padded "
                             f"to a multiple of 8 they must hold its {WIN + 3}-row template window")
        _check(prev, f"prev[{level}]", prev.shape)
        _check(cur, f"cur[{level}]", prev.shape)
        if prev.device != pts_prev.device or cur.device != pts_prev.device:
            raise ValueError("the pyramids and the points must be on one device")
        pyr.prev[level], pyr.cur[level] = prev.data_ptr(), cur.data_ptr()
        pyr.h[level], pyr.w[level] = prev.shape
    if _FN is None:
        _FN = _build.bind("plslam_lk_track_f32", _ARGTYPES)
    out = torch.empty((n, 2), dtype=torch.float32, device=pts_prev.device)
    status = torch.empty((n,), dtype=torch.bool, device=pts_prev.device)
    err = torch.empty((n,), dtype=torch.float32, device=pts_prev.device)
    stream = torch.cuda.current_stream(pts_prev.device).cuda_stream
    rc = _FN(ctypes.byref(pyr), pts_prev.data_ptr(), valid.data_ptr(), out.data_ptr(),
             status.data_ptr(), err.data_ptr(), n, int(iters), float(err_thresh),
             FORMULATIONS.index(formulation), stream)
    if rc != 0:
        raise RuntimeError(f"lk kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out, status, err


def lk_track(pyr_prev, pyr_cur, pts_prev, valid, levels: int | None = None, iters: int = 10,
             err_thresh: float = 0.12, formulation: str = "fast"):
    """Full pyramidal tracker, coarse to fine: the kernel for CUDA tensors,
    the formulation's plain version for CPU ones. Returns (pts [N,2],
    status [N], the last level's err [N])."""
    if pts_prev.is_cuda:
        return lk_track_cuda(pyr_prev, pyr_cur, pts_prev, valid, levels, iters, err_thresh,
                             formulation)
    if pts_prev.device.type != "cpu":
        raise ValueError(f"lk_track: unsupported device {pts_prev.device}")
    _check_formulation(formulation)
    plain = lk_track_fast_torch if formulation == "fast" else lk_track_torch
    return plain(pyr_prev, pyr_cur, pts_prev, valid, levels, iters, err_thresh)
