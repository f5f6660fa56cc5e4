"""Pyramidal Lucas-Kanade in plain torch: the image pyramid and the point
frontend's "fast" tracker (a 24x24 template window at the previous point, a
30x30 search window at each level's initial guess, 10 inverse-compositional
Gauss-Newton steps a level, status by bounds and the last level's mean
|I - T|). A frozen copy of the port's plain `lk_track_fast_torch`, run here
in float64; the pyramid is worked out again from level 0."""
from __future__ import annotations

import numpy as np
import torch

WIN = 21
HALF = WIN // 2
LK_MARGIN = 4
S_T = WIN + 3
S_C = WIN + 2 * LK_MARGIN + 1
K5 = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def _blur_decimate(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The 5-tap binomial filter along `axis` with the edge clamped, kept at
    every second sample from 0."""
    n = x.shape[axis]
    centers = torch.arange(0, n, 2)
    out = 0.0
    for t, k in enumerate(K5):
        idx = torch.clamp(centers + t - 2, 0, n - 1)
        out = out + k * torch.index_select(x, axis, idx)
    return out


def pyramid(level0: torch.Tensor, levels: int) -> list:
    pyr = [level0]
    for _ in range(levels - 1):
        pyr.append(_blur_decimate(_blur_decimate(pyr[-1], 0), 1))
    return pyr


def _taps(win, fy, fx, s: int):
    fy, fx = fy[:, None, None], fx[:, None, None]
    return ((1.0 - fy) * (1.0 - fx) * win[:, :s, :s] + (1.0 - fy) * fx * win[:, :s, 1:]
            + fy * (1.0 - fx) * win[:, 1:, :s] + fy * fx * win[:, 1:, 1:])


def _windows(img, tl, s: int):
    r = torch.arange(s)
    return img[(tl[:, 1:2] + r)[:, :, None], (tl[:, 0:1] + r)[:, None, :]]


def _window_patch(win, a, s: int = WIN):
    ia = torch.floor(a)
    fa = a - ia
    ia = ia.to(torch.int64)
    r = torch.arange(s + 1)
    n = torch.arange(win.shape[0])[:, None, None]
    sub = win[n, (ia[:, 1:2] + r)[:, :, None], (ia[:, 0:1] + r)[:, None, :]]
    return _taps(sub, fa[:, 1], fa[:, 0], s)


def _template(T23):
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
    H00, H01, H11 = Hs
    e = I - T
    b0 = torch.sum(e * Tx, dim=(1, 2))
    b1 = torch.sum(e * Ty, dim=(1, 2))
    return (H11 * b0 - H01 * b1) / det_safe, (-H01 * b0 + H00 * b1) / det_safe


def track(pyr_prev, pyr_cur, pts_prev, valid, iters: int = 10, err_thresh: float = 0.12):
    """Returns (pts [N,2], status [N], err [N]) in the dtype of the inputs."""
    levels = len(pyr_prev)
    n, dtype = pts_prev.shape[0], pts_prev.dtype
    guess = pts_prev
    err = torch.zeros(n, dtype=dtype)
    ok_all = torch.ones(n, dtype=torch.bool)
    for level in range(levels - 1, -1, -1):
        scale = 2.0 ** level
        prev, cur = pyr_prev[level], pyr_cur[level]
        H, W = prev.shape
        p0 = pts_prev / scale
        g = guess / scale
        t_f = p0 - (HALF + 1)
        t_i = torch.floor(t_f)
        tl_t = torch.clamp(t_i.to(torch.int64), min=0)
        tl_t = torch.minimum(tl_t, torch.tensor([W - S_T, H - S_T]))
        T23 = _taps(_windows(prev, tl_t, S_T), (t_f - t_i)[:, 1], (t_f - t_i)[:, 0], WIN + 2)
        T, Tx, Ty, Hs, ok, det_safe = _template(T23)
        c_tl = torch.clamp(torch.floor(g - HALF).to(torch.int64) - LK_MARGIN, min=0)
        c_tl = torch.minimum(c_tl, torch.tensor([W - S_C, H - S_C]))
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
    Hh, Ww = pyr_cur[0].shape
    inb = ((guess[:, 0] > HALF) & (guess[:, 0] < Ww - HALF)
           & (guess[:, 1] > HALF) & (guess[:, 1] < Hh - HALF))
    return guess, valid & ok_all & inb & (err < err_thresh), err


def np_f64(t) -> torch.Tensor:
    return torch.as_tensor(np.asarray(t), dtype=torch.float64)
