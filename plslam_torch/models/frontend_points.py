"""Point-feature frontend: Shi-Tomasi detection + pyramidal LK tracking +
fundamental-matrix RANSAC + min-distance NMS.

Counterpart of `plslam/models/frontend_points.py` (the reference's
`FeatureTracker::readImage`: CLAHE → pyramidal LK → `rejectWithF` →
`setMask` → `goodFeaturesToTrack` → `undistortedPoints`). The slot state
(uv, valid, normalized coords, ids, track counts, next id) stays on the
device; a published frame reads back one packed bundle.

Tracking goes through `plslam_torch.ops.kernels.lk.lk_track`: the hand
Hopper kernel on a CUDA device (one launch per frame, all levels), its
plain version on the CPU. `FrontendPoints(tracker=...)` picks the
formulation: `"fast"` (the default) is the JAX package's default tracker
`lk_track_fast`, `"pallas"` its Pallas kernel `lk_track_pallas` — the
counterparts of the JAX `use_pallas=False` / `True`. Only `lk_track_fast`'s
one-hot-matmul form, which feeds the TPU's matrix unit, is not ported: the
port samples its windows directly.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from plslam_torch.ops.cameras import PinholeRadTan, cam_to, lift
from plslam_torch.ops.kernels.lk import FORMULATIONS, lk_track
from plslam_torch.ops.imu import cholesky
from plslam_torch.utils import timers
from plslam_torch.utils.device import HostCopy, resolve_device

LK_LEVELS = 4  # cv::calcOpticalFlowPyrLK maxLevel=3 → 4 levels
_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def auto_levels(shape, cap: int = LK_LEVELS) -> int:
    """Pyramid depth for an image size: the coarsest level keeps min-dim ≥ 60 px."""
    m = min(shape)
    l = 1
    while l < cap and (m >> l) >= 60:
        l += 1
    return l


# ------------------------------------------------------------------ pyramid
def _band(n: int, stride: int) -> np.ndarray:
    """[ceil(n/stride), n] banded 5-tap blur(+decimate) matrix with edge clamp."""
    pad = len(_K5) // 2
    idx = np.arange(0, n, stride)
    B = np.zeros((len(idx), n), np.float32)
    for o, c in enumerate(idx):
        for t, kv in enumerate(_K5):
            B[o, min(max(c + t - pad, 0), n - 1)] += kv
    return B


@functools.lru_cache(maxsize=None)
def _bands(h: int, w: int, dtype, device):
    return (torch.as_tensor(_band(h, 2), dtype=dtype, device=device),
            torch.as_tensor(_band(w, 2).T.copy(), dtype=dtype, device=device))


def build_pyramid(img, levels: int = LK_LEVELS):
    """5-tap binomial blur + 2× decimation per level, as two banded matmuls
    (Bh @ img @ Bw with the decimation folded into the bands)."""
    cur = img.contiguous()
    pyr = [cur]
    for _ in range(levels - 1):
        Bh, Bw = _bands(cur.shape[0], cur.shape[1], img.dtype, img.device)
        cur = (Bh @ cur @ Bw).contiguous()
        pyr.append(cur)
    return pyr


def _sep_conv(img, k):
    """Separable filter with the taps `k` (a sequence of floats), edge-padded,
    rows then columns; each pass sums its taps in order, as the JAX
    `_sep_conv` does."""
    pad = len(k) // 2
    h, w = img.shape
    x = torch.nn.functional.pad(img[None, None], (0, 0, pad, pad), mode="replicate")[0, 0]
    acc = x[0:h] * float(k[0])
    for i in range(1, len(k)):
        acc = acc + x[i: i + h] * float(k[i])
    x = torch.nn.functional.pad(acc[None, None], (pad, pad, 0, 0), mode="replicate")[0, 0]
    acc = x[:, 0:w] * float(k[0])
    for i in range(1, len(k)):
        acc = acc + x[:, i: i + w] * float(k[i])
    return acc


_K3 = (1.0 / 3.0,) * 3  # the Shi-Tomasi structure tensor's box filter


def _bilinear(img, x, y):
    """Bilinear samples of `img` [H,W] at (x, y): the top-left corner is
    clipped into [0, W−2] × [0, H−2] but the fractions are not, so a point
    outside the image blends the border pixels with its own fractions (the
    JAX `_bilinear`, term for term)."""
    h, w = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 2)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 2)
    i00 = img[y0i, x0i]
    i01 = img[y0i, x0i + 1]
    i10 = img[y0i + 1, x0i]
    i11 = img[y0i + 1, x0i + 1]
    return (i00 * (1 - dx) * (1 - dy) + i01 * dx * (1 - dy)
            + i10 * (1 - dx) * dy + i11 * dx * dy)


# ---------------------------------------------------------------- detection
def shi_tomasi_grid(img, occupied_uv, occupied_valid, cell: int, max_out: int):
    """Dense Shi-Tomasi min-eig score → per-cell argmax → top-`max_out` new
    corners avoiding cells occupied by existing features, with a cross-cell
    min-distance NMS. Returns (uv [max_out,2], score [max_out])."""
    H, W = img.shape
    dtype = img.dtype
    px = torch.nn.functional.pad(img[None, None], (1, 1, 0, 0), mode="replicate")[0, 0]
    py = torch.nn.functional.pad(img[None, None], (0, 0, 1, 1), mode="replicate")[0, 0]
    gx = (px[:, 2:] - px[:, :-2]) * 0.5
    gy = (py[2:, :] - py[:-2, :]) * 0.5
    a = _sep_conv(gx * gx, _K3)
    b = _sep_conv(gx * gy, _K3)
    c = _sep_conv(gy * gy, _K3)
    tr = 0.5 * (a + c)
    det = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    score = tr - det
    bw = 8
    border = torch.zeros_like(score)
    border[bw:-bw, bw:-bw] = 1.0
    score = score * border

    nch, ncw = H // cell, W // cell
    sc = score[: nch * cell, : ncw * cell].reshape(nch, cell, ncw, cell).permute(0, 2, 1, 3)
    sc = sc.reshape(nch * ncw, cell * cell)
    best = torch.argmax(sc, dim=1)
    best_score = torch.gather(sc, 1, best[:, None])[:, 0]
    cells = torch.arange(nch * ncw, device=img.device)
    cy = best // cell + (cells // ncw) * cell
    cx = best % cell + (cells % ncw) * cell

    # occupied cells (existing features): zero their score
    occ_cell = (torch.clamp(occupied_uv[:, 1].to(torch.int64) // cell, 0, nch - 1) * ncw
                + torch.clamp(occupied_uv[:, 0].to(torch.int64) // cell, 0, ncw - 1))
    occ = torch.zeros(nch * ncw, dtype=dtype, device=img.device).scatter_reduce(
        0, occ_cell, occupied_valid.to(dtype), reduce="amax", include_self=True)
    best_score = best_score * (1.0 - occ)

    # cross-cell min-dist NMS: a candidate dies if a strictly better one
    # (ties: lower index) sits within `cell` pixels
    pts = torch.stack([cx.to(dtype), cy.to(dtype)], dim=-1)
    d2 = torch.sum((pts[:, None, :] - pts[None, :, :]) ** 2, dim=-1)
    close = d2 < float(cell) ** 2
    sc_j, sc_i = best_score[None, :], best_score[:, None]
    better = (sc_j > sc_i) | ((sc_j == sc_i) & (cells[None, :] < cells[:, None]))
    dead = torch.any(close & better & (sc_j > 0), dim=1)
    best_score = best_score * (1.0 - dead.to(dtype))

    top = torch.argsort(-best_score, stable=True)[:max_out]
    return pts[top], best_score[top]


# ------------------------------------------------------------------- RANSAC
def gumbel_noise(iters: int, n: int, dtype, generator: torch.Generator):
    """Standard Gumbel draws [iters, n] on the generator's device."""
    u = torch.rand((iters, n), dtype=dtype, device=generator.device, generator=generator)
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def fundamental_ransac(p1, p2, valid, thresh, iters: int = 100, generator=None, gumbel=None):
    """Batched 8-point fundamental-matrix RANSAC (`rejectWithF`) on
    normalized coordinates [N,2]; returns the inlier mask [N].

    Each hypothesis samples 8 distinct valid slots by Gumbel top-k; the
    draws come from `gumbel` [iters, N] when given, else from `generator`.
    The null vector of each design matrix comes from inverse iteration on
    AᵀA + εI; a degenerate sample gives NaN (never an exception) and scores
    zero inliers."""
    n = p1.shape[0]
    dtype = p1.dtype
    if gumbel is None:
        if generator is None:
            generator = torch.Generator(device=p1.device).manual_seed(0)
        gumbel = gumbel_noise(iters, n, dtype, generator)
    score = torch.where(valid[None, :], gumbel.to(dtype), torch.full_like(gumbel, -float("inf"), dtype=dtype))
    samples = torch.topk(score, 8, dim=1).indices  # [iters,8]

    ones = torch.ones((n, 1), dtype=dtype, device=p1.device)
    x1 = torch.cat([p1, ones], dim=1)
    x2 = torch.cat([p2, ones], dim=1)
    a1, a2 = x1[samples], x2[samples]  # [iters,8,3]
    A = torch.stack([a2[..., 0] * a1[..., 0], a2[..., 0] * a1[..., 1], a2[..., 0],
                     a2[..., 1] * a1[..., 0], a2[..., 1] * a1[..., 1], a2[..., 1],
                     a1[..., 0], a1[..., 1], torch.ones_like(a1[..., 0])], dim=-1)
    AtA = torch.einsum("kij,kil->kjl", A, A)
    eps = 1e-8 * torch.diagonal(AtA, dim1=1, dim2=2).sum(-1)[:, None, None]
    L = cholesky(AtA + eps * torch.eye(9, dtype=dtype, device=p1.device))
    v = torch.ones((A.shape[0], 9, 1), dtype=dtype, device=p1.device)
    for _ in range(3):
        v = torch.cholesky_solve(v, L)
        v = v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True), min=1e-30)
    Fs = v.reshape(-1, 3, 3)

    Fx1 = torch.einsum("nj,kij->kni", x1, Fs)
    Ftx2 = torch.einsum("nj,kji->kni", x2, Fs)
    num = torch.sum(x2[None] * Fx1, dim=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    d = num / torch.clamp(den, min=1e-12)
    inl = (d < thresh * thresh) & valid[None, :]
    best = torch.argmax(torch.sum(inl, dim=1), dim=0, keepdim=True)
    # gathered by a 1-element index: a 0-dim one is read back to the host
    return torch.index_select(inl, 0, best)[0] & valid


# -------------------------------------------------------------------- ticks
def to_u8(img):
    """Quantize a float [0,1] grayscale image to uint8 (the reference's CLAHE
    emits CV_8U; the upload is then 4× smaller)."""
    return np.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def dev_image(img, dtype):
    """Device-side inverse of `to_u8` (a cast for float inputs)."""
    if img.dtype == torch.uint8:
        return img.to(dtype) * (1.0 / 255.0)
    return img.to(dtype)


def _in_fov(uv, shape, mask):
    if mask is not None:  # explicit fisheye mask image: nonzero = usable FOV
        h, w = mask.shape
        xi = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, w - 1)
        yi = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, h - 1)
        return mask[yi, xi] > 0.5
    h, w = shape
    r = 0.5 * min(h, w) - 3.0
    d2 = (uv[:, 0] - w / 2.0) ** 2 + (uv[:, 1] - h / 2.0) ** 2
    return d2 <= r * r


def _pack(uv, norm, vel, valid, ids, track_cnt):
    """[N,8] float bundle + a SEPARATE int ids array (ids never ride float lanes)."""
    dtype = uv.dtype
    return torch.cat([uv, norm, vel, valid.to(dtype)[:, None], track_cnt.to(dtype)[:, None]],
                     dim=1), ids


def det_prog(cam, img, min_score, cell: int, N: int, fisheye=False, fov_mask=None):
    """First frame: pyramid + detection only. Returns (pyr, state, bundle)."""
    pyr = build_pyramid(img, levels=auto_levels(img.shape))
    dtype, dev = img.dtype, img.device
    det_uv, det_sc = shi_tomasi_grid(pyr[0], torch.zeros((1, 2), dtype=dtype, device=dev),
                                     torch.zeros((1,), dtype=dtype, device=dev), cell=cell, max_out=N)
    det_norm = lift(cam, det_uv)
    good = det_sc > min_score
    if fisheye:
        good = good & _in_fov(det_uv, img.shape, fov_mask)
    ids = torch.where(good, torch.cumsum(good.to(torch.int32), 0) - 1,
                      torch.full_like(good, -1, dtype=torch.int32)).to(torch.int32)
    cnt = good.to(torch.int32)
    next_id = torch.sum(good).to(torch.int32)
    state = (det_uv, good, det_norm, ids, cnt, next_id)
    return pyr, state, _pack(det_uv, det_norm, torch.zeros_like(det_uv), good, ids, cnt)


def tick(cam, pyr_prev, img_new, state, f_thresh, dt, min_score, cell: int, N: int,
         generator=None, gumbel=None, fisheye=False, fov_mask=None, tracker: str = "fast"):
    """Published frame: pyramid, LK, F-RANSAC, Shi-Tomasi refill, lift and
    velocity. Returns (pyr_new, state_new, bundle)."""
    dtype = img_new.dtype
    uv0, valid0, norm0, ids0, cnt0, next_id = state
    pyr_new = build_pyramid(img_new, levels=len(pyr_prev))
    track_uv, status, _ = lk_track(pyr_prev, pyr_new, uv0, valid0, formulation=tracker)
    ok = status & valid0
    if fisheye:
        ok = ok & _in_fov(track_uv, img_new.shape, fov_mask)
    norm_t = lift(cam, track_uv)
    inl = fundamental_ransac(norm0, norm_t, ok, f_thresh, generator=generator, gumbel=gumbel)
    ok = torch.where(torch.sum(ok) >= 8, ok & inl, ok)  # <8 tracks: RANSAC skipped
    det_uv, det_sc = shi_tomasi_grid(pyr_new[0], track_uv, ok.to(dtype), cell=cell, max_out=N)
    det_norm = lift(cam, det_uv)
    det_good = det_sc > min_score
    if fisheye:
        det_good = det_good & _in_fov(det_uv, img_new.shape, fov_mask)
    # refill: free slot of rank r takes candidate r; new ids by FILL rank
    fr = torch.cumsum((~ok).to(torch.int64), 0) - 1
    ci = torch.clamp(fr, 0, N - 1)
    fill = (~ok) & det_good[ci]
    valid1 = ok | fill
    uv1 = torch.where(fill[:, None], det_uv[ci], track_uv)
    norm1 = torch.where(fill[:, None], det_norm[ci], norm_t)
    new_ids = next_id + (torch.cumsum(fill.to(torch.int32), 0) - 1).to(torch.int32)
    ids1 = torch.where(ok, ids0, torch.where(fill, new_ids, torch.full_like(ids0, -1)))
    cnt1 = torch.where(ok, cnt0 + 1, fill.to(torch.int32))
    next1 = next_id + torch.sum(fill).to(torch.int32)
    # per-feature normalized velocity, only for slots tracked from the previous frame
    if dt > 0:
        vel = torch.where(ok[:, None], (norm_t - norm0) / max(dt, 1e-6), torch.zeros_like(norm_t))
    else:
        vel = torch.zeros_like(norm_t)
    state1 = (uv1, valid1, norm1, ids1, cnt1, next1)
    return pyr_new, state1, _pack(uv1, norm1, vel, valid1, ids1, cnt1)


def tick_light(cam, pyr_prev, img_new, state, fisheye=False, fov_mask=None,
               tracker: str = "fast"):
    """Tracked-only (non-published) frame: pyramid + LK + track upkeep."""
    uv0, valid0, norm0, ids0, cnt0, next_id = state
    pyr_new = build_pyramid(img_new, levels=len(pyr_prev))
    track_uv, status, _ = lk_track(pyr_prev, pyr_new, uv0, valid0, formulation=tracker)
    ok = status & valid0
    if fisheye:
        ok = ok & _in_fov(track_uv, img_new.shape, fov_mask)
    norm_t = lift(cam, track_uv)
    cnt1 = torch.where(ok, cnt0 + 1, torch.zeros_like(cnt0))
    ids1 = torch.where(ok, ids0, torch.full_like(ids0, -1))
    return pyr_new, (track_uv, ok, norm_t, ids1, cnt1, next_id)


# ------------------------------------------------------------ host wrapper
class FrontendPoints:
    """Host orchestration (`FeatureTracker` equivalent). Slot state and the
    previous pyramid live on `device`; `process` reads back one bundle on a
    published frame and nothing on a tracked-only one. `tracker` is the LK
    formulation: `"fast"` (default; the JAX `use_pallas=False`, its
    `lk_track_fast`) or `"pallas"` (the JAX `use_pallas=True`, its
    `lk_track_pallas`)."""

    def __init__(self, cam: PinholeRadTan, max_cnt=150, min_dist=30, f_thresh_px=1.0,
                 focal=460.0, dtype=torch.float32, min_score=1e-4, fisheye: bool = False,
                 fisheye_mask=None, device=None, seed: int = 7, tracker: str = "fast"):
        if tracker not in FORMULATIONS:
            raise ValueError(f"FrontendPoints: tracker must be one of {FORMULATIONS}, got {tracker!r}")
        self.tracker = tracker
        self.device = resolve_device(device)
        self.dtype = dtype
        self.cam = cam_to(cam, dtype, self.device)
        self.max_cnt = max_cnt
        self.min_dist = min_dist
        self.f_thresh = f_thresh_px / focal
        self.min_score = min_score
        self.fisheye = fisheye or fisheye_mask is not None
        self._mask_img = (torch.as_tensor(np.asarray(fisheye_mask) > 0.5, dtype=dtype,
                                          device=self.device)
                          if fisheye_mask is not None else None)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.prev_pyr = None
        self._state = None  # device: (uv, valid, norm, ids, track_cnt, next_id)
        self.prev_t = None
        self.prev_valid = np.zeros(max_cnt, bool)
        self.track_cnt = np.zeros(max_cnt, np.int64)

    def reset(self):
        """Restart the tracker from scratch (timestamp-discontinuity handshake)."""
        self.prev_pyr = None
        self._state = None
        self.prev_t = None
        self.prev_valid = np.zeros(self.max_cnt, bool)
        self.track_cnt = np.zeros(self.max_cnt, np.int64)

    def upload(self, img):
        """Host float image → device tensor (shipped as uint8, cast on device)."""
        if isinstance(img, torch.Tensor):
            return dev_image(img.to(self.device), self.dtype)
        u8 = torch.from_numpy(to_u8(np.asarray(img)))
        if self.device.type == "cuda":
            u8 = u8.pin_memory().to(self.device, non_blocking=True)
        return dev_image(u8, self.dtype)

    def process(self, img, t: float, want_output=True, light: bool = False, gumbel=None):
        """One frame tick (`FeatureTracker::readImage`). Returns
        (ids, normalized pts, velocities, pixel uv) of valid features, a
        `HostCopy` handle whose `get()` returns them when `want_output` is
        "defer", or None when `want_output` is False. `light=True`
        (tracked-only frames) runs pyramid + LK only. `gumbel` optionally
        fixes the RANSAC draws."""
        with timers.span("points.process"):
            img_d = self.upload(img)
            kw = dict(fisheye=self.fisheye, fov_mask=self._mask_img)
            if self.prev_pyr is None:
                self.prev_pyr, self._state, bundle = det_prog(
                    self.cam, img_d, self.min_score, self.min_dist, self.max_cnt, **kw)
            elif light and not want_output:
                self.prev_pyr, self._state = tick_light(self.cam, self.prev_pyr, img_d, self._state,
                                                        tracker=self.tracker, **kw)
                self.prev_t = t
                return None
            else:
                dt = (t - self.prev_t) if self.prev_t is not None else 0.0
                self.prev_pyr, self._state, bundle = tick(
                    self.cam, self.prev_pyr, img_d, self._state, self.f_thresh, dt, self.min_score,
                    self.min_dist, self.max_cnt, generator=self.generator, gumbel=gumbel,
                    tracker=self.tracker, **kw)
            self.prev_t = t
            if not want_output:
                return None
            h = HostCopy(*bundle, unpack=self._unpack)
            return h if want_output == "defer" else h.get()

    def _unpack(self, bundle: np.ndarray, ids: np.ndarray):
        b = bundle.astype(np.float64)
        ids = ids.astype(np.int64)
        valid = b[:, 6] > 0
        self.prev_valid = valid
        self.track_cnt = b[:, 7].astype(np.int64)
        return ids[valid], b[valid, 2:4], b[valid, 4:6], b[valid, 0:2]
