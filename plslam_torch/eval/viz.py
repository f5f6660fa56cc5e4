"""Debug visualization: feature-track overlays and loop match images.

Counterpart of `plslam/eval/viz.py`: the reference's `show_track` debug
stream and the pose graph's `match_image` as PNG files. All drawing is
numpy on grayscale float images in [0,1] on the host (the images and pixel
positions arrive there with the frontend's readback); PNGs are written with
the port's own encoder (`io/render.write_png_gray`).
"""
from __future__ import annotations

import os

import numpy as np

from plslam_torch.io.render import write_png_gray


def _disk(img, x, y, r, val):
    h, w = img.shape
    x0, x1 = max(int(x - r), 0), min(int(x + r) + 1, w)
    y0, y1 = max(int(y - r), 0), min(int(y + r) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    m = (xx - x) ** 2 + (yy - y) ** 2 <= r * r
    img[y0:y1, x0:x1][m] = val


def _line(img, p0, p1, val):
    h, w = img.shape
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    xs = np.linspace(p0[0], p1[0], n)
    ys = np.linspace(p0[1], p1[1], n)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok].astype(int), xs[ok].astype(int)] = val


def draw_tracks(img, uv, track_cnt=None, vel=None):
    """`show_track` overlay: a dot per feature — brightness encodes track age
    (the reference colored red→blue by track_cnt) — plus a velocity whisker."""
    out = np.asarray(img, np.float32).copy() * 0.6
    uv = np.asarray(uv)
    n = len(uv)
    age = np.asarray(track_cnt) if track_cnt is not None else np.full(n, 10)
    for k in range(n):
        val = float(np.clip(0.55 + 0.45 * min(age[k], 20) / 20.0, 0, 1))
        _disk(out, uv[k, 0], uv[k, 1], 2.0, val)
        if vel is not None:
            _line(out, uv[k], uv[k] + 8.0 * np.asarray(vel[k]), val)
    return out


def draw_match_image(img_cur, uv_cur, img_old, uv_old):
    """Loop `match_image`: old|current side-by-side with match segments."""
    h = max(img_cur.shape[0], img_old.shape[0])
    w0 = img_old.shape[1]
    out = np.zeros((h, w0 + img_cur.shape[1]), np.float32)
    out[: img_old.shape[0], :w0] = np.asarray(img_old) * 0.7
    out[: img_cur.shape[0], w0:] = np.asarray(img_cur) * 0.7
    for po, pc in zip(np.asarray(uv_old), np.asarray(uv_cur)):
        _disk(out, po[0], po[1], 2.0, 1.0)
        _disk(out, pc[0] + w0, pc[1], 2.0, 1.0)
        _line(out, po, (pc[0] + w0, pc[1]), 0.95)
    return out


class TrackVisualizer:
    """Writes `show_track`/`match_image` PNG streams under
    `<output_path>/viz/` when the corresponding config flags are on."""

    def __init__(self, output_path: str, enabled: bool = True, every: int = 1):
        self.dir = os.path.join(output_path, "viz")
        self.enabled = enabled
        self.every = max(1, every)
        self._k = 0
        if enabled:
            os.makedirs(self.dir, exist_ok=True)

    def track_frame(self, img, uv, track_cnt=None, vel=None):
        if not self.enabled:
            return None
        self._k += 1
        if (self._k - 1) % self.every:
            return None
        out = draw_tracks(img, uv, track_cnt, vel)
        path = os.path.join(self.dir, f"track_{self._k - 1:06d}.png")
        write_png_gray(path, out)
        return path

    def match_image(self, img_cur, uv_cur, img_old, uv_old, tag):
        if not self.enabled:
            return None
        out = draw_match_image(img_cur, uv_cur, img_old, uv_old)
        path = os.path.join(self.dir, f"match_{tag}.png")
        write_png_gray(path, out)
        return path
