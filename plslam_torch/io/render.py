"""Synthetic image rendering + EuRoC-format dataset writer.

Counterpart of `plslam/io/render.py`: renders the simulator's world
(landmark stamps at their projections + anti-aliased line segments) and
writes a miniature ASL-layout dataset (`mav0/cam0/data.csv` + PNGs,
`mav0/imu0/data.csv`, ground truth), so `runner.run_euroc` exercises the
whole image pipeline without any dataset on disk.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from plslam_torch.io.synthetic import SyntheticSequence
from plslam_torch.ops.cameras import cam_to, normalized_to_pixel

_STAMP_CACHE: dict = {}


def _landmark_stamps(n: int, r: int, sigma: float, style: str = "gaussian") -> np.ndarray:
    """Per-landmark stamps: "gaussian" isotropic blobs, or "textured" — a
    checkerboard corner at the center inside unique band-limited noise."""
    key = (n, r, round(sigma, 3), style)
    if key in _STAMP_CACHE:
        return _STAMP_CACHE[key]
    rng = np.random.default_rng(1234)
    size = 2 * r + 1
    ys, xs = np.meshgrid(np.arange(size) - r, np.arange(size) - r, indexing="ij")
    gwin = np.exp(-((xs**2 + ys**2) / (2.0 * sigma**2))).astype(np.float32)
    amps = (0.35 + 0.45 * rng.random(n)) * rng.choice([-1.0, 1.0], n)
    if style == "gaussian":
        stamps = (amps[:, None, None] * gwin[None]).astype(np.float32)
        _STAMP_CACHE[key] = stamps
        return stamps
    noise = rng.standard_normal((n, size, size)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for _ in range(2):
        noise = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1,
                                    noise.reshape(-1, size)).reshape(n, size, size)
        noise = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1,
                                    noise.transpose(0, 2, 1).reshape(-1, size)
                                    ).reshape(n, size, size).transpose(0, 2, 1)
    noise = noise / (np.abs(noise).max(axis=(1, 2), keepdims=True) + 1e-9)
    quad = np.sign(xs + 0.5)[None] * np.sign(ys + 0.5)[None] * rng.choice([-1.0, 1.0], n)[:, None, None]
    cwin = np.exp(-((xs**2 + ys**2) / (2.0 * max(0.55 * sigma, 2.2) ** 2))).astype(np.float32)
    rr2 = (xs**2 + ys**2).astype(np.float32)
    nwin = np.exp(-rr2 / (2.0 * (0.60 * r) ** 2)).astype(np.float32)
    nwin = nwin * np.clip((np.sqrt(rr2) - 3.0) / 2.5, 0.0, 1.0)
    pattern = 1.0 * quad * cwin[None] + 0.8 * noise * nwin[None]
    stamps = (amps[:, None, None] * 1.3 * pattern).astype(np.float32)
    _STAMP_CACHE[key] = stamps
    return stamps


def _to_pixel(cam, mn) -> np.ndarray:
    cam32 = cam_to(cam, torch.float32, torch.device("cpu"))
    uv = normalized_to_pixel(cam32, torch.as_tensor(np.asarray(mn), dtype=torch.float32))
    return uv.numpy().astype(np.float64)


def render_frame(seq: SyntheticSequence, k: int, cam, h: int, w: int,
                 blob_sigma=2.0, style: str = "gaussian") -> np.ndarray:
    """Render frame k: background gradient + landmark stamps + line segments."""
    img = np.full((h, w), 0.35, np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img += 0.08 * np.sin(3 * xx) * np.cos(2 * yy)

    obs = np.asarray(seq.obs[k])
    vis = np.asarray(seq.obs_valid[k])
    uv = _to_pixel(cam, obs)
    r = int(3 * blob_sigma) if style == "gaussian" else max(int(3 * blob_sigma), 16)
    stamps = _landmark_stamps(obs.shape[0], r, blob_sigma, style)
    for li in np.nonzero(vis)[0]:
        cx, cy = uv[li]
        if not (r < cx < w - r and r < cy < h - r):
            continue
        # subpixel placement: bilinear-shift the stamp by the fractional part
        x0, y0 = int(np.floor(cx)) - r, int(np.floor(cy)) - r
        fx, fy = cx - np.floor(cx), cy - np.floor(cy)
        s = stamps[li]
        s = (1 - fx) * s + fx * np.roll(s, 1, axis=1)
        s = (1 - fy) * s + fy * np.roll(s, 1, axis=0)
        img[y0: y0 + 2 * r + 1, x0: x0 + 2 * r + 1] += s

    lobs = np.asarray(seq.line_obs[k])
    lvis = np.asarray(seq.line_obs_valid[k])
    sp = _to_pixel(cam, lobs[:, 0:2])
    ep = _to_pixel(cam, lobs[:, 2:4])
    ygrid, xgrid = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                               indexing="ij")
    for li in np.nonzero(lvis)[0]:
        p0, p1 = sp[li], ep[li]
        d = p1 - p0
        L = np.linalg.norm(d)
        if L < 5:
            continue
        u = d / L
        xlo = int(max(0, min(p0[0], p1[0]) - 2))
        xhi = int(min(w, max(p0[0], p1[0]) + 3))
        ylo = int(max(0, min(p0[1], p1[1]) - 2))
        yhi = int(min(h, max(p0[1], p1[1]) + 3))
        if xhi <= xlo or yhi <= ylo:
            continue
        px = xgrid[ylo:yhi, xlo:xhi] - p0[0]
        py = ygrid[ylo:yhi, xlo:xhi] - p0[1]
        t = px * u[0] + py * u[1]
        dist = np.abs(-px * u[1] + py * u[0])
        on = (t > 0) & (t < L)
        img[ylo:yhi, xlo:xhi] += 0.45 * (np.clip(1.4 - dist, 0.0, 1.0) * on).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def write_png_gray(path: str, img01: np.ndarray):
    """Minimal 8-bit grayscale PNG writer (filter 0)."""
    u8 = (np.clip(img01, 0, 1) * 255).astype(np.uint8)
    h, w = u8.shape
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))

    def chunk(typ, data):
        c = struct.pack(">I", len(data)) + typ + data
        return c + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def write_euroc_dataset(seq: SyntheticSequence, out_dir: str, cam, h: int, w: int,
                        max_frames: int | None = None, blob_sigma: float = 2.0,
                        style: str = "gaussian"):
    """Write the simulator sequence as a miniature EuRoC ASL dataset."""
    mav = os.path.join(out_dir, "mav0")
    os.makedirs(os.path.join(mav, "cam0", "data"), exist_ok=True)
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"), exist_ok=True)

    imu_t = np.asarray(seq.imu_t)
    gyr, acc = np.asarray(seq.imu_gyr), np.asarray(seq.imu_acc)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#t,wx,wy,wz,ax,ay,az\n")
        for i in range(len(imu_t)):
            g, a = gyr[i], acc[i]
            f.write(f"{int(imu_t[i]*1e9)},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}\n")

    frame_t = np.asarray(seq.frame_t)
    n = len(frame_t) if max_frames is None else min(max_frames, len(frame_t))
    with open(os.path.join(mav, "cam0", "data.csv"), "w") as f:
        f.write("#t,filename\n")
        for k in range(n):
            ns = int(frame_t[k] * 1e9)
            name = f"{ns}.png"
            img = render_frame(seq, k, cam, h, w, blob_sigma=blob_sigma, style=style)
            write_png_gray(os.path.join(mav, "cam0", "data", name), img)
            f.write(f"{ns},{name}\n")

    gp, gq, gv = np.asarray(seq.gt_p), np.asarray(seq.gt_q), np.asarray(seq.gt_v)
    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#t,px,py,pz,qw,qx,qy,qz,vx,vy,vz\n")
        for k in range(len(frame_t)):
            p, q, v = gp[k], gq[k], gv[k]
            f.write(f"{int(frame_t[k]*1e9)},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]},"
                    f"{v[0]},{v[1]},{v[2]}\n")
    return out_dir
