"""The traffic generator: a synthetic EuRoC-layout recording made from a
recipe (`traffic/<mix>.json`) and `--seed`.

A frozen copy of the port's simulator and renderer (`io/synthetic.py`,
`io/render.py`), written against plain torch so that it imports nothing of
the program: a C-infinity trajectory (circle + vertical wave + decaying
preamble + persistent excitation), exact body-frame IMU from forward-mode
derivatives with EuRoC-class noise and biases, landmarks and line segments
on a cylinder shell, and 752x480 frames of textured landmark stamps and
anti-aliased segments. Frames are rendered in torch on the given device and
written as 8-bit PNGs by a pool of threads.

The recipe's `layout_seed` places the landmarks and segments, so every run
of a mix sees the same frames and does the same tracking work; `--seed`
draws the IMU's biases and noise. The frames are rendered once into
`<cache>/<recipe hash>/` and each seed's recording is a folder beside them
(`seed-<n>/`: its own `mav0/imu0/data.csv`, the frames linked), reused when
it is there; the cache keeps the newest few of each.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

G_WORLD = (0.0, 0.0, 9.81007)
# body_T_cam of the simulated rig: the camera looks along body +x
R_BC = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
P_BC = (0.05, 0.02, 0.0)
TRAJECTORY_DEFAULTS = dict(radius=4.0, omega=0.6, z_amp=0.6, z_omega=1.1, pitch_amp=0.12,
                           roll_amp=0.1, wiggle_amp=0.0, wiggle_omega=5.0, wiggle_tau=1.5,
                           excite_amp=0.0, excite_omega=3.1)
KEEP_SCENES = 2  # renders kept in the cache
KEEP_SEEDS = 8  # seed folders kept beside each render
VERSION = 2  # bump when the generator's output changes


def _ypr_to_rot(y, p, r):
    cy, sy, cp, sp, cr, sr = (torch.cos(y), torch.sin(y), torch.cos(p), torch.sin(p),
                              torch.cos(r), torch.sin(r))
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1)], -2)


def _rot_to_quat(R):
    """Rotation matrices [...,3,3] → unit quaternions [w,x,y,z], w ≥ 0."""
    R = np.asarray(R, np.float64)
    m = R.reshape(-1, 3, 3)
    t = np.stack([1 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2], 1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                  1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2], 1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]], -1)
    qs = np.stack([
        np.stack([t[:, 0], m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0], m[:, 1, 0] - m[:, 0, 1]], -1),
        np.stack([m[:, 2, 1] - m[:, 1, 2], t[:, 1], m[:, 0, 1] + m[:, 1, 0], m[:, 0, 2] + m[:, 2, 0]], -1),
        np.stack([m[:, 0, 2] - m[:, 2, 0], m[:, 0, 1] + m[:, 1, 0], t[:, 2], m[:, 1, 2] + m[:, 2, 1]], -1),
        np.stack([m[:, 1, 0] - m[:, 0, 1], m[:, 0, 2] + m[:, 2, 0], m[:, 1, 2] + m[:, 2, 1], t[:, 3]], -1)], 1)
    q = qs[np.arange(len(m)), np.argmax(t, -1)]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    q = q * np.where(q[:, :1] < 0, -1.0, 1.0)
    return q.reshape(*R.shape[:-2], 4)


def _pos_fn(tp):
    def pos(t):
        p = torch.stack([tp["radius"] * torch.cos(tp["omega"] * t),
                         tp["radius"] * torch.sin(tp["omega"] * t),
                         tp["z_amp"] * torch.sin(tp["z_omega"] * t) + 1.5], -1)
        if tp["wiggle_amp"] != 0.0:
            wo = tp["wiggle_omega"]
            env = (tp["wiggle_amp"] * torch.exp(-t / tp["wiggle_tau"]))[..., None]
            p = p + env * torch.stack([torch.sin(wo * t), torch.sin(1.31 * wo * t + 0.7),
                                       torch.sin(0.73 * wo * t + 1.4)], -1)
        if tp["excite_amp"] != 0.0:
            eo = tp["excite_omega"]
            p = p + tp["excite_amp"] * torch.stack([torch.sin(eo * t + 0.3),
                                                    torch.sin(1.27 * eo * t + 2.1),
                                                    torch.sin(0.81 * eo * t + 0.9)], -1)
        return p

    return pos


def _rot_fn(tp):
    def rot(t):  # yaw follows the tangent
        return _ypr_to_rot(tp["omega"] * t + np.pi / 2.0,
                           tp["pitch_amp"] * torch.sin(0.9 * tp["omega"] * t),
                           tp["roll_amp"] * torch.cos(1.3 * tp["omega"] * t))

    return rot


def _d_dt(fn, t):
    return torch.func.jvp(fn, (t,), (torch.ones_like(t),))[1]


def make_world(recipe: dict, seed: int) -> dict:
    """The simulated recording as numpy arrays (float64): IMU stream, frame
    times, ground truth, normalized point and segment observations. The
    IMU's biases and noise are drawn from `seed`, the layout from the
    recipe's `layout_seed`."""
    sc = recipe["scene"]
    tp = {**TRAJECTORY_DEFAULTS, **sc["trajectory"]}
    rng = np.random.default_rng(seed)
    lay = np.random.default_rng(sc["layout_seed"])
    duration, n_pts, n_lines = sc["duration_s"], sc["n_points"], sc["n_lines"]
    imu_hz, cam_hz = sc["imu_hz"], sc["cam_hz"]
    T = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64)  # noqa: E731
    R_bc, p_bc = np.asarray(R_BC), np.asarray(P_BC)

    imu_t = np.arange(0.0, duration + 0.5 / imu_hz, 1.0 / imu_hz)
    frame_t = np.arange(0.0, duration, 1.0 / cam_hz)
    pos, rot = _pos_fn(tp), _rot_fn(tp)
    ti = T(imu_t)
    a = _d_dt(lambda s: _d_dt(pos, s), ti)
    R = rot(ti)
    Om = R.transpose(-1, -2) @ _d_dt(rot, ti)
    gyr = torch.stack([Om[..., 2, 1], Om[..., 0, 2], Om[..., 1, 0]], -1).numpy()
    acc = torch.einsum("mji,mj->mi", R, a + T(G_WORLD)).numpy()
    n = sc["imu_noise"]
    ba = n["acc_bias"] * rng.standard_normal(3)
    bg = n["gyr_bias"] * rng.standard_normal(3)
    acc = acc + ba + n["acc_noise"] * rng.standard_normal((len(imu_t), 3))
    gyr = gyr + bg + n["gyr_noise"] * rng.standard_normal((len(imu_t), 3))

    tf = T(frame_t)
    gt_p = pos(tf)
    R_wb = rot(tf)
    gt_v = _d_dt(pos, tf)

    r0 = tp["radius"]
    theta = lay.uniform(0, 2 * np.pi, n_pts)
    rad = r0 + lay.uniform(2.0, 6.0, n_pts)
    zs = lay.uniform(-1.5, 4.0, n_pts)
    landmarks = np.stack([rad * np.cos(theta), rad * np.sin(theta), zs], -1)
    theta_l = lay.uniform(0, 2 * np.pi, n_lines)
    rad_l = r0 + lay.uniform(2.0, 6.0, n_lines)
    z0 = lay.uniform(-1.0, 3.0, n_lines)
    vert = lay.uniform(size=n_lines) < 0.6
    dtheta = np.where(vert, 0.0, lay.uniform(0.05, 0.25, n_lines))
    dz = np.where(vert, lay.uniform(0.8, 2.5, n_lines), lay.uniform(-0.3, 0.3, n_lines))
    line_sp = np.stack([rad_l * np.cos(theta_l), rad_l * np.sin(theta_l), z0], -1)
    line_ep = np.stack([rad_l * np.cos(theta_l + dtheta), rad_l * np.sin(theta_l + dtheta),
                        z0 + dz], -1)

    R_wc = R_wb @ T(R_bc)
    p_wc = gt_p + torch.einsum("fij,j->fi", R_wb, T(p_bc))
    cam = recipe["camera"]
    fx, cx, cy, w, h = cam["fx"], cam["cx"], cam["cy"], cam["width"], cam["height"]

    def cam_points(pts):
        return torch.einsum("flj,fji->fli", T(pts)[None] - p_wc[:, None], R_wc)

    def in_img(pc):
        z = torch.clamp(pc[..., 2], min=1e-12)
        u, v = fx * pc[..., 0] / z + cx, fx * pc[..., 1] / z + cy
        return (u > 5) & (u < w - 5) & (v > 5) & (v < h - 5)

    pc = cam_points(landmarks)
    obs = pc[..., :2] / torch.clamp(pc[..., 2:3], min=1e-6)
    obs_valid = (pc[..., 2] > 0.3) & in_img(pc)
    pcs, pce = cam_points(line_sp), cam_points(line_ep)
    line_obs = torch.cat([pcs[..., :2] / torch.clamp(pcs[..., 2:3], min=1e-6),
                          pce[..., :2] / torch.clamp(pce[..., 2:3], min=1e-6)], -1)
    line_valid = (pcs[..., 2] > 0.3) & (pce[..., 2] > 0.3) & in_img(pcs) & in_img(pce)
    return dict(imu_t=imu_t, acc=acc, gyr=gyr, frame_t=frame_t, gt_p=gt_p.numpy(),
                gt_q=_rot_to_quat(R_wb.numpy()), gt_v=gt_v.numpy(), obs=obs.numpy(),
                obs_valid=obs_valid.numpy(), line_obs=line_obs.numpy(),
                line_valid=line_valid.numpy(), R_bc=R_bc, p_bc=p_bc)


def landmark_stamps(n: int, r: int, sigma: float) -> np.ndarray:
    """The "textured" stamps: a checkerboard corner inside band-limited
    noise, one per landmark, fixed for every seed."""
    rng = np.random.default_rng(1234)
    size = 2 * r + 1
    ys, xs = np.meshgrid(np.arange(size) - r, np.arange(size) - r, indexing="ij")
    amps = (0.35 + 0.45 * rng.random(n)) * rng.choice([-1.0, 1.0], n)
    noise = rng.standard_normal((n, size, size)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for _ in range(2):
        noise = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1,
                                    noise.reshape(-1, size)).reshape(n, size, size)
        noise = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1,
                                    noise.transpose(0, 2, 1).reshape(-1, size)
                                    ).reshape(n, size, size).transpose(0, 2, 1)
    noise = noise / (np.abs(noise).max(axis=(1, 2), keepdims=True) + 1e-9)
    quad = (np.sign(xs + 0.5)[None] * np.sign(ys + 0.5)[None]
            * rng.choice([-1.0, 1.0], n)[:, None, None])
    cwin = np.exp(-((xs ** 2 + ys ** 2) / (2.0 * max(0.55 * sigma, 2.2) ** 2))).astype(np.float32)
    rr2 = (xs ** 2 + ys ** 2).astype(np.float32)
    nwin = np.exp(-rr2 / (2.0 * (0.60 * r) ** 2)).astype(np.float32)
    nwin = nwin * np.clip((np.sqrt(rr2) - 3.0) / 2.5, 0.0, 1.0)
    pattern = 1.0 * quad * cwin[None] + 0.8 * noise * nwin[None]
    return (amps[:, None, None] * 1.3 * pattern).astype(np.float32)


class Renderer:
    """Frames of the world in torch on `device`: a background gradient, the
    landmark stamps shifted bilinearly to their sub-pixel projections, and
    anti-aliased segments. Returns uint8 [H,W] arrays."""

    def __init__(self, world: dict, recipe: dict, device):
        cam, sc = recipe["camera"], recipe["scene"]
        self.h, self.w = cam["height"], cam["width"]
        self.fx, self.cx, self.cy = cam["fx"], cam["cx"], cam["cy"]
        self.dev = torch.device(device)
        self.world = world
        sigma = sc["blob_sigma"]
        self.r = max(int(3 * sigma), 16)
        self.stamps = torch.as_tensor(landmark_stamps(world["obs"].shape[1], self.r, sigma),
                                      device=self.dev)
        yy, xx = torch.meshgrid(torch.linspace(0, 1, self.h, dtype=torch.float64),
                                torch.linspace(0, 1, self.w, dtype=torch.float64), indexing="ij")
        self.bg = (0.35 + 0.08 * torch.sin(3 * xx) * torch.cos(2 * yy)).float().to(self.dev)
        self.ygrid = torch.arange(self.h, dtype=torch.float64, device=self.dev)[:, None]
        self.xgrid = torch.arange(self.w, dtype=torch.float64, device=self.dev)[None, :]
        size = 2 * self.r + 1
        self.offs = torch.arange(size, device=self.dev)

    def _px(self, mn):
        # float32 pixel coordinates, as the port's camera maps them
        mn = torch.as_tensor(mn, dtype=torch.float32)
        return torch.stack([self.fx * mn[..., 0] + self.cx, self.fx * mn[..., 1] + self.cy],
                           -1).double()

    def frame(self, k: int) -> torch.Tensor:
        w, h, r = self.w, self.h, self.r
        img = self.bg.clone()
        vis = np.nonzero(self.world["obs_valid"][k])[0]
        uv = self._px(self.world["obs"][k][vis])
        ok = (uv[:, 0] > r) & (uv[:, 0] < w - r) & (uv[:, 1] > r) & (uv[:, 1] < h - r)
        vis, uv = vis[ok.numpy()], uv[ok]
        if len(vis):
            fl = torch.floor(uv)
            frac = (uv - fl).float().to(self.dev)
            x0 = (fl[:, 0].long() - r).to(self.dev)
            y0 = (fl[:, 1].long() - r).to(self.dev)
            s = self.stamps[torch.as_tensor(vis, device=self.dev)]
            fx, fy = frac[:, 0, None, None], frac[:, 1, None, None]
            s = (1 - fx) * s + fx * torch.roll(s, 1, dims=2)
            s = (1 - fy) * s + fy * torch.roll(s, 1, dims=1)
            rows = (y0[:, None] + self.offs)[:, :, None].expand_as(s)
            cols = (x0[:, None] + self.offs)[:, None, :].expand_as(s)
            img.index_put_((rows.reshape(-1), cols.reshape(-1)), s.reshape(-1), accumulate=True)
        lvis = np.nonzero(self.world["line_valid"][k])[0]
        if len(lvis):
            lo = self.world["line_obs"][k][lvis]
            p0, p1 = self._px(lo[:, :2]), self._px(lo[:, 2:4])
            d = p1 - p0
            L = torch.linalg.norm(d, dim=-1)
            keep = L >= 5
            p0, p1, d, L = p0[keep], p1[keep], d[keep], L[keep]
            for i in range(len(L)):
                u = (d[i] / L[i]).tolist()
                a, b = p0[i].tolist(), p1[i].tolist()
                xlo, xhi = int(max(0, min(a[0], b[0]) - 2)), int(min(w, max(a[0], b[0]) + 3))
                ylo, yhi = int(max(0, min(a[1], b[1]) - 2)), int(min(h, max(a[1], b[1]) + 3))
                if xhi <= xlo or yhi <= ylo:
                    continue
                px = self.xgrid[:, xlo:xhi] - a[0]
                py = self.ygrid[ylo:yhi] - a[1]
                t = px * u[0] + py * u[1]
                dist = torch.abs(-px * u[1] + py * u[0])
                on = (t > 0) & (t < float(L[i]))
                img[ylo:yhi, xlo:xhi] += 0.45 * (torch.clamp(1.4 - dist, 0.0, 1.0) * on).float()
        return (torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8)


def write_png(path: str, u8: np.ndarray):
    """8-bit grayscale PNG (filter 0, zlib level 1)."""
    h, w = u8.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), u8], axis=1).tobytes()

    def chunk(typ, data):
        c = struct.pack(">I", len(data)) + typ + data
        return c + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF)

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def recipe_key(recipe: dict) -> str:
    src = open(os.path.abspath(__file__), "rb").read()
    h = hashlib.sha256(json.dumps([recipe["scene"], recipe["camera"], VERSION],
                                  sort_keys=True).encode() + src)
    return h.hexdigest()[:12]


def _ns(t: float) -> int:
    return int(round(t * 1e9))


def write_frames(world: dict, recipe: dict, out: str, device, threads: int = 8):
    """The frames and the ground truth under `out` (written to a sibling and
    renamed into place, so a cut run leaves no half render)."""
    tmp = out + ".part"
    shutil.rmtree(tmp, ignore_errors=True)
    mav = os.path.join(tmp, "mav0")
    for d in ("cam0/data", "state_groundtruth_estimate0"):
        os.makedirs(os.path.join(mav, d), exist_ok=True)
    ft = world["frame_t"]
    gt = np.concatenate([np.asarray([_ns(t) for t in ft], np.float64)[:, None], world["gt_p"],
                         world["gt_q"], world["gt_v"]], 1)
    np.savetxt(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"), gt, delimiter=",",
               fmt=["%d"] + ["%.17g"] * 10, header="t,px,py,pz,qw,qx,qy,qz,vx,vy,vz")
    names = [f"{_ns(t)}.png" for t in ft]
    with open(os.path.join(mav, "cam0", "data.csv"), "w") as fh:
        fh.write("#t,filename\n")
        fh.writelines(f"{_ns(t)},{n}\n" for t, n in zip(ft, names))
    ren = Renderer(world, recipe, device)
    with ThreadPoolExecutor(max_workers=threads) as pool:
        futs = []
        for k, name in enumerate(names):
            u8 = ren.frame(k).cpu().numpy()
            futs.append(pool.submit(write_png, os.path.join(mav, "cam0", "data", name), u8))
        for f in futs:
            f.result()
    np.savez(os.path.join(tmp, "truth.npz"), frame_t=ft, gt_p=world["gt_p"], gt_q=world["gt_q"],
             R_bc=world["R_bc"], p_bc=world["p_bc"])
    shutil.rmtree(out, ignore_errors=True)
    os.rename(tmp, out)


def write_imu(world: dict, render: str, out: str):
    """A seed's recording: its IMU stream, the render's frames and truth
    linked."""
    tmp = out + ".part"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "mav0", "imu0"))
    imu = np.concatenate([np.asarray([_ns(t) for t in world["imu_t"]], np.float64)[:, None],
                          world["gyr"], world["acc"]], 1)
    np.savetxt(os.path.join(tmp, "mav0", "imu0", "data.csv"), imu, delimiter=",",
               fmt=["%d"] + ["%.17g"] * 6, header="t,wx,wy,wz,ax,ay,az")
    for rel in ("mav0/cam0", "mav0/state_groundtruth_estimate0", "truth.npz"):
        os.symlink(os.path.join(render, rel), os.path.join(tmp, rel))
    shutil.rmtree(out, ignore_errors=True)
    os.rename(tmp, out)


def _evict(folder: str, keep: int, prefix: str = ""):
    old = sorted((os.path.join(folder, d) for d in os.listdir(folder)
                  if d.startswith(prefix) and not d.endswith(".part")), key=os.path.getmtime)
    for d in old[:-keep]:
        shutil.rmtree(d, ignore_errors=True)


def recording(recipe: dict, seed: int, cache: str, device) -> tuple[str, bool]:
    """(path of the recording of `recipe` at `seed`, whether its frames were
    in the cache). Renders what is not there; keeps the newest few."""
    os.makedirs(cache, exist_ok=True)
    render = os.path.abspath(os.path.join(cache, recipe_key(recipe)))
    path = os.path.join(render, f"seed-{seed}")
    cached = os.path.exists(os.path.join(render, "truth.npz"))
    if cached and os.path.exists(os.path.join(path, "mav0", "imu0", "data.csv")):
        os.utime(render)
        os.utime(path)
        return path, True
    world = make_world(recipe, seed)
    if not cached:
        write_frames(world, recipe, render, device)
        _evict(cache, KEEP_SCENES)
    os.utime(render)
    write_imu(world, render, path)
    _evict(render, KEEP_SEEDS, "seed-")
    return path, cached
