"""Chip smoke test of the PyTorch / CUDA port (`plslam_torch`) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU fallback):
  1. card name and power limit (nvidia-smi), torch version; CUDA required.
  2. build the LK kernel from `plslam_torch/csrc/*.cu`; print the build time.
  3. the LK kernel against its plain PyTorch version on the card at the main
     path's shapes (752×480 shifted texture, 4-level pyramid, 150 features):
     positions within 1e-3 px, status equal away from the err gate; times
     per frame of both, by CUDA events after a warm-up.
  4. render the `scripts/system_fps.py` dataset recipe with the port's
     simulator (cached in the temp directory), then run the port's
     `run_euroc(use_lines=False, loop_closure=False, device="cuda")` with the
     reference capacities. Requires: initialized, ≥ 40 frames emitted, LK
     launches = levels × tracked frames, yaw-aligned ATE < 0.4 m. Then the
     first 24 published frames again under `torch.profiler`: the device's
     busy share of that run and the kernels that fill it.
  5. one JSON line of kernel results, then the last line
     {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W, F = 480, 752, 460.0
N_FEATURES = 150
LEVELS = 4
ERR_GATE = 0.12
POS_TOL_PX = 1e-3
DURATION = 12.0  # seconds of camera frames rendered
ATE_LIMIT_M = 0.4
LK_SOURCE = "plslam_torch/csrc/lk.cu"
LK_REPLACES = "plslam/ops/kernels/lk.py:120"


def log(msg):
    print(msg, flush=True)


def card_info():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def shifted_texture(rng, h, w, dx, dy, sigma=3.0):
    """A smooth random texture and its bilinear shift by (dx, dy)."""
    img = rng.standard_normal((h, w))
    k = np.exp(-0.5 * (np.arange(-7, 8) / sigma) ** 2)
    k /= k.sum()
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    img = np.ascontiguousarray((img - img.min()) / (img.max() - img.min()), np.float32)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    sx = np.clip(xs - dx, 0, w - 1.001)
    sy = np.clip(ys - dy, 0, h - 1.001)
    x0, y0 = sx.astype(int), sy.astype(int)
    fx, fy = sx - x0, sy - y0
    img2 = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    return img, img2.astype(np.float32)


def cuda_time_ms(fn, reps=50, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_lk_kernel(dev):
    """Phase 3: kernel vs plain version on the card at the main path's shapes."""
    import torch

    from plslam_torch.models.frontend_points import build_pyramid, shi_tomasi_grid
    from plslam_torch.ops.kernels import lk

    rng = np.random.default_rng(0)
    dx, dy = 3.7, -2.3
    img1, img2 = shifted_texture(rng, H, W, dx, dy)
    pyr1 = build_pyramid(torch.as_tensor(img1, device=dev), levels=LEVELS)
    pyr2 = build_pyramid(torch.as_tensor(img2, device=dev), levels=LEVELS)
    uv, score = shi_tomasi_grid(pyr1[0], torch.zeros((1, 2), device=dev),
                                torch.zeros((1,), device=dev), cell=30, max_out=N_FEATURES)
    # the detector's corners plus points at every border (padding / clamp paths)
    pts = uv.clone()
    pts[-6:] = torch.tensor([[4.2, 120.3], [W - 3.3, 60.1], [160.5, 2.6], [200.4, H - 2.8],
                             [11.3, 11.8], [W - 11.0, H - 10.6]], device=dev)
    valid = torch.ones(N_FEATURES, dtype=torch.bool, device=dev)

    worst = 0.0
    for level in range(LEVELS):  # every level's launch against the plain version
        s = 2.0 ** level
        args = (pyr1[level], pyr2[level], pts / s, pts / s + 0.5)
        ko, ke = lk.lk_level_cuda(*args)
        po, pe = lk.lk_level_torch(*args)
        torch.cuda.synchronize()
        good = (ke < 1e8) & (pe < 1e8) & (ke < 1.0)
        d = (ko - po).abs().amax(dim=1)[good]
        d = float(d.max()) if d.numel() else 0.0
        worst = max(worst, d)
        ms = cuda_time_ms(lambda: lk.lk_level_cuda(*args))
        plain_ms = cuda_time_ms(lambda: lk.lk_level_torch(*args))
        log(f"  level {level} ({tuple(pyr1[level].shape)}): max |Δpos| {d:.3e} px "
            f"over {int(good.sum())} features; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    k_out, k_st = lk.lk_track(pyr1, pyr2, pts, valid)
    p_out, p_st = lk.lk_track_torch(pyr1, pyr2, pts, valid)
    torch.cuda.synchronize()
    both = k_st & p_st
    diff = float((k_out - p_out).abs().amax(dim=1)[both].max())
    _, err = lk.lk_level_torch(pyr1[0], pyr2[0], pts, k_out, 0)
    near_gate = (err - ERR_GATE).abs() < 1e-4
    status_ok = bool(torch.equal(k_st[~near_gate], p_st[~near_gate]))
    sel = k_st[:-6]  # the detector's corners (the border points have no GT flow)
    flow = (k_out - pts)[:-6][sel]
    flow_err = float((flow - torch.tensor([dx, dy], device=dev)).norm(dim=1).median())
    worst = max(worst, diff)
    log(f"  full track: max |Δpos| {diff:.3e} px over {int(both.sum())}/{N_FEATURES} tracked; "
        f"status equal away from the gate: {status_ok}; median flow error {flow_err:.4f} px")
    if not (worst <= POS_TOL_PX and status_ok and flow_err < 0.3 and int(both.sum()) > 100):
        raise AssertionError(f"LK kernel disagrees with its plain version: max |Δpos| {worst:.3e} px, "
                             f"status equal {status_ok}, flow error {flow_err:.4f} px")

    ms = cuda_time_ms(lambda: lk.lk_track(pyr1, pyr2, pts, valid))
    plain_ms = cuda_time_ms(lambda: lk.lk_track_torch(pyr1, pyr2, pts, valid))
    log(f"  time per frame ({LEVELS} levels, {N_FEATURES} features): kernel {ms:.4f} ms, "
        f"plain torch {plain_ms:.4f} ms")
    return worst, ms, plain_ms


TRAJECTORY = dict(omega=0.4, z_omega=0.7, wiggle_amp=0.15, excite_amp=0.1)
SEQUENCE = dict(duration=DURATION, n_points=500, n_lines=40, seed=17,
                acc_noise=0.1, gyr_noise=0.005, acc_bias=0.05, gyr_bias=0.002)
RENDER = dict(h=H, w=W, max_frames=int(DURATION * 20), blob_sigma=3.0, style="textured")


def dataset_key():
    """A hash of the recipe and of the simulator's and renderer's sources."""
    import plslam_torch.io as io_pkg

    h = hashlib.sha256(json.dumps([TRAJECTORY, SEQUENCE, RENDER, F], sort_keys=True).encode())
    io_dir = os.path.dirname(os.path.abspath(io_pkg.__file__))
    for name in sorted(os.listdir(io_dir)):
        if name.endswith(".py"):
            with open(os.path.join(io_dir, name), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def render_dataset():
    """The `scripts/system_fps.py` recipe, rendered with the port's simulator
    into a cache keyed by `dataset_key()`."""
    from plslam_torch.io import render, synthetic
    from plslam_torch.ops.cameras import PinholeRadTan
    from plslam_torch.utils.geometry import quat_to_rot

    cache = os.path.join(tempfile.gettempdir(), f"plslam_torch_fps_ds_{dataset_key()}")
    meta = os.path.join(cache, "meta.npz")
    if os.path.exists(meta):
        return cache, 0.0
    t0 = time.perf_counter()
    seq = synthetic.make_sequence(params=synthetic.TrajectoryParams(**TRAJECTORY), **SEQUENCE)
    cam = PinholeRadTan.create(F, F, W / 2, H / 2)
    os.makedirs(cache, exist_ok=True)
    render.write_euroc_dataset(seq, cache, cam, **RENDER)
    np.savez(meta, R_bc=quat_to_rot(seq.q_bc).numpy(), p_bc=seq.p_bc.numpy(),
             gt_t=seq.frame_t.numpy(), gt_p=seq.gt_p.numpy())
    return cache, time.perf_counter() - t0


def smoke_config(meta):
    from plslam_torch.config import (CameraConfig, ExtrinsicConfig, LoopConfig, PLSlamConfig,
                                     SolverConfig, TrackerConfig)

    return PLSlamConfig(
        camera=CameraConfig(image_width=W, image_height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                            k1=0, k2=0, p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=150, min_dist=30, equalize=True, min_score=2e-3),
        solver=SolverConfig(max_features=192, window_size=10, max_num_iterations=8,
                            dtype="float32", focal_length=F),
        extrinsic=ExtrinsicConfig(0, tuple(meta["R_bc"].reshape(-1)), tuple(meta["p_bc"])),
        loop=LoopConfig(loop_closure=False),
    )


def profile_short_run(dev, frames):
    """The first `frames` published frames of phase 4 under torch.profiler:
    the device's busy share of the wall time and the kernels that fill it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plslam_torch import runner

    path, _ = render_dataset()
    cfg = smoke_config(np.load(os.path.join(path, "meta.npz")))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run_euroc(path, cfg, max_frames=frames, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = 1e-6 * sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    log(f"  profiled {frames} published frames: wall {wall:.3f} s (profiler on), device busy "
        f"{busy_s:.3f} s = {100 * busy_s / wall:.1f} %, {launches} device ops")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in top[:12] + [e for e in top[12:] if "lk_level_kernel" in e.key]:
        log(f"    {e.self_device_time_total / 1e3:9.1f} ms  {e.count:7d}×  "
            f"{e.self_device_time_total / e.count:8.2f} µs each  {e.key[:80]}")


def run_main_path(dev):
    """Phase 4: the port's streaming points-only pipeline on the rendered set."""
    import torch

    from plslam_torch import runner
    from plslam_torch.eval.metrics import ate_rmse
    from plslam_torch.ops.kernels import lk

    path, render_s = render_dataset()
    log(f"  dataset: {path} (rendered in {render_s:.1f} s)")
    meta = np.load(os.path.join(path, "meta.npz"))
    cfg = smoke_config(meta)
    n_cam = len(os.listdir(os.path.join(path, "mav0", "cam0", "data")))
    lk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, ps, qs, est, _ = runner.run_euroc(path, cfg, use_lines=False, loop_closure=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lk.LAUNCHES
    if not est.initialized:
        raise AssertionError("the estimator did not initialize")
    if len(ts) < 40 or not np.all(np.isfinite(ps)) or np.asarray(ps).shape[1:] != (3,):
        raise AssertionError(f"expected ≥ 40 finite [3] positions, got {np.asarray(ps).shape}")
    expected = LEVELS * (n_cam - 1)
    if launches != expected:
        raise AssertionError(f"LK launches {launches} != {LEVELS} levels × {n_cam - 1} tracked frames")
    ate = float(ate_rmse(ts, ps, meta["gt_t"], meta["gt_p"], align="yaw"))
    n_solved = sum(1 for m in est.metrics if "cost" in m)
    log(f"  run_euroc: {n_cam} camera frames, {len(ts)} emitted, {n_solved} solved in {wall:.2f} s "
        f"= {n_cam / wall:.2f} camera frames/s; LK launches {launches}; ATE(yaw) {ate:.4f} m")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate:.4f} m ≥ {ATE_LIMIT_M} m")
    return launches, ate, n_cam / wall


def main():
    import torch

    log(card_info())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    dev = torch.device("cuda", 0)

    from plslam_torch.ops.kernels import lk

    log("phase 2: build the LK kernel")
    t0 = time.perf_counter()
    so = lk.build()
    log(f"  built {os.path.relpath(so)} in {time.perf_counter() - t0:.1f} s")
    with open(so + ".log") as fh:
        for line in fh.read().strip().splitlines():
            log(f"  nvcc: {line}")

    log("phase 3: LK kernel vs plain version on the card")
    err, ms, plain_ms = check_lk_kernel(dev)

    log("phase 4: run_euroc (points only) on the card")
    launches, _, _ = run_main_path(dev)
    profile_short_run(dev, frames=24)

    print(json.dumps({"kernels": [{
        "name": "lk_level", "route": "cuda", "source": LK_SOURCE, "replaces": LK_REPLACES,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
