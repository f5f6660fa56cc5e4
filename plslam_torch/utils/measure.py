"""What the card check (`chip_smoke.py`) and the timing scripts under
`scripts/` share: the card's name and power limit, CUDA-event and profiler
timing, and the LK kernel's inputs at the main path's shapes."""
from __future__ import annotations

import subprocess

import numpy as np
import torch


def card_info():
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def cuda_time_ms(fn, reps=50, warmup=5):
    """Mean ms a call of `fn` over `reps` back-to-back calls, by CUDA events
    on the current stream, after `warmup` calls."""
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


def device_us(fn, name, reps=50):
    """Device time per launch (µs) of the kernels whose name holds `name`
    that `fn` launches, from torch.profiler's raw device events over `reps`
    calls after one warm-up call: the mean over the launches whose records
    the profiler kept (it can drop some; a smoke run once kept 38 of 50)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA and name in e.name()]
    if not ns:
        raise AssertionError(f"the profiler saw no '{name}' kernel in {reps} calls")
    return 1e-3 * sum(ns) / len(ns)


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


def lk_inputs(dev, h=480, w=752, levels=4, n_features=150):
    """The main path's LK shapes (by default): an h×w shifted texture,
    `levels`-level pyramids, the detector's `n_features` corners with the
    last six moved to every border (padding / clamp paths). Returns (pyr1,
    pyr2, pts, valid, (dx, dy))."""
    from plslam_torch.models.frontend_points import build_pyramid, shi_tomasi_grid

    rng = np.random.default_rng(0)
    dx, dy = 3.7, -2.3
    img1, img2 = shifted_texture(rng, h, w, dx, dy)
    pyr1 = build_pyramid(torch.as_tensor(img1, device=dev), levels=levels)
    pyr2 = build_pyramid(torch.as_tensor(img2, device=dev), levels=levels)
    uv, _ = shi_tomasi_grid(pyr1[0], torch.zeros((1, 2), device=dev),
                            torch.zeros((1,), device=dev), cell=30, max_out=n_features)
    pts = uv.clone()
    pts[-6:] = torch.tensor([[4.2, 120.3], [w - 3.3, 60.1], [160.5, 2.6], [200.4, h - 2.8],
                             [11.3, 11.8], [w - 11.0, h - 10.6]], device=dev)
    valid = torch.ones(n_features, dtype=torch.bool, device=dev)
    return pyr1, pyr2, pts, valid, (dx, dy)
