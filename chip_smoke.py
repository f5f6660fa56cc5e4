"""Chip smoke test of the PyTorch / CUDA port (`plslam_torch`) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU fallback):
  1. card name and power limit (nvidia-smi), torch version; CUDA required.
  2. build every kernel of `plslam_torch/csrc/*.cu` (one nvcc per source,
     started together, then one link); print the build time and the
     `-Xptxas -v` lines.
  3. the LK kernel, one launch per track (all 4 levels), in both of its
     formulations — `fast` (the main path's, the JAX default
     `lk_track_fast`) and `pallas` (the TPU kernel's) — against their plain
     PyTorch versions on the card at the main path's shapes (752×480
     shifted texture, 4-level pyramid, 150 features, six at the borders):
     positions within 1e-3 px, status equal away from the err gate, median
     flow error < 0.3 px; per formulation the time per track by CUDA
     events, the device time per launch (torch.profiler), the plain
     version's time, and the bound from the pixels its own windows cover.
  4. the Hamming kernel (1-bit tensor-core MMA) against its plain version,
     bit-exact, with the extreme rows (every bit set, every bit clear, equal
     descriptors), at 64×64 (the line matcher's shape), 128×256 (the
     loop-closure search), 150×90, 1000×1000, 1×1 and 17×300, and on
     misaligned input views at 128×301 (unaligned output rows too); per
     shape the device time per launch (torch.profiler), the plain version's
     time, and by CUDA events (5 rounds of 200 calls, taken in turns; the
     mean over the rounds, as for every `ms` of the kernels line, and the
     fastest round beside it in the log) the kernel's and the two PyTorch
     library calls' that compute the same function once the bits are
     unpacked (`torch.matmul` of ±1 fp16 signs, `torch.cdist(p=0)` of 0/1
     bits; checked bit for bit, the unpacking timed apart); and the bound
     (bytes at every shape).
  5. render the `scripts/system_fps.py` dataset recipe with the port's
     simulator (cached in the temp directory), then the main path: the
     port's `run_euroc(use_lines=True, line_desc="binary",
     loop_closure=False, device="cuda")` with the reference capacities.
     Requires: initialized, ≥ 40 finite poses, LK launches = tracked
     frames, Hamming launches = published frames, lines solved on most
     solved frames, yaw-aligned ATE < 0.4 m. Then one line tick timed by
     CUDA events, the points-only path over 40 published frames (LK
     launches = tracked frames, no Hamming launch), `FrontendPoints` alone
     over the first 80 camera frames with `tracker="pallas"` and then
     `"fast"` (LK launches = tracked frames; the tracks kept by each), then
     the first 24 published frames of the main path under `torch.profiler`:
     the device's busy share and the kernels that fill it, summed from the
     profiler's raw device events.
  6. the loop scene (the `tests/test_loop_e2e.py` recipe: one 14-s circle
     that revisits its start, rendered with the port's simulator and cached
     as phase 5's set; the estimator fed a 1.5° yaw and ~1 cm lever-arm
     miscalibrated extrinsic, so that loops have drift to close), run twice
     through `run_euroc(loop_closure=True, device="cuda")`: (a) the JAX
     test's own configuration (points only, float64), held to that test's
     assertions; (b) the smoke's full-width configuration (binary lines,
     float32), held to finite poses, ATE < 0.4 m, one DB entry a keyframe,
     LK launches = tracked frames and Hamming launches = published frames +
     the keyframe searches that reached the descriptor match. Both show
     that one recorded CUDA graph of the LM served the relo solves too.
     Logged: loops, candidate outcomes, loop gaps, per-keyframe
     `add_keyframe` ms, `_find_connection` ms (PnP apart), `optimize` ms
     at the K and E it reached, and the search's Hamming device µs.
  7. burst replay: the smoke set through streaming and through
     `run_euroc(burst=8)` in turns (streaming, burst, burst, streaming):
     camera frames/s, frames in burst, chunks, fallbacks and their reasons,
     chunk ms; each burst run held to `tests/test_torch_burst.py`'s bounds
     against the first streaming run, ATE < 0.4 m, LK launches = tracked
     frames and Hamming launches = published frames. Every LK and Hamming
     call that the first burst run's steps make is kept and held against
     the kernel's plain version on its inputs (LK as in phase 3, Hamming bit
     for bit); the kernel, its plain version and the library call are timed
     on the last call's inputs, for the burst rows of the kernels line.
     Then the host's waits on the card (PyTorch's sync debug mode,
     stamped) over 40 published frames of each, per published frame and
     inside each chunk, the first chunk's by line; the device's busy share
     inside each chunk of a 40-frame burst run (`torch.profiler` per
     chunk) and its kernels; then the loop scene's full-width configuration
     with loop closure in burst: at least one loop, ATE < 0.4 m, LK =
     tracked frames, Hamming = published frames + keyframe searches.
  8. one JSON line of kernel results (rows for the burst run's LK and
     Hamming calls and the loop search's beside the main path's), then
     the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import os
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
MIN_POSES = 40  # finite poses a run_euroc of phases 5 and 6 must emit
LK_SOURCE = "plslam_torch/csrc/lk.cu"
LK_FAST_REPLACES = "plslam/models/frontend_points.py:253"
LK_PALLAS_REPLACES = "plslam/ops/kernels/lk.py:120"
HAMMING_SOURCE = "plslam_torch/csrc/hamming.cu"
HAMMING_REPLACES = "plslam/ops/kernels/hamming.py:33"
# the line matcher's (the kernels line's row), the loop-closure search's,
# ragged edges, a throughput check, and the smallest and narrowest
HAMMING_SHAPES = ((64, 64), (128, 256), (150, 90), (1000, 1000), (1, 1), (17, 300))
HAMMING_MISALIGNED = (128, 301)  # both inputs views at one word past 16-B alignment
POINTS_ONLY_FRAMES = 40  # published frames of the points-only run
FRONTEND_FRAMES = 80  # camera frames of the frontend drives (both LK formulations)
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM bytes/s
# and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# the dense INT8 tensor-core rate (H100 SXM data sheet): the fastest unit
# that computes the Hamming matrix exactly (the data sheet gives no 1-bit
# rate), priced at 2 × 256 operations an output, as the ±1 form needs
INT8_OPS_PER_S = 1979e12


_T0 = time.perf_counter()


def log(msg):
    """A line of the report, stamped with the seconds since the script began."""
    print(f"[{time.perf_counter() - _T0:6.1f} s] {msg}", flush=True)


def bound(n_bytes, n_ops, ops_per_s=OPS_PER_S):
    """(least ms for the work, what bounds it) against the card's peaks."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / ops_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _distinct_pixels(shape, rows, cols):
    """Distinct pixels of an [H,W] level that windows cover: rows [N,a] and
    cols [N,b] index tensors, one window a row."""
    import torch

    mask = torch.zeros(shape, dtype=torch.bool, device=rows.device)
    mask[rows[:, :, None], cols[:, None, :]] = True
    return int(mask.sum())


def _pallas_windows(shape, y0f, x0f, s):
    """(rows, cols) of the (s+1)² bilinear windows at float top-lefts
    (y0f, x0f), clamped as `lk._bilinear_patch` clamps."""
    import torch

    from plslam_torch.ops.kernels.lk import _ceil

    h, w = shape
    r = torch.arange(s + 1, device=y0f.device)
    iy = torch.clamp(torch.floor(y0f).long(), 0, _ceil(h, 8) - (s + 1))
    ix = torch.clamp(torch.floor(x0f).long(), 0, _ceil(w, 128) - (s + 1))
    return torch.clamp(iy[:, None] + r, max=h - 1), torch.clamp(ix[:, None] + r, max=w - 1)


def _fast_windows(shape, tl_f, side):
    """(rows, cols) of the side² windows at top-lefts floor(tl_f) clipped to
    the level, as `lk.lk_track_fast_torch` cuts them."""
    import torch

    h, w = shape
    r = torch.arange(side, device=tl_f.device)
    tl = torch.clamp(torch.floor(tl_f).long(), min=0)
    tl = torch.minimum(tl, torch.tensor([w - side, h - side], device=tl_f.device))
    return tl[:, 1:2] + r, tl[:, 0:1] + r


def lk_track_bound(pyr1, pyr2, pts, valid, formulation, iters=10):
    """Least time of one track of `pts` through the pyramids in one launch,
    from this run's inputs. Bytes: the points and valid flags read and the
    positions, status and err written once, and per level the distinct
    float32 pixels that the formulation's windows cover — overlapping
    windows, and a level smaller than its windows, counted once. `fast`:
    the 24×24 template windows at the point in the previous level and the
    30×30 search windows at the level's initial guess in the current one.
    `pallas`: the (WIN+3)² template windows in the previous level and the
    (WIN+1)² patch windows at the level's result in the current one.
    Operations per level and feature: the (WIN+2)² bilinear template samples
    (7 each), gradients and Hessian over WIN² (10 each), `iters`
    Gauss-Newton steps over WIN² (sample, residual and two multiply-adds:
    12 each) and the final |I−T| (9 each)."""
    from plslam_torch.ops.kernels import lk

    win, half, n, levels = lk.WIN, lk.HALF, pts.shape[0], len(pyr1)
    n_bytes, guess = n * (8 + 1 + 8 + 1 + 4), pts
    for level in range(levels - 1, -1, -1):
        s = 2.0 ** level
        p = pts / s
        shape = tuple(pyr1[level].shape)
        if formulation == "fast":
            # the level's initial guess: the track through the coarser levels
            g = p if level == levels - 1 else 2.0 * lk.lk_track_fast_torch(
                pyr1[level + 1:], pyr2[level + 1:], pts / 2.0 ** (level + 1), valid, iters=iters)[0]
            n_bytes += 4 * (_distinct_pixels(shape, *_fast_windows(shape, p - half - 1, lk.S_T))
                            + _distinct_pixels(shape, *_fast_windows(
                                shape, g - half - lk.LK_MARGIN, lk.S_C)))
        else:
            out, _ = lk.lk_level_torch(pyr1[level], pyr2[level], p, guess / s, iters)
            guess = out * s
            n_bytes += 4 * (_distinct_pixels(shape, *_pallas_windows(
                                shape, p[:, 1] - half - 1, p[:, 0] - half - 1, win + 2))
                            + _distinct_pixels(shape, *_pallas_windows(
                                shape, out[:, 1] - half, out[:, 0] - half, win)))
    n_ops = levels * n * (7 * (win + 2) ** 2 + 10 * win ** 2 + 12 * iters * win ** 2
                          + 9 * win ** 2)
    log(f"  LK {formulation} bound terms: {n_bytes} B ({1e3 * n_bytes / HBM_BYTES_PER_S:.6f} ms), "
        f"{n_ops} operations ({1e3 * n_ops / OPS_PER_S:.6f} ms)")
    return bound(n_bytes, n_ops)


def hamming_bound(n1, n2):
    """Least time of one [n1,8]×[n2,8] → [n1,n2] int32 distance matrix:
    inputs read once, output written once; 2 × 256 operations an output at
    the tensor cores' INT8 rate. The bytes bound it at every shape."""
    return bound(4 * (8 * n1 + 8 * n2 + n1 * n2), 2 * 256 * n1 * n2, INT8_OPS_PER_S)


def check_lk_kernel(dev):
    """Phase 3: each LK formulation's kernel against its plain version on
    the card at the main path's shapes; returns a row per formulation."""
    import torch

    from plslam_torch.ops.kernels import lk
    from plslam_torch.utils.measure import cuda_time_ms, device_us, lk_inputs

    pyr1, pyr2, pts, valid, (dx, dy) = lk_inputs(dev, H, W, LEVELS, N_FEATURES)
    args = (pyr1, pyr2, pts, valid)
    rows = {}
    for formulation in lk.FORMULATIONS:
        plain = lk.lk_track_fast_torch if formulation == "fast" else lk.lk_track_torch
        k_out, k_st, _ = lk.lk_track(*args, formulation=formulation)
        p_out, p_st, p_err = plain(*args)
        torch.cuda.synchronize()
        both = k_st & p_st
        diff = float((k_out - p_out).abs().amax(dim=1)[both].max())
        near_gate = (p_err - ERR_GATE).abs() < 1e-4
        status_ok = bool(torch.equal(k_st[~near_gate], p_st[~near_gate]))
        sel = k_st[:-6]  # the detector's corners (the border points have no GT flow)
        flow = (k_out - pts)[:-6][sel]
        flow_err = float((flow - torch.tensor([dx, dy], device=dev)).norm(dim=1).median())
        log(f"  {formulation}: max |Δpos| {diff:.3e} px over {int(both.sum())}/{N_FEATURES} tracked; "
            f"status equal away from the gate: {status_ok}; median flow error {flow_err:.4f} px")
        if not (diff <= POS_TOL_PX and status_ok and flow_err < 0.3 and int(both.sum()) > 100):
            raise AssertionError(f"LK kernel ({formulation}) disagrees with its plain version: "
                                 f"max |Δpos| {diff:.3e} px, status equal {status_ok}, "
                                 f"flow error {flow_err:.4f} px")
        ms = cuda_time_ms(lambda: lk.lk_track(*args, formulation=formulation), reps=200)
        plain_ms = cuda_time_ms(lambda: plain(*args))
        us = device_us(lambda: lk.lk_track(*args, formulation=formulation), "lk_track_kernel")
        bound_ms, bound_by = lk_track_bound(pyr1, pyr2, pts, valid, formulation)
        log(f"  {formulation} track ({LEVELS} levels, {N_FEATURES} features, one launch): "
            f"{ms:.5f} ms by CUDA events, {us:.2f} µs device time; plain {plain_ms:.4f} ms; "
            f"bound {bound_ms:.6f} ms ({bound_by})")
        rows[formulation] = dict(max_abs_err=diff, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by)
    return rows


def _hamming_exact(a, b, what):
    """One kernel call against the plain version, bit for bit; returns the
    largest difference (0)."""
    import torch

    from plslam_torch.ops.kernels import hamming

    k = hamming.hamming_matrix_cuda(a, b)
    p = hamming.hamming_matrix_torch(a, b)
    torch.cuda.synchronize()
    err = int((k.to(torch.int64) - p).abs().max())
    if k.dtype != torch.int32 or not torch.equal(k, p):
        raise AssertionError(f"Hamming kernel disagrees with its plain version at {what}: "
                             f"max |Δ| {err}")
    return err


def check_hamming_kernel(dev):
    """Phase 4: kernel vs plain version on the card, bit-exact, then its
    times beside the library calls' and the bound; returns the kernels
    line's numbers for every shape of HAMMING_SHAPES, by shape."""
    from plslam_torch.ops.kernels import hamming
    from plslam_torch.utils.measure import (cuda_time_ms, device_us, hamming_inputs,
                                            hamming_library, misaligned, ms_in_turns)

    rng = np.random.default_rng(1)
    rows = {}
    for n1, n2 in HAMMING_SHAPES:
        a, b = hamming_inputs(rng, n1, n2, dev)
        err = _hamming_exact(a, b, f"{n1}×{n2}")
        us = device_us(lambda: hamming.hamming_matrix_cuda(a, b), "hamming_kernel")
        plain_ms = cuda_time_ms(lambda: hamming.hamming_matrix_torch(a, b))
        calls, unpack_ms = hamming_library(a, b)
        rounds = ms_in_turns({"kernel": lambda: hamming.hamming_matrix_cuda(a, b), **calls})
        mean = {name: sum(r) / len(r) for name, r in rounds.items()}
        ms = mean.pop("kernel")
        best = min(mean, key=mean.get)
        bound_ms, bound_by = hamming_bound(n1, n2)
        log(f"  {n1}×{n2}: bit-exact; kernel {us:.3f} µs device time; by CUDA events (mean | "
            f"fastest of {len(rounds['kernel'])} rounds in turns) kernel {ms:.5f} | "
            f"{min(rounds['kernel']):.5f} ms, "
            + ", ".join(f"{name} {t:.5f} | {min(rounds[name]):.5f} ms" for name, t in mean.items())
            + f" (unpacking apart: {unpack_ms:.5f} ms); plain {plain_ms:.5f} ms; "
            f"bound {bound_ms:.3e} ms ({bound_by})")
        rows[n1, n2] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=mean[best])
        log(f"  library_ms at {n1}×{n2}: {best}")
    n1, n2 = HAMMING_MISALIGNED
    views = [misaligned(x) for x in hamming_inputs(rng, n1, n2, dev)]
    if any(v.data_ptr() % 16 == 0 for v in views):
        raise AssertionError("the misaligned views are 16-B aligned")
    _hamming_exact(*views, f"{n1}×{n2} (misaligned input views)")
    log(f"  {n1}×{n2} on misaligned input views: bit-exact")
    return rows


TRAJECTORY = dict(omega=0.4, z_omega=0.7, wiggle_amp=0.15, excite_amp=0.1)
SEQUENCE = dict(duration=DURATION, n_points=500, n_lines=40, seed=17,
                acc_noise=0.1, gyr_noise=0.005, acc_bias=0.05, gyr_bias=0.002)
RENDER = dict(h=H, w=W, max_frames=int(DURATION * 20), blob_sigma=3.0, style="textured")
# the loop scene: `tests/test_loop_e2e.py`'s recipe, one circle at ω = 0.5
# rad/s (a revisit after 12.6 s) in 14 s
LOOP_TRAJECTORY = dict(omega=0.5, z_omega=0.8)
LOOP_SEQUENCE = dict(duration=14.0, n_points=500, n_lines=40, seed=23,
                     acc_noise=0.1, gyr_noise=0.005, acc_bias=0.05, gyr_bias=0.002)
LOOP_RENDER = dict(h=H, w=W, max_frames=280, blob_sigma=3.0, style="textured")
DATASETS = {"fps": (TRAJECTORY, SEQUENCE, RENDER),
            "loop": (LOOP_TRAJECTORY, LOOP_SEQUENCE, LOOP_RENDER)}
# the estimator's extrinsic error in the loop scene (the renderer uses the true one)
MISCAL_YAW_DEG = 1.5
MISCAL_LEVER_M = (0.01, -0.005, 0.008)
LOOP_GAP, LOOP_MAX_KEYFRAMES = 40, 512


def dataset_key(name="fps"):
    """A hash of the recipe and of the simulator's and renderer's sources."""
    import plslam_torch.io as io_pkg

    h = hashlib.sha256(json.dumps([*DATASETS[name], F], sort_keys=True).encode())
    io_dir = os.path.dirname(os.path.abspath(io_pkg.__file__))
    for name in sorted(os.listdir(io_dir)):
        if name.endswith(".py"):
            with open(os.path.join(io_dir, name), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def render_dataset(name="fps"):
    """A recipe of `DATASETS` (by default the `scripts/system_fps.py` one),
    rendered with the port's simulator into a cache keyed by `dataset_key`."""
    from plslam_torch.io import render, synthetic
    from plslam_torch.ops.cameras import PinholeRadTan
    from plslam_torch.utils.geometry import quat_to_rot

    cache = os.path.join(tempfile.gettempdir(), f"plslam_torch_{name}_ds_{dataset_key(name)}")
    meta = os.path.join(cache, "meta.npz")
    if os.path.exists(meta):
        return cache, 0.0
    t0 = time.perf_counter()
    trajectory, sequence, rendering = DATASETS[name]
    seq = synthetic.make_sequence(params=synthetic.TrajectoryParams(**trajectory), **sequence)
    cam = PinholeRadTan.create(F, F, W / 2, H / 2)
    os.makedirs(cache, exist_ok=True)
    render.write_euroc_dataset(seq, cache, cam, **rendering)
    np.savez(meta, R_bc=quat_to_rot(seq.q_bc).numpy(), p_bc=seq.p_bc.numpy(),
             gt_t=seq.frame_t.numpy(), gt_p=seq.gt_p.numpy(), gt_q=seq.gt_q.numpy())
    return cache, time.perf_counter() - t0


def smoke_config(meta):
    from plslam_torch.config import (CameraConfig, ExtrinsicConfig, LoopConfig, PLSlamConfig,
                                     SolverConfig, TrackerConfig)

    return PLSlamConfig(
        camera=CameraConfig(image_width=W, image_height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                            k1=0, k2=0, p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=150, min_dist=30, equalize=True, min_score=2e-3,
                              max_lines=64, line_desc="binary"),
        solver=SolverConfig(max_features=192, max_line_feats=64, window_size=10,
                            max_num_iterations=8, dtype="float32", focal_length=F),
        extrinsic=ExtrinsicConfig(0, tuple(meta["R_bc"].reshape(-1)), tuple(meta["p_bc"])),
        loop=LoopConfig(loop_closure=False),
    )


def profile_short_run(dev, frames):
    """The first `frames` published frames of the main path under
    torch.profiler: the device's busy share of the wall time and the kernels
    that fill it. The profiler's raw device events are summed by name here;
    its own `key_averages()` builds an event tree first, which takes minutes
    for the run's million events."""
    from collections import defaultdict

    import torch
    from torch.profiler import ProfilerActivity, profile

    from plslam_torch import runner

    path, _ = render_dataset()
    cfg = smoke_config(np.load(os.path.join(path, "meta.npz")))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only
        t0 = time.perf_counter()
        runner.run_euroc(path, cfg, use_lines=True, loop_closure=False, max_frames=frames,
                         device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total_ns, count = defaultdict(int), defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            total_ns[e.name()] += e.duration_ns()
            count[e.name()] += 1
    log(f"  profiler stopped and its events summed in {time.perf_counter() - t0 - wall:.1f} s")
    busy_s = 1e-9 * sum(total_ns.values())
    log(f"  profiled {frames} published frames: wall {wall:.3f} s (profiler on), device busy "
        f"{busy_s:.3f} s = {100 * busy_s / wall:.1f} %, {sum(count.values())} device ops")
    top = sorted(total_ns, key=lambda k: -total_ns[k])
    ours = ("lk_track_kernel", "hamming_kernel")
    for name in top[:12] + [k for k in top[12:] if any(o in k for o in ours)]:
        log(f"    {total_ns[name] / 1e6:9.1f} ms  {count[name]:7d}×  "
            f"{total_ns[name] / 1e3 / count[name]:8.2f} µs each  {name[:80]}")


def _published(n_cam, max_frames=None, stride=2):
    """(camera frames run_euroc processes, published frames among them)."""
    n_pub = len(range(0, n_cam, stride))
    if max_frames is None or max_frames >= n_pub:
        return n_cam, n_pub
    return (max_frames - 1) * stride + 1, max_frames


def run_main_path(dev):
    """Phase 5: the port's streaming pipeline with binary lines on the
    rendered set. Returns the launch counts of the run."""
    import torch

    from plslam_torch import runner
    from plslam_torch.eval.metrics import ate_rmse
    from plslam_torch.ops.kernels import hamming, lk

    path, render_s = render_dataset()
    log(f"  dataset: {path} (rendered in {render_s:.1f} s)")
    meta = np.load(os.path.join(path, "meta.npz"))
    cfg = smoke_config(meta)
    n_cam, n_pub = _published(len(os.listdir(os.path.join(path, "mav0", "cam0", "data"))))
    lk.LAUNCHES = hamming.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, ps, qs, est, _ = runner.run_euroc(path, cfg, use_lines=True, loop_closure=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lk_track": lk.LAUNCHES, "hamming_matrix": hamming.LAUNCHES}
    if not est.initialized:
        raise AssertionError("the estimator did not initialize")
    if len(ts) < MIN_POSES or not np.all(np.isfinite(ps)) or np.asarray(ps).shape[1:] != (3,):
        raise AssertionError(f"expected ≥ {MIN_POSES} finite [3] positions, "
                             f"got {np.asarray(ps).shape}")
    if launches["lk_track"] != n_cam - 1:
        raise AssertionError(f"LK launches {launches['lk_track']} != {n_cam - 1} tracked frames")
    if launches["hamming_matrix"] != n_pub:
        raise AssertionError(f"Hamming launches {launches['hamming_matrix']} != {n_pub} published frames")
    solved = [m for m in est.metrics if "cost" in m]
    med_lines = float(np.median([m["n_lines"] for m in solved]))
    if not med_lines > 0:
        raise AssertionError(f"no lines solved on most solved frames (median n_lines {med_lines})")
    ate = float(ate_rmse(ts, ps, meta["gt_t"], meta["gt_p"], align="yaw"))
    log(f"  run_euroc (binary lines): {n_cam} camera frames, {n_pub} published, {len(ts)} emitted, "
        f"{len(solved)} solved in {wall:.2f} s = {n_cam / wall:.2f} camera frames/s; "
        f"median lines solved {med_lines:.0f}; launches {launches}; ATE(yaw) {ate:.4f} m")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate:.4f} m ≥ {ATE_LIMIT_M} m")
    return launches


def time_line_tick(dev):
    """CUDA-event time of one line tick (binary LBD, the main path's widths)
    on two CLAHE'd frames of the rendered set, sharing their pyramids' level
    1 as the main path does."""
    import torch

    from plslam_torch import runner
    from plslam_torch.io.euroc import EurocSequence
    from plslam_torch.models.frontend_lines import FrontendLines
    from plslam_torch.models.frontend_points import build_pyramid
    from plslam_torch.ops.cameras import make_camera
    from plslam_torch.utils.measure import cuda_time_ms

    path, _ = render_dataset()
    cfg = smoke_config(np.load(os.path.join(path, "meta.npz")))
    seq = EurocSequence.load(path)
    pyrs = [build_pyramid(torch.as_tensor(runner._clahe(seq.image(k)), device=dev), 2)
            for k in (0, 2)]
    fl = FrontendLines(make_camera(cfg.camera), max_lines=cfg.tracker.max_lines, binary_desc=True,
                       device=dev)
    step = iter(range(10 ** 9))

    def tick():
        pyr = pyrs[next(step) % 2]
        fl.process(pyr[0], 0.0, oct1=pyr[1], want_output=False)

    ms = cuda_time_ms(tick, reps=20, warmup=4)
    log(f"  line tick (752×480, 2 octaves, binary LBD, max_lines {cfg.tracker.max_lines}): "
        f"{ms:.3f} ms per published frame")


def run_points_only(dev, frames=POINTS_ONLY_FRAMES):
    """The points-only path over the first `frames` published frames."""
    import torch

    from plslam_torch import runner
    from plslam_torch.ops.kernels import hamming, lk

    path, _ = render_dataset()
    cfg = smoke_config(np.load(os.path.join(path, "meta.npz")))
    n_cam, n_pub = _published(len(os.listdir(os.path.join(path, "mav0", "cam0", "data"))), frames)
    lk.LAUNCHES = hamming.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, ps, _, est, _ = runner.run_euroc(path, cfg, use_lines=False, loop_closure=False,
                                         max_frames=frames, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(est.metrics) != n_pub or not np.all(np.isfinite(ps)):
        raise AssertionError(f"points-only run: {len(est.metrics)} frames, expected {n_pub}")
    if lk.LAUNCHES != n_cam - 1 or hamming.LAUNCHES != 0:
        raise AssertionError(f"points-only run: LK launches {lk.LAUNCHES} != {n_cam - 1} tracked "
                             f"frames, or Hamming launches {hamming.LAUNCHES} != 0")
    log(f"  run_euroc (points only): {n_cam} camera frames, {n_pub} published, {len(ts)} emitted "
        f"in {wall:.2f} s = {n_cam / wall:.2f} camera frames/s; LK launches {lk.LAUNCHES}")


def drive_frontend(dev, tracker, frames=FRONTEND_FRAMES):
    """`FrontendPoints(tracker=...)` alone over the first `frames` camera
    frames of the rendered set (CLAHE'd before the drive), a `tick` on every
    second frame and a `tick_light` between, as `run_euroc` drives it.
    Returns (LK launches, tracked frames, tracks kept: the features of the
    published frames that continue a track from the previous frame)."""
    import torch

    from plslam_torch import runner
    from plslam_torch.io.euroc import EurocSequence
    from plslam_torch.models.frontend_points import FrontendPoints
    from plslam_torch.ops.cameras import make_camera
    from plslam_torch.ops.kernels import lk

    path, _ = render_dataset()
    cfg = smoke_config(np.load(os.path.join(path, "meta.npz")))
    tr = cfg.tracker
    seq = EurocSequence.load(path)
    imgs = [runner._clahe(seq.image(k)) for k in range(frames)]
    fp = FrontendPoints(make_camera(cfg.camera), max_cnt=tr.max_cnt, min_dist=tr.min_dist,
                        f_thresh_px=tr.f_threshold, focal=cfg.camera.fx, min_score=tr.min_score,
                        device=dev, tracker=tracker)
    stride = max(1, round(20 / tr.freq))
    kept = 0
    lk.LAUNCHES = 0
    for k, img in enumerate(imgs):
        publish = k % stride == 0
        if fp.process(img, float(seq.cam_t[k]), want_output=publish, light=not publish) and k:
            kept += int((fp.track_cnt[fp.prev_valid] >= 2).sum())
    torch.cuda.synchronize()
    return lk.LAUNCHES, frames - 1, kept


def drive_frontends(dev):
    """Phase 5's frontend drives: the `pallas` formulation, which no
    `run_euroc` path takes, and the main path's `fast` on the same frames.
    Returns the `pallas` drive's LK launches."""
    drives = {tracker: drive_frontend(dev, tracker) for tracker in ("pallas", "fast")}
    for tracker, (launches, tracked, kept) in drives.items():
        if launches != tracked:
            raise AssertionError(f"frontend drive ({tracker}): LK launches {launches} != "
                                 f"{tracked} tracked frames")
    log(f"  FrontendPoints over {FRONTEND_FRAMES} camera frames: LK launches "
        f"{drives['pallas'][0]} (pallas), {drives['fast'][0]} (fast); tracks kept on the "
        f"published frames {drives['pallas'][2]} (pallas), {drives['fast'][2]} (fast)")
    return drives["pallas"][0]


def loop_extrinsic(meta):
    """The loop scene's miscalibrated body_T_cam: the true one turned by
    MISCAL_YAW_DEG about the camera's z and shifted by MISCAL_LEVER_M."""
    a = np.radians(MISCAL_YAW_DEG)
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
    return meta["R_bc"] @ Rz, meta["p_bc"] + np.array(MISCAL_LEVER_M)


def loop_configs(meta):
    """(a) `tests/test_loop_e2e.py`'s configuration; (b) the smoke's full
    width (phase 5's configuration) with the same loop settings. Both get
    the miscalibrated extrinsic."""
    from plslam_torch.config import (CameraConfig, ExtrinsicConfig, LoopConfig, PLSlamConfig,
                                     SolverConfig, TrackerConfig)

    R_bc, p_bc = loop_extrinsic(meta)
    extrinsic = ExtrinsicConfig(0, tuple(R_bc.reshape(-1)), tuple(p_bc))
    loop = LoopConfig(loop_closure=True, min_loop_gap=LOOP_GAP, max_keyframes=LOOP_MAX_KEYFRAMES)
    reference = PLSlamConfig(
        camera=CameraConfig(image_width=W, image_height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                            k1=0, k2=0, p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=100, min_dist=30, equalize=True, min_score=2e-3),
        solver=SolverConfig(max_features=96, max_line_feats=24, dtype="float64", focal_length=F),
        extrinsic=extrinsic, loop=loop)
    full = dataclasses.replace(smoke_config(meta), extrinsic=extrinsic, loop=loop)
    return reference, full


def loop_gaps(pg, xyz, yaw):
    """The revisit gap of every loop edge at poses (xyz, yaw): the
    translation residual the 4-DoF PGO minimizes."""
    from plslam_torch.utils import quat_np as qnp

    gaps = []
    for e in pg.edges:
        if e["loop"]:
            i, j = e["i"], e["j"]
            Ri = qnp.ypr_to_rot(np.array([yaw[i], pg.pitch[i], pg.roll[i]]))
            gaps.append(np.linalg.norm(Ri.T @ (xyz[j] - xyz[i]) - np.asarray(e["t"])))
    return np.asarray(gaps)


def run_loop_case(dev, label, cfg, use_lines):
    """One `run_euroc(loop_closure=True)` over the loop scene with the launch
    counts set to 0 just before it; checks what both cases share and logs
    the pose graph's outcomes and costs. Returns (run outputs, meta,
    launches, keyframe searches that reached the descriptor match, the
    largest difference of the search's Hamming kernel from its plain
    version)."""
    import torch

    from plslam_torch import runner
    from plslam_torch.eval.metrics import ate_rmse
    from plslam_torch.ops.kernels import hamming, lk
    from plslam_torch.utils.measure import device_us, pgo_graph_vs_eager

    path, _ = render_dataset("loop")
    meta = np.load(os.path.join(path, "meta.npz"))
    n_cam, n_pub = _published(len(os.listdir(os.path.join(path, "mav0", "cam0", "data"))))
    lk.LAUNCHES = hamming.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, ps, qs, est, pg = runner.run_euroc(path, cfg, use_lines=use_lines, loop_closure=True,
                                           device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lk_track": lk.LAUNCHES, "hamming_matrix": hamming.LAUNCHES}
    searched = [r for r in pg.stats if r["outcome"] not in ("no_window_points", "no_descriptors")]
    ate = float(ate_rmse(ts, ps, meta["gt_t"], meta["gt_p"], align="yaw"))
    log(f"  ({label}) {n_cam} camera frames, "
        f"{n_pub} published, {len(ts)} emitted in {wall:.2f} s = {n_cam / wall:.2f} camera "
        f"frames/s; keyframes {pg.n}, DB {pg.db.n}, loops {pg.loop_count}; launches {launches}, "
        f"searches reaching the match {len(searched)}; ATE(yaw) {ate:.4f} m")
    log(f"  ({label}) candidate outcomes {dict(collections.Counter(r['outcome'] for r in pg.stats))}")
    if not est.initialized:
        raise AssertionError(f"({label}) the estimator did not initialize")
    if not np.all(np.isfinite(ps)) or np.asarray(ps).shape[1:] != (3,) or len(ts) < MIN_POSES:
        raise AssertionError(f"({label}) expected ≥ {MIN_POSES} finite [3] positions, "
                             f"got {np.asarray(ps).shape}")
    if pg.db.n != pg.n:
        raise AssertionError(f"({label}) {pg.db.n} DB entries for {pg.n} keyframes")
    if launches["lk_track"] != n_cam - 1:
        raise AssertionError(f"({label}) LK launches {launches['lk_track']} != {n_cam - 1} "
                             f"tracked frames")
    want = (n_pub if use_lines else 0) + len(searched)
    if launches["hamming_matrix"] != want:
        raise AssertionError(f"({label}) Hamming launches {launches['hamming_matrix']} != {want} "
                             f"(line matches + keyframe searches)")
    solves = [k for k in est._graphs if k[0] == "optimize_window"]
    refined = [e for e in pg.edges if e["loop"] and "t_pnp" in e]
    log(f"  ({label}) LM CUDA graphs recorded {len(solves)}; loop edges refined by the relo "
        f"round trip {len(refined)}")
    if len(solves) != 1:
        raise AssertionError(f"({label}) {len(solves)} LM graphs recorded; relo frames must "
                             f"replay the one graph")
    times = pg.times
    log(f"  ({label}) add_keyframe ms: median {np.median(times['add_keyframe']):.2f}, "
        f"max {max(times['add_keyframe']):.2f} over {len(times['add_keyframe'])}, of which "
        f"corners and descriptors median {np.median(times['features']):.2f}; "
        f"_find_connection ms (PnP apart): median {np.median(times['find_connection'] or [0]):.2f} "
        f"over {len(times['find_connection'])}; PnP ms: median {np.median(times['pnp'] or [0]):.2f} "
        f"over {len(times['pnp'])}")
    log(f"  ({label}) optimize (K, E, ms): {[(k, e, round(ms, 2)) for k, e, ms in times['optimize']]}")
    pgo = pgo_graph_vs_eager(pg)
    for way in ("graph", "eager"):
        log(f"  ({label}) the run's PGO calls replayed {way} (ms a call, pass by pass, in turns): "
            + "; ".join(f"total {sum(p):.2f}: {np.round(p, 2).tolist()}" for p in pgo[way]))
    log(f"  ({label}) of which packing the inputs (ms): {np.round(pgo['pack'], 2).tolist()}")
    gaps = loop_gaps(pg, pg.opt_p, pg.opt_yaw)
    log(f"  ({label}) loop gaps at the optimized poses (m): {np.round(gaps, 4).tolist()}")
    # every search's descriptor pair again, kernel against plain, bit for bit
    shapes, err = {}, 0
    for r in searched:
        cur, old = pg.db.entries[r["j"]], pg.db.entries[r["i"]]
        a, b = pg._desc_on_device(cur, "win_desc"), pg._desc_on_device(old, "desc")
        err = max(err, _hamming_exact(a, b, f"{len(a)}×{len(b)} (loop search {r['i']}, {r['j']})"))
        shapes.setdefault((len(a), len(b)), (a, b))
    log(f"  ({label}) the search's Hamming equals its plain version on all {len(searched)} "
        f"descriptor pairs, shapes {sorted(shapes)}")
    for (n1, n2), (a, b) in sorted(shapes.items())[-3:]:
        us = device_us(lambda: hamming.hamming_matrix_cuda(a, b), "hamming_kernel")
        log(f"  ({label}) the search's Hamming at {n1}×{n2}: {us:.3f} µs device time")
    return (ts, ps, qs, est, pg), meta, launches, len(searched), err


def run_loop_scene(dev):
    """Phase 6: (a) the JAX loop test's configuration, held to its
    assertions; (b) the full width. Returns the loop search's Hamming
    launches of (b) and the search kernel's largest difference from its
    plain version over both runs' descriptor pairs."""
    from plslam_torch.eval.metrics import ate_rmse
    from plslam_torch.utils import quat_np as qnp

    path, render_s = render_dataset("loop")
    log(f"  dataset: {path} (rendered in {render_s:.1f} s)")
    reference, full = loop_configs(np.load(os.path.join(path, "meta.npz")))

    (ts, ps, _, est, pg), meta, _, _, err_a = run_loop_case(dev, "a", reference, use_lines=False)
    gt_t, gt_p, gt_q = meta["gt_t"], meta["gt_p"], meta["gt_q"]
    n = pg.n
    raw_ate = float(ate_rmse(pg.t_kf[:n], pg.vio_p[:n], gt_t, gt_p, align="yaw"))
    corr_ate = float(ate_rmse(pg.t_kf[:n], pg.opt_p[:n], gt_t, gt_p, align="yaw"))
    raw_yaw = np.array([qnp.rot_to_ypr(qnp.quat_to_rot(pg.vio_q[k]))[0] for k in range(n)])
    gap_raw, gap_corr = loop_gaps(pg, pg.vio_p, raw_yaw), loop_gaps(pg, pg.opt_p, pg.opt_yaw)
    accepted = [r for r in pg.stats if r["outcome"] == "accepted"]
    refined = [e for e in pg.edges if e["loop"] and "t_pnp" in e]

    def gt_rel_t(e):
        ki = np.argmin(np.abs(gt_t - pg.t_kf[e["i"]]))
        kj = np.argmin(np.abs(gt_t - pg.t_kf[e["j"]]))
        Ri = qnp.ypr_to_rot(qnp.rot_to_ypr(qnp.quat_to_rot(gt_q[ki])))
        return Ri.T @ (gt_p[kj] - gt_p[ki])

    err_pnp = [np.linalg.norm(np.asarray(e["t_pnp"]) - gt_rel_t(e)) for e in refined]
    err_ref = [np.linalg.norm(np.asarray(e["t"]) - gt_rel_t(e)) for e in refined]
    stream_ate = float(ate_rmse(ts, ps, gt_t, gt_p, align="yaw"))
    log(f"  (a) keyframe ATE raw {raw_ate:.4f} m, corrected {corr_ate:.4f} m; loop gap max raw "
        f"{gap_raw.max(initial=0):.4f} m, corrected {gap_corr.max(initial=0):.4f} m; accepted "
        f"inliers {[r['inliers'] for r in accepted]}; refined edges' error vs GT: PnP "
        f"{np.round(err_pnp, 4).tolist()}, refined {np.round(err_ref, 4).tolist()}; "
        f"stream ATE {stream_ate:.4f} m")
    checks = {
        "pg.n > 80": n > 80, "db.n > 80": pg.db.n > 80, "loop_count ≥ 1": pg.loop_count >= 1,
        "accepted candidates have ≥ min_pnp_inliers": all(
            r["inliers"] >= reference.loop.min_pnp_inliers for r in accepted),
        "raw keyframe ATE > 0.25 m": raw_ate > 0.25,
        "raw loop gap > 0.4 m": gap_raw.max(initial=0) > 0.4,
        "corrected gap < 0.35 × raw": gap_corr.max(initial=0) < 0.35 * gap_raw.max(initial=0),
        "corrected gap < 0.25 m": gap_corr.max(initial=0) < 0.25,
        "corrected ATE < 1.3 × raw": corr_ate < 1.3 * raw_ate,
        "stream ATE finite and < 1 m": np.isfinite(stream_ate) and stream_ate < 1.0,
        "a loop edge refined by the relo round trip": len(refined) > 0,
        "refined edges beat PnP against GT": bool(refined) and np.mean(err_ref) < np.mean(err_pnp),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"(a) the loop e2e assertions failed: {failed}")
    log(f"  (a) the loop e2e assertions hold: {len(checks)} of {len(checks)}")

    (ts, ps, _, _, pg), meta, launches, searched, err_b = run_loop_case(dev, "b", full,
                                                                        use_lines=True)
    ate = float(ate_rmse(ts, ps, meta["gt_t"], meta["gt_p"], align="yaw"))
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"(b) ATE {ate:.4f} m ≥ {ATE_LIMIT_M} m")
    return searched, max(err_a, err_b)


BURST = 8  # published frames a chunk (phase 7)
SYNC_FRAMES = 40  # published frames of the sync-counted runs: init, 7 solves, 2 chunks, a tail


def burst_vs_streaming(label, stream, burst):
    """`tests/test_torch_burst.py`'s bounds between a burst run and a
    streaming run of the same frames; raises on a miss."""
    (ts_s, ps_s, _, est_s, _), (ts_b, ps_b, _, est_b, _) = stream, burst
    if len(ts_b) != len(ts_s) or not np.allclose(ts_b, ts_s, atol=1e-9, rtol=0):
        raise AssertionError(f"({label}) burst emitted other timestamps than streaming")
    dp = np.linalg.norm(np.asarray(ps_b) - np.asarray(ps_s), axis=1)
    _, p_last, _ = est_b.latest_pose()
    checks = {"max |Δp| < 0.1 m": dp.max() < 0.1, "median |Δp| < 1e-2 m": np.median(dp) < 1e-2,
              "last 8 |Δp| < 2e-2 m": dp[-8:].max() < 2e-2,
              "slot timestamps equal": np.allclose(est_b.timestamps, est_s.timestamps, atol=1e-9,
                                                   rtol=0),
              "latest_pose() = last emitted": np.allclose(p_last, ps_b[-1], atol=1e-9, rtol=0)}
    log(f"  ({label}) burst vs streaming: max |Δp| {dp.max():.3e} m, median {np.median(dp):.3e} m, "
        f"last 8 {dp[-8:].max():.3e} m")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"({label}) burst vs streaming: {failed}")
    return dp


def burst_run(dev, path, cfg, meta, burst, max_frames=None, loop=False):
    """One `run_euroc` (burst=0: streaming) with the launch counts set to 0
    just before it. Returns (outputs, launches, wall s, camera frames, burst
    log, ATE)."""
    import torch

    from plslam_torch import runner
    from plslam_torch.eval.metrics import ate_rmse
    from plslam_torch.ops.kernels import hamming, lk

    blog = []
    n_cam, _ = _published(len(os.listdir(os.path.join(path, "mav0", "cam0", "data"))), max_frames)
    lk.LAUNCHES = hamming.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner.run_euroc(path, cfg, use_lines=True, loop_closure=loop, max_frames=max_frames,
                           burst=burst, burst_log=blog, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lk_track": lk.LAUNCHES, "hamming_matrix": hamming.LAUNCHES}
    ate = float(ate_rmse(out[0], out[1], meta["gt_t"], meta["gt_p"], align="yaw"))
    return out, launches, wall, n_cam, blog, ate


@contextlib.contextmanager
def burst_kernel_calls():
    """Keep every LK and Hamming kernel call that the burst steps make while
    the block runs (calls outside `BurstStep.run_chunk`, the streamed
    frames', are not kept): the wrapper's arguments and the outputs it
    returned, copied on the card, which waits for nothing. Yields
    {"lk_track": [(args, kwargs, outputs)], "hamming_matrix": [...]}."""
    import torch

    from plslam_torch.models import burst
    from plslam_torch.ops.kernels import hamming, lk

    calls = {"lk_track": [], "hamming_matrix": []}
    inside = [False]
    run_chunk, lk_cuda, ham_cuda = (burst.BurstStep.run_chunk, lk.lk_track_cuda,
                                    hamming.hamming_matrix_cuda)

    def copy(x):
        if isinstance(x, (list, tuple)):
            return [copy(y) for y in x]
        return x.clone() if isinstance(x, torch.Tensor) else x

    def kept(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if inside[0]:
                calls[name].append((copy(args), copy(kwargs), copy(out)))
            return out
        return call

    def chunk(self, *args):
        inside[0] = True
        try:
            return run_chunk(self, *args)
        finally:
            inside[0] = False

    burst.BurstStep.run_chunk = chunk
    lk.lk_track_cuda = kept("lk_track", lk_cuda)
    hamming.hamming_matrix_cuda = kept("hamming_matrix", ham_cuda)
    try:
        yield calls
    finally:
        burst.BurstStep.run_chunk = run_chunk
        lk.lk_track_cuda, hamming.hamming_matrix_cuda = lk_cuda, ham_cuda


def hold_burst_calls(calls):
    """Each kept burst call's output against the kernel's plain version on
    its inputs — LK at phase 3's tolerance (positions within POS_TOL_PX
    where both track, the status equal away from the error gate), Hamming
    bit for bit — then the kernel, its plain version and, for Hamming, the
    library calls timed on the inputs of the last kept call, with the bound
    from those inputs. Raises after logging every miss. Returns the
    kernels-line numbers by kernel."""
    import inspect

    import torch

    from plslam_torch.ops.kernels import hamming, lk
    from plslam_torch.utils.measure import cuda_time_ms, hamming_library, ms_in_turns

    if not calls["lk_track"] or not calls["hamming_matrix"]:
        raise AssertionError(f"burst made {len(calls['lk_track'])} LK and "
                             f"{len(calls['hamming_matrix'])} Hamming kernel calls")
    sig = inspect.signature(lk.lk_track_cuda)

    def lk_plain(args, kwargs):
        a = sig.bind(*args, **kwargs)
        a.apply_defaults()
        a = a.arguments
        plain = lk.lk_track_fast_torch if a["formulation"] == "fast" else lk.lk_track_torch
        return a, lambda: plain(a["pyr_prev"], a["pyr_cur"], a["pts_prev"], a["valid"],
                                a["levels"], a["iters"], a["err_thresh"])

    lk_err, misses, tracked = 0.0, [], 0
    for i, (args, kwargs, (k_out, k_st, _)) in enumerate(calls["lk_track"]):
        a, plain = lk_plain(args, kwargs)
        p_out, p_st, p_err = plain()
        both = k_st & p_st
        diff = float((k_out - p_out).abs().amax(dim=1)[both].max()) if bool(both.any()) else 0.0
        near_gate = (p_err - a["err_thresh"]).abs() < 1e-4
        status_ok = bool(torch.equal(k_st[~near_gate], p_st[~near_gate]))
        lk_err, tracked = max(lk_err, diff), tracked + int(both.sum())
        if diff > POS_TOL_PX or not status_ok:
            misses.append(f"LK call {i}: max |Δpos| {diff:.3e} px, status equal away from the "
                          f"gate {status_ok}")
    ham_err, shapes = 0, collections.Counter()
    for i, ((d1, d2), _, k) in enumerate(calls["hamming_matrix"]):
        p = hamming.hamming_matrix_torch(d1, d2)
        err = int((k.to(torch.int64) - p).abs().max()) if k.numel() else 0
        ham_err, shapes[tuple(k.shape)] = max(ham_err, err), shapes[tuple(k.shape)] + 1
        if k.dtype != torch.int32 or not torch.equal(k, p):
            misses.append(f"Hamming call {i} at {tuple(k.shape)}: max |Δ| {err}")
    log(f"  (burst) held {len(calls['lk_track'])} LK calls ({tracked} points tracked by both, "
        f"max |Δpos| {lk_err:.3e} px) and {len(calls['hamming_matrix'])} Hamming calls (shapes "
        f"{dict(shapes)}, max |Δ| {ham_err}) against their plain versions")
    for miss in misses:
        log(f"  (burst) MISS {miss}")
    if misses:
        raise AssertionError(f"{len(misses)} burst kernel calls disagree with their plain versions")

    args, kwargs, _ = calls["lk_track"][-1]
    a, plain = lk_plain(args, kwargs)
    ms = cuda_time_ms(lambda: lk.lk_track_cuda(*args, **kwargs), reps=200)
    plain_ms = cuda_time_ms(plain)
    bound_ms, bound_by = lk_track_bound(a["pyr_prev"], a["pyr_cur"], a["pts_prev"], a["valid"],
                                        a["formulation"], a["iters"])
    rows = {"lk_track": dict(max_abs_err=lk_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)}
    log(f"  (burst) LK on the last call's inputs ({a['pts_prev'].shape[0]} points): {ms:.5f} ms "
        f"by CUDA events; plain {plain_ms:.4f} ms; bound {bound_ms:.6f} ms ({bound_by})")
    (d1, d2), _, _ = calls["hamming_matrix"][-1]
    lib, _ = hamming_library(d1, d2)
    rounds = ms_in_turns({"kernel": lambda: hamming.hamming_matrix_cuda(d1, d2), **lib})
    mean = {name: sum(r) / len(r) for name, r in rounds.items()}
    ms = mean.pop("kernel")
    best = min(mean, key=mean.get)
    plain_ms = cuda_time_ms(lambda: hamming.hamming_matrix_torch(d1, d2))
    bound_ms, bound_by = hamming_bound(len(d1), len(d2))
    rows["hamming_matrix"] = dict(max_abs_err=float(ham_err), ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by, library_ms=mean[best])
    log(f"  (burst) Hamming on the last call's inputs ({len(d1)}×{len(d2)}): {ms:.5f} ms by CUDA "
        f"events (mean of {len(rounds['kernel'])} rounds in turns), {best} {mean[best]:.5f} ms; "
        f"plain {plain_ms:.5f} ms; bound {bound_ms:.3e} ms ({bound_by})")
    return rows


def describe_burst(label, run):
    """Log a run's frames/s, its burst frames, chunks and fallbacks."""
    (ts, _, _, est, _), launches, wall, n_cam, blog, ate = run
    chunks = [e for e in blog if "fallback" not in e]
    fallbacks = collections.Counter(e["fallback"] for e in blog if "fallback" in e)
    n_burst = sum(1 for m in est.metrics if m.get("burst"))
    chunk_ms = [1e3 * e["chunk_s"] for e in chunks]
    log(f"  ({label}) {n_cam} camera frames in {wall:.2f} s = {n_cam / wall:.2f} camera frames/s; "
        f"{len(ts)} emitted, {n_burst} in burst over {len(chunks)} chunks; fallbacks "
        f"{dict(fallbacks)}; launches {launches}; ATE(yaw) {ate:.4f} m"
        + (f"; chunk ms median {np.median(chunk_ms):.1f} (min {min(chunk_ms):.1f}, max "
           f"{max(chunk_ms):.1f}) = {np.median(chunk_ms) / BURST:.1f} ms a published frame, "
           f"decode wait ms median {1e3 * np.median([e['decode_wait_s'] for e in chunks]):.2f}"
           if chunks else ""))
    return n_burst, len(chunks), fallbacks


def count_syncs(dev, path, cfg, meta, burst):
    """A run over SYNC_FRAMES published frames with every wait of the host on
    the card stamped: the waits inside each chunk (from its prefetch wait to
    its readback) and, for streaming, the waits per published frame."""
    from plslam_torch.utils.measure import sync_stamps

    with sync_stamps() as stamps:
        (_, _, _, est, _), _, _, _, blog, _ = burst_run(dev, path, cfg, meta, burst,
                                                        max_frames=SYNC_FRAMES)
    chunks = [e for e in blog if "fallback" not in e]
    per_chunk = [sum(1 for t, _ in stamps if e["t0"] <= t <= e["t1"]) for e in chunks]
    sites = collections.Counter(os.path.relpath(site) for t, site in stamps
                                if chunks and chunks[0]["t0"] <= t <= chunks[0]["t1"])
    return len(stamps), len(est.metrics), per_chunk, sites


def profile_burst_chunks(dev, path, cfg, meta, frames=SYNC_FRAMES):
    """The device's busy share inside each burst chunk of a run over
    `frames` published frames: every chunk's steps under their own
    `torch.profiler` (device events only), its wall from the first
    launch to a synchronize, and the kernels that fill it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plslam_torch.models import burst

    run_chunk, shares, names = burst.BurstStep.run_chunk, [], collections.Counter()

    def profiled(self, *args):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_chunk(self, *args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                busy += e.duration_ns()
                names[e.name()[:60]] += e.duration_ns()
        shares.append((wall, 1e-9 * busy))
        return out

    burst.BurstStep.run_chunk = profiled
    try:
        burst_run(dev, path, cfg, meta, BURST, max_frames=frames)
    finally:
        burst.BurstStep.run_chunk = run_chunk
    for wall, busy in shares:
        log(f"  (burst, profiled) chunk of {BURST}: wall {1e3 * wall:.1f} ms (profiler on), device "
            f"busy {1e3 * busy:.1f} ms = {100 * busy / wall:.1f} %")
    total = sum(names.values())
    for name, ns in names.most_common(8):
        log(f"    {ns / 1e6:8.1f} ms  {100 * ns / total:5.1f} %  {name}")


def run_burst(dev):
    """Phase 7: burst replay on the card. The smoke set through streaming and
    through `burst=8` in turns, the first burst run's kernel calls held
    against their plain versions; the bounds against streaming; the host's
    waits counted; then the loop scene's full-width configuration with loop
    closure in burst. Returns (the first burst run's launches, its kernels'
    numbers by kernel)."""
    import torch

    path, _ = render_dataset()
    meta = np.load(os.path.join(path, "meta.npz"))
    cfg = smoke_config(meta)
    n_cam, n_pub = _published(len(os.listdir(os.path.join(path, "mav0", "cam0", "data"))))
    runs = collections.defaultdict(list)
    for i, (label, b) in enumerate((("streaming", 0), ("burst", BURST), ("burst", BURST),
                                    ("streaming", 0))):
        if i == 1:  # the run whose launches the kernels line reports
            with burst_kernel_calls() as calls:
                runs[label].append(burst_run(dev, path, cfg, meta, b))
        else:
            runs[label].append(burst_run(dev, path, cfg, meta, b))
        describe_burst(label + (" (its kernel calls kept)" if i == 1 else ""), runs[label][-1])
    for label in ("streaming", "burst"):
        fps = [n / wall for _, _, wall, n, _, _ in runs[label]]
        log(f"  {label}: camera frames/s {[round(f, 2) for f in fps]} (mean {np.mean(fps):.2f})")
    stream = runs["streaming"][0][0]
    for run in runs["burst"]:
        n_burst, n_chunks, _ = describe_burst("burst, checked", run)
        if n_burst == 0 or n_chunks < 2:
            raise AssertionError(f"(burst) burst did not engage: {n_burst} frames")
        burst_vs_streaming("burst", stream, run[0])
        if not run[5] < ATE_LIMIT_M:
            raise AssertionError(f"(burst) ATE {run[5]:.4f} m ≥ {ATE_LIMIT_M} m")
        launches = run[1]
        if launches != {"lk_track": n_cam - 1, "hamming_matrix": n_pub}:
            raise AssertionError(f"(burst) launches {launches}: expected LK {n_cam - 1} "
                                 f"(tracked frames), Hamming {n_pub} (published frames)")
    burst_launches = runs["burst"][0][1]
    rows = hold_burst_calls(calls)
    del calls

    for label, b in (("streaming", 0), ("burst", BURST)):
        total, frames, per_chunk, sites = count_syncs(dev, path, cfg, meta, b)
        log(f"  ({label}) host waits on the card over {SYNC_FRAMES} published frames: {total} "
            f"({total / max(frames, 1):.1f} a published frame); inside each chunk of {BURST}: "
            f"{per_chunk}" + (f"; the first chunk's by line: {dict(sites.most_common())}"
                              if sites else ""))
    profile_burst_chunks(dev, path, cfg, meta)

    # the loop scene's full width with loop closure, in burst
    lpath, _ = render_dataset("loop")
    lmeta = np.load(os.path.join(lpath, "meta.npz"))
    _, full = loop_configs(lmeta)
    run = burst_run(dev, lpath, full, lmeta, BURST, loop=True)
    (ts, ps, _, est, pg), launches, _, n_cam_l, blog, ate = run
    n_burst, _, _ = describe_burst("loop scene (b), burst", run)
    searched = [r for r in pg.stats if r["outcome"] not in ("no_window_points", "no_descriptors")]
    refined = [e for e in pg.edges if e["loop"] and "t_pnp" in e]
    log(f"  (loop scene (b), burst) keyframes {pg.n}, loops {pg.loop_count} ({len(refined)} refined "
        f"by the relo round trip), searches reaching the match {len(searched)}")
    if not (pg.loop_count >= 1 and n_burst > 0 and ate < ATE_LIMIT_M
            and np.all(np.isfinite(ps)) and len(ts) >= MIN_POSES):
        raise AssertionError(f"(loop scene (b), burst) loops {pg.loop_count}, burst frames "
                             f"{n_burst}, ATE {ate:.4f} m, {len(ts)} poses")
    n_pub_l = _published(n_cam_l)[1]
    if launches != {"lk_track": n_cam_l - 1, "hamming_matrix": n_pub_l + len(searched)}:
        raise AssertionError(f"(loop scene (b), burst) launches {launches}: expected LK "
                             f"{n_cam_l - 1}, Hamming {n_pub_l} + {len(searched)} searches")
    torch.cuda.synchronize()
    return burst_launches, rows


def main():
    import torch

    from plslam_torch.utils.measure import card_info

    log(card_info())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    dev = torch.device("cuda", 0)

    from plslam_torch.ops.kernels import _build

    log("phase 2: build the kernels")
    t0 = time.perf_counter()
    so = _build.build()
    log(f"  built {os.path.relpath(so)} from {len(_build.sources())} sources "
        f"in {time.perf_counter() - t0:.1f} s")
    with open(so + ".log") as fh:
        for line in fh.read().strip().splitlines():
            log(f"  nvcc: {line}")

    log("phase 3: LK kernel (both formulations) vs plain versions on the card")
    lk_rows = check_lk_kernel(dev)
    log("phase 4: Hamming kernel vs plain version on the card")
    ham_rows = check_hamming_kernel(dev)

    log("phase 5: run_euroc on the card (binary lines, then points only)")
    launches = run_main_path(dev)
    time_line_tick(dev)
    run_points_only(dev)
    pallas_launches = drive_frontends(dev)
    profile_short_run(dev, frames=24)

    log("phase 6: the loop scene, run_euroc(loop_closure=True) on the card")
    search_launches, search_err = run_loop_scene(dev)

    log("phase 7: burst replay, run_euroc(burst=8) on the card")
    burst_launches, burst_rows = run_burst(dev)

    print(json.dumps({"kernels": [
        {"name": "lk_track fast", "route": "cuda", "source": LK_SOURCE, "replaces": LK_FAST_REPLACES,
         "launches": launches["lk_track"], **lk_rows["fast"], "library_ms": None},
        {"name": "lk_track pallas", "route": "cuda", "source": LK_SOURCE,
         "replaces": LK_PALLAS_REPLACES, "launches": pallas_launches, **lk_rows["pallas"],
         "library_ms": None},
        {"name": "hamming_matrix", "route": "cuda", "source": HAMMING_SOURCE,
         "replaces": HAMMING_REPLACES, "launches": launches["hamming_matrix"],
         **ham_rows[HAMMING_SHAPES[0]]},
        {"name": "lk_track fast, burst", "route": "cuda", "source": LK_SOURCE,
         "replaces": LK_FAST_REPLACES, "launches": burst_launches["lk_track"],
         **burst_rows["lk_track"]},
        {"name": "hamming_matrix, burst", "route": "cuda", "source": HAMMING_SOURCE,
         "replaces": HAMMING_REPLACES, "launches": burst_launches["hamming_matrix"],
         **burst_rows["hamming_matrix"]},
        {"name": "hamming_matrix loop search", "route": "cuda", "source": HAMMING_SOURCE,
         "replaces": HAMMING_REPLACES, "launches": search_launches,
         **{**ham_rows[128, 256],
            "max_abs_err": max(search_err, ham_rows[128, 256]["max_abs_err"])}},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
