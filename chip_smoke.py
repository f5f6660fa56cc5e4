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
  8. the command line and the tools around `run_euroc`: (a) phase 5's
     configuration written as a reference-format YAML and run through
     `python -m plslam_torch run` in a subprocess (its launches counted):
     its TUM file holds phase 5's poses within 1e-6 m and its score line
     phase 5's ATE within 1e-4 m, and `eval` of that file prints the same
     score; (b) an `Estimator` at phase 5's width on the smoke recipe's
     simulator observations, 40 published frames uninterrupted against a
     checkpoint saved after 25 and loaded into a fresh `Estimator` on the
     card: equal bit for bit; save and load ms, the npz size; (c)
     intrinsic calibration on the card (`tests/test_calibration.py`'s 8
     views and a 40-view set), held to that test's bounds and, for the 8
     views, to the CPU's result within 1e-6; ms a call by CUDA events; (d)
     6(a)'s configuration with `tracker.show_track`: a track image every
     4th camera frame, a match image a loop, LK launches = tracked
     frames, Hamming launches = keyframe searches, a trajectory other than
     6(a)'s (the visualizer runs every frame's full tick, as on the CPU),
     frames/s beside 6(a)'s; its last LK call and every Hamming call held
     against the plain versions and timed for the kernels line.
  9. the parallel solvers and the large-window runners at phase 5's
     solver widths (window 10, 192 features, 64 lines): (a) 11 windows of
     the smoke recipe's simulator through `batched_optimize_windows(
     devices=[cuda:0])` against a loop of `optimize_window`, both timed by
     CUDA events, float64 within 1e-8 m (the float32 gap logged); (b) one
     window landmark-sharded, stacked L = 1, 4, 8 against `optimize_window`
     (float64 within 1e-5 m / 1e-4 m/s; the float32 gap logged), through a
     one-rank NCCL group (bit for bit the stacked L = 4) and through two
     gloo ranks on cuda:0 in subprocesses (within 1e-6 of it), ms an LM
     iteration each; (c) `consensus_distributed_solve` on a 3 × 2 grid
     (`tests/test_mesh2d.py`'s recipe; within 2e-2 m of the truth); (d)
     `run_synthetic_large_window` on `tests/test_large_window.py`'s recipe,
     held to that test's assertions; (e) `run_euroc_large_window` on the
     smoke set (kf_stride 2, a 5 × 4 grid): the live keyframe poses equal
     phase 5's within 1e-6 m, both ATEs < 0.4 m, LK launches = tracked
     frames, Hamming launches = published frames, its last LK call and
     every Hamming call held against the plain versions and timed for the
     kernels line; (f) `tests/test_large_window.py`'s images test (its
     12-s render, 2 × 4 grid, float64) held to its assertions.
  10. the structured normal-equation assembly (`models/assembly.py`) and
     the last helpers, at phase 5's solver widths on 9(a)'s first window
     (no kernel of the port is launched): (a) float64, for each line chart,
     `assemble`'s H and b against the dense `linearize`'s JᵀJ, Jᵀr within
     1e-9 × max (the worst relative gap logged); (b)
     `optimize_window(structured=True)` against the blocks path after 8 LM
     iterations, float64 within 1e-8 m, float32 the gap and both accept
     sequences (replayed), and where they part, the step, λ and trial
     costs; (c) float32, by CUDA events in turns, medians over 20 rounds:
     one `assemble` (alone and with `schur_solve`), its scatter alone, one
     `linearize_blocks` + `schur_solve_blocks`, one whole `optimize_window`
     per path replayed from a CUDA graph (each path must capture; the
     replay held against one eager solve); device operations and device
     time an LM iteration per path (torch.profiler); the scatter's float adds,
     device time and bound; (d) float64 `imu.preintegrate_sequential`
     against `preintegrate` over one camera interval of the smoke set's
     200-Hz IMU and over 512 steps, at `tests/test_imu.py`'s bounds, both
     timed; (e) the run-level scenarios that the CPU tests mark `slow`
     (`tests/robustness_scenarios.py`: frame drops, corrupted observations,
     feature collapse, the IMU-pad overflow, oracle init with
     `imu_rate_pose`, the incamera line chart, the deferred solve bit for
     bit) through the port on the card at the reference's settings, with
     the reference tests' assertions, one after another.
  11. one JSON line of kernel results (rows for the burst run's LK and
     Hamming calls, the loop search's, the CLI run's, the show_track run's
     and the large-window run's beside the main path's), then the last line
     {"ok": true, "device": {...}}.
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
    rendered set. Returns (the launch counts of the run, its (ts, ps, qs),
    its ATE)."""
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
    return launches, (ts, ps, qs), ate


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
    version, camera frames/s)."""
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
    return (ts, ps, qs, est, pg), meta, launches, len(searched), err, n_cam / wall


def run_loop_scene(dev):
    """Phase 6: (a) the JAX loop test's configuration, held to its
    assertions; (b) the full width. Returns the loop search's Hamming
    launches of (b), the search kernel's largest difference from its plain
    version over both runs' descriptor pairs, and (a)'s (ts, ps) and camera
    frames/s."""
    from plslam_torch.eval.metrics import ate_rmse
    from plslam_torch.utils import quat_np as qnp

    path, render_s = render_dataset("loop")
    log(f"  dataset: {path} (rendered in {render_s:.1f} s)")
    reference, full = loop_configs(np.load(os.path.join(path, "meta.npz")))

    (ts, ps, _, est, pg), meta, _, _, err_a, fps_a = run_loop_case(dev, "a", reference,
                                                                   use_lines=False)
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
    run_a = (ts, ps, fps_a)

    (ts, ps, _, _, pg), meta, launches, searched, err_b, _ = run_loop_case(dev, "b", full,
                                                                           use_lines=True)
    ate = float(ate_rmse(ts, ps, meta["gt_t"], meta["gt_p"], align="yaw"))
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"(b) ATE {ate:.4f} m ≥ {ATE_LIMIT_M} m")
    return searched, max(err_a, err_b), run_a


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
def burst_kernel_calls(burst_steps_only=True, last_lk_only=False):
    """Keep every LK and Hamming kernel call that the burst steps make while
    the block runs (calls outside `BurstStep.run_chunk`, the streamed
    frames', are not kept; with `burst_steps_only=False` every call is):
    the wrapper's arguments and the outputs it returned, copied on the
    card, which waits for nothing; with `last_lk_only` only the last LK
    call is kept. Yields {"lk_track": [(args, kwargs, outputs)],
    "hamming_matrix": [...]}."""
    import torch

    from plslam_torch.models import burst
    from plslam_torch.ops.kernels import hamming, lk

    calls = {"lk_track": [], "hamming_matrix": []}
    inside = [not burst_steps_only]
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
                if last_lk_only and name == "lk_track":
                    calls[name].clear()
                calls[name].append((copy(args), copy(kwargs), copy(out)))
            return out
        return call

    def chunk(self, *args):
        inside[0] = True
        try:
            return run_chunk(self, *args)
        finally:
            inside[0] = not burst_steps_only

    burst.BurstStep.run_chunk = chunk
    lk.lk_track_cuda = kept("lk_track", lk_cuda)
    hamming.hamming_matrix_cuda = kept("hamming_matrix", ham_cuda)
    try:
        yield calls
    finally:
        burst.BurstStep.run_chunk = run_chunk
        lk.lk_track_cuda, hamming.hamming_matrix_cuda = lk_cuda, ham_cuda


def hold_burst_calls(calls, label="burst"):
    """Each kept call's output against the kernel's plain version on
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
        raise AssertionError(f"({label}) kept {len(calls['lk_track'])} LK and "
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
    log(f"  ({label}) held {len(calls['lk_track'])} LK calls ({tracked} points tracked by both, "
        f"max |Δpos| {lk_err:.3e} px) and {len(calls['hamming_matrix'])} Hamming calls (shapes "
        f"{dict(shapes)}, max |Δ| {ham_err}) against their plain versions")
    for miss in misses:
        log(f"  ({label}) MISS {miss}")
    if misses:
        raise AssertionError(f"({label}) {len(misses)} kernel calls disagree with their plain versions")

    args, kwargs, _ = calls["lk_track"][-1]
    a, plain = lk_plain(args, kwargs)
    ms = cuda_time_ms(lambda: lk.lk_track_cuda(*args, **kwargs), reps=200)
    plain_ms = cuda_time_ms(plain)
    bound_ms, bound_by = lk_track_bound(a["pyr_prev"], a["pyr_cur"], a["pts_prev"], a["valid"],
                                        a["formulation"], a["iters"])
    rows = {"lk_track": dict(max_abs_err=lk_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)}
    log(f"  ({label}) LK on the last call's inputs ({a['pts_prev'].shape[0]} points): {ms:.5f} ms "
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
    log(f"  ({label}) Hamming on the last call's inputs ({len(d1)}×{len(d2)}): {ms:.5f} ms by CUDA "
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


# ---- phase 8: the command line and the tools around run_euroc ----
ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT_FRAMES, CKPT_SAVE_AT = 40, 25  # published frames of 8(b), and the one it saves after
CALIB_VIEWS = (8, 40)  # `tests/test_calibration.py`'s set, and a larger one
CALIB_GT = (460.0, 455.0, 370.0, 245.0, -0.25, 0.06, 5e-4, -3e-4)  # fx fy cx cy k1 k2 p1 p2
# `python -m plslam_torch` as `-m` runs it, then the kernels' launch counts on stderr
CLI_COUNTING = """import json, runpy, sys
from plslam_torch.ops.kernels import hamming, lk
sys.argv[0] = "plslam_torch"
runpy.run_module("plslam_torch", run_name="__main__", alter_sys=True)
print(json.dumps({"lk_track": lk.LAUNCHES, "hamming_matrix": hamming.LAUNCHES}), file=sys.stderr)
"""


def write_smoke_yaml(cfg, path):
    """`cfg` (phase 5's configuration) as a reference-format YAML: each field
    that differs from `PLSlamConfig.from_yaml`'s defaults through the key it
    reads. Raises unless the file loads back to `cfg`."""
    from plslam_torch.config import PLSlamConfig

    c, tr, so, ex = cfg.camera, cfg.tracker, cfg.solver, cfg.extrinsic

    def num(v):  # a float YAML 1.1 reads back exactly (a dot and a signed exponent)
        return f"{float(v):.17e}"

    text = f"""%YAML:1.0
image_width: {c.image_width}
image_height: {c.image_height}
distortion_parameters:
   k1: {num(c.k1)}
   k2: {num(c.k2)}
   p1: {num(c.p1)}
   p2: {num(c.p2)}
projection_parameters:
   fx: {num(c.fx)}
   fy: {num(c.fy)}
   cx: {num(c.cx)}
   cy: {num(c.cy)}
max_cnt: {tr.max_cnt}
min_dist: {tr.min_dist}
equalize: {int(tr.equalize)}
min_score: {num(tr.min_score)}
max_lines: {tr.max_lines}
line_desc: {tr.line_desc}
max_features: {so.max_features}
max_line_feats: {so.max_line_feats}
window_size: {so.window_size}
max_num_iterations: {so.max_num_iterations}
solver_dtype: {so.dtype}
focal_length: {num(so.focal_length)}
estimate_extrinsic: {ex.estimate_extrinsic}
extrinsicRotation: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [{", ".join(num(v) for v in ex.rot)}]
extrinsicTranslation: !!opencv-matrix
   rows: 3
   cols: 1
   dt: d
   data: [{", ".join(num(v) for v in ex.trans)}]
loop_closure: {int(cfg.loop.loop_closure)}
"""
    with open(path, "w") as fh:
        fh.write(text)
    back = PLSlamConfig.from_yaml(path)
    diff = [f.name for f in dataclasses.fields(cfg) if getattr(back, f.name) != getattr(cfg, f.name)]
    if diff:
        raise AssertionError(f"the YAML loads back with other {diff} sections")
    return path


def _cli(args, timeout=900):
    """`python -m plslam_torch <args>` in a subprocess from the checkout, its
    kernel launches counted. Returns (stdout lines, launches, wall s)."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_COUNTING, *args], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m plslam_torch {' '.join(args)} exited "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    return proc.stdout.strip().splitlines(), json.loads(proc.stderr.strip().splitlines()[-1]), wall


def _same_score(a, b):
    """Two score lines agree: the same keys, and values equal but for one
    unit in the last place kept (4 decimals in m, 3 in deg): a TUM file
    keeps 6 decimals, which can move a rounding."""
    last = {"ate_rmse_m": 1e-4, "rpe_trans_m": 1e-4, "rpe_rot_deg": 1e-3}

    def same(k):
        if k not in last:
            return a[k] == b[k]
        return abs(a[k] - b[k]) <= last[k] * 1.0001 or (np.isnan(a[k]) and np.isnan(b[k]))

    return a.keys() == b.keys() and all(same(k) for k in a)


def cli_run(main_run):
    """8(a): `python -m plslam_torch run` on the smoke set with phase 5's
    configuration as YAML, its TUM file against phase 5's in-process run,
    then `eval` of that file. Returns the run's launches."""
    from plslam_torch.eval.metrics import read_tum

    (ts5, ps5, _), ate5 = main_run
    path, _ = render_dataset()
    cfg = smoke_config(np.load(os.path.join(path, "meta.npz")))
    n_cam, n_pub = _published(len(os.listdir(os.path.join(path, "mav0", "cam0", "data"))))
    tmp = tempfile.mkdtemp(prefix="plslam_torch_cli_")
    yaml_path = write_smoke_yaml(cfg, os.path.join(tmp, "smoke.yaml"))
    out = os.path.join(tmp, "out")
    lines, launches, wall = _cli(["run", "--data", path, "--config", yaml_path, "--output", out,
                                  "--quiet"])
    score = json.loads(lines[-1])
    ts, ps, qs = read_tum(os.path.join(out, "traj_vio.tum"))
    log(f"  run: {wall:.1f} s wall (the process's start, the kernels loaded, {n_cam} camera "
        f"frames); {len(ts)} poses; launches {launches}; score {score}")
    if len(ts) != len(ts5):
        raise AssertionError(f"the CLI wrote {len(ts)} poses, phase 5 emitted {len(ts5)}")
    dt, dp = np.abs(ts - ts5).max(), np.abs(ps - ps5).max()
    log(f"  run against phase 5's run: max |Δt| {dt:.3e} s, max |Δp| {dp:.3e} m (TUM keeps 6 "
        f"decimals), ATE {score['ate_rmse_m']} against {ate5:.6f} m")
    if not (dt <= 1e-6 and dp <= 1e-6 and abs(score["ate_rmse_m"] - ate5) <= 1e-4):
        raise AssertionError("the CLI's trajectory or ATE is not phase 5's")
    if launches != {"lk_track": n_cam - 1, "hamming_matrix": n_pub}:
        raise AssertionError(f"CLI launches {launches}: expected LK {n_cam - 1}, Hamming {n_pub}")
    lines, _, wall = _cli(["eval", "--est", os.path.join(out, "traj_vio.tum"), "--data", path])
    again = json.loads(lines[-1])
    log(f"  eval: {wall:.1f} s wall; score {again}")
    if not _same_score(again, score):
        raise AssertionError(f"eval printed {again}, run printed {score}")
    return launches


def _drive_synthetic(est, seq, k0, k1, stride=2):
    """Published frames [k0, k1) of a simulator sequence, in the manner of
    `tests/test_io.py::_run_frames` (index-determined IMU dts, oracle
    initialization). Returns the latest pose's position after each frame."""
    imu_t = np.asarray(seq.imu_t)
    frame_t = np.asarray(seq.frame_t)[::stride]
    obs, valid = np.asarray(seq.obs)[::stride], np.asarray(seq.obs_valid)[::stride]
    gt_p, gt_q, gt_v = (np.asarray(a)[::stride] for a in (seq.gt_p, seq.gt_q, seq.gt_v))
    acc, gyr = np.asarray(seq.imu_acc), np.asarray(seq.imu_gyr)
    out = []
    for k in range(k0, k1):
        lo = frame_t[k - 1] if k > 0 else -np.inf
        for i in np.nonzero((imu_t > lo + 1e-9) & (imu_t <= frame_t[k] + 1e-9))[0]:
            est.process_imu(imu_t[i] - imu_t[i - 1] if i > 0 else 0.005, acc[i], gyr[i])
        vis = np.nonzero(valid[k])[0]
        est.process_frame(float(frame_t[k]), vis, obs[k, vis], None, None, None,
                          oracle_state={"p": gt_p[k], "q": gt_q[k], "v": gt_v[k]})
        out.append(est.latest_pose()[1])
    return np.asarray(out)


def checkpoint_resume(dev):
    """8(b): an Estimator at phase 5's width on the smoke recipe's simulator
    observations, CKPT_FRAMES published frames uninterrupted against a save
    after CKPT_SAVE_AT, a load into a fresh Estimator on the card and the
    rest. The resumed run must equal the uninterrupted one bit for bit."""
    import torch

    from plslam_torch.io import checkpoint, synthetic
    from plslam_torch.models.estimator import Estimator
    from plslam_torch.utils.geometry import quat_to_rot

    seq = synthetic.make_sequence(params=synthetic.TrajectoryParams(**TRAJECTORY), **SEQUENCE)
    cfg = smoke_config({"R_bc": quat_to_rot(seq.q_bc).numpy(), "p_bc": seq.p_bc.numpy()})
    full = Estimator(cfg, device=dev)
    p_full = _drive_synthetic(full, seq, 0, CKPT_FRAMES)
    half = Estimator(cfg, device=dev)
    p_half = _drive_synthetic(half, seq, 0, CKPT_SAVE_AT)
    if not (half.initialized and half.prior is not None):
        raise AssertionError("8(b): no initialized window with a prior to save")
    path = os.path.join(tempfile.mkdtemp(prefix="plslam_torch_ckpt_"), "estimator.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_estimator(half, path)
    save_ms = 1e3 * (time.perf_counter() - t0)
    resumed = Estimator(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.load_estimator(resumed, path)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    p_res = np.concatenate([p_half, _drive_synthetic(resumed, seq, CKPT_SAVE_AT, CKPT_FRAMES)])
    dp = float(np.abs(p_res - p_full).max())
    dwin = max(float(np.abs(getattr(resumed, n) - getattr(full, n)).max())
               for n in ("p", "q", "v", "ba", "bg"))
    solved = sum(1 for m in full.metrics if "cost" in m)
    log(f"  {CKPT_FRAMES} published frames ({solved} solved, {cfg.solver.max_features} features, "
        f"window {cfg.solver.window_size}, {cfg.solver.dtype}), saved after {CKPT_SAVE_AT}: save "
        f"{save_ms:.2f} ms, load {load_ms:.2f} ms, npz {os.path.getsize(path)} B; resumed against "
        f"uninterrupted: max |Δp| {dp:.3e} m over the poses, {dwin:.3e} over the final window")
    if dp != 0.0 or dwin != 0.0:
        raise AssertionError(f"8(b): the resumed run is not the uninterrupted one (|Δp| {dp:.3e})")


def _calibration_views(n_views, seed=0, noise=0.1):
    """`tests/test_calibration.py`'s views of a 9×6 board with 4-cm squares
    (its first 8 views are that test's), made with the port's camera."""
    import torch

    from plslam_torch.ops import cameras
    from plslam_torch.utils import geometry as geo

    rng = np.random.default_rng(seed)
    cam = cameras.PinholeRadTan.create(*CALIB_GT, dtype=torch.float64)
    gx, gy = np.meshgrid(np.arange(9) * 0.04, np.arange(6) * 0.04)
    obj = np.stack([gx.ravel(), gy.ravel()], axis=1)
    obj3 = torch.as_tensor(np.concatenate([obj, np.zeros((len(obj), 1))], axis=1))
    views = []
    for _ in range(n_views):
        R = geo.so3_exp(torch.as_tensor(rng.uniform(-0.4, 0.4, 3)))
        t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), rng.uniform(0.5, 0.9)])
        p_c = geo.quat_rotate(geo.rot_to_quat(R).expand(len(obj), 4), obj3) + torch.as_tensor(t)
        uv = cameras.project(cam, p_c).numpy().copy()
        views.append(uv + rng.standard_normal(uv.shape) * noise)
    return obj, np.stack(views)


def calibration_on_card(dev):
    """8(c): intrinsic calibration on the card, held to the JAX test's
    bounds, the 8-view set also to the CPU result (1e-6 in every
    intrinsic); ms a call by CUDA events for each set."""
    from plslam_torch.ops.calibration import calibrate_pinhole_radtan
    from plslam_torch.utils.measure import cuda_time_ms

    for n in CALIB_VIEWS:
        obj, views = _calibration_views(n)
        cam, rms = calibrate_pinhole_radtan(obj, views, device=dev)
        est = np.array([float(v) for v in cam])
        err = est - np.array(CALIB_GT)
        ms = cuda_time_ms(lambda: calibrate_pinhole_radtan(obj, views, device=dev), reps=3,
                          warmup=1)
        log(f"  {n} views × {len(obj)} corners: {ms:.1f} ms a call by CUDA events; rms {rms:.5f} "
            f"px; fx fy cx cy k1 k2 p1 p2 − truth {np.array2string(err, precision=5)}")
        bounds = np.array([1.0, 1.0, 1.5, 1.5, 0.01, 0.03])
        if not (cam.fx.is_cuda and rms < 0.2 and np.all(np.abs(err[:6]) < bounds)):
            raise AssertionError(f"8(c): {n} views miss the calibration test's bounds")
        if n == CALIB_VIEWS[0]:
            cpu, rms_cpu = calibrate_pinhole_radtan(obj, views, device="cpu")
            d = float(np.abs(est - np.array([float(v) for v in cpu])).max())
            log(f"  {n} views, card against CPU: max |Δ| {d:.3e} over the intrinsics, rms "
                f"{abs(rms - rms_cpu):.3e}")
            if not d <= 1e-6:
                raise AssertionError(f"8(c): the card's intrinsics are {d:.3e} from the CPU's")


def show_track_loop(dev, run_a):
    """8(d): phase 6(a)'s configuration with `tracker.show_track` on: PNG
    counts (a track overlay every 4th camera frame, a match image a loop),
    the trajectory against 6(a)'s (the visualizer runs every camera frame's
    full tick, so it differs, as on the CPU), frames/s beside 6(a)'s, the
    launches; the last LK call and every Hamming call held against their
    plain versions. Returns (launches, the kernels' numbers by kernel)."""
    import torch

    from plslam_torch import runner
    from plslam_torch.eval.metrics import ate_rmse
    from plslam_torch.ops.kernels import hamming, lk

    ts_a, ps_a, fps_a = run_a
    path, _ = render_dataset("loop")
    meta = np.load(os.path.join(path, "meta.npz"))
    reference, _ = loop_configs(meta)
    out_dir = tempfile.mkdtemp(prefix="plslam_torch_viz_")
    cfg = dataclasses.replace(reference, output_path=out_dir,
                              tracker=dataclasses.replace(reference.tracker, show_track=True))
    n_cam, _ = _published(len(os.listdir(os.path.join(path, "mav0", "cam0", "data"))))
    with burst_kernel_calls(burst_steps_only=False, last_lk_only=True) as calls:
        lk.LAUNCHES = hamming.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, ps, _, est, pg = runner.run_euroc(path, cfg, use_lines=False, loop_closure=True,
                                              device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"lk_track": lk.LAUNCHES, "hamming_matrix": hamming.LAUNCHES}
    names = os.listdir(os.path.join(out_dir, "viz"))
    tracks = sum(n.startswith("track_") for n in names)
    matches = sum(n.startswith("match_") for n in names)
    searched = [r for r in pg.stats if r["outcome"] not in ("no_window_points", "no_descriptors")]
    refined = [e for e in pg.edges if e["loop"] and "t_pnp" in e]
    ate = float(ate_rmse(ts, ps, meta["gt_t"], meta["gt_p"], align="yaw"))
    common, ia, ib = np.intersect1d(np.round(ts, 6), np.round(ts_a, 6), return_indices=True)
    dp = float(np.abs(ps[ia] - ps_a[ib]).max()) if len(common) else float("nan")
    log(f"  show_track: {n_cam} camera frames in {wall:.2f} s = {n_cam / wall:.2f} camera "
        f"frames/s against 6(a)'s {fps_a:.2f}; {tracks} track and {matches} match images; "
        f"loops {pg.loop_count} ({len(refined)} refined by the relo round trip); launches "
        f"{launches}; ATE(yaw) {ate:.4f} m; against 6(a): {len(ts)} vs {len(ts_a)} poses, max "
        f"|Δp| {dp:.4f} m over {len(common)} common stamps")
    checks = {
        "track images = ⌈camera frames / 4⌉": tracks == -(-n_cam // 4),
        "match images = loops": matches == pg.loop_count >= 1,
        "LK launches = tracked frames": launches["lk_track"] == n_cam - 1,
        "Hamming launches = keyframe searches": launches["hamming_matrix"] == len(searched),
        f"≥ {MIN_POSES} finite poses": len(ts) >= MIN_POSES and bool(np.all(np.isfinite(ps))),
        "stream ATE < 1 m (6(a)'s gate)": ate < 1.0,
        "the trajectory is not 6(a)'s (as on the CPU)": not (
            len(ts) == len(ts_a) and np.array_equal(ps, ps_a)),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"8(d): {failed}")
    return launches, hold_burst_calls(calls, label="show_track")


# ---- phase 9: the parallel solvers and the large-window runners ----
DP_BATCH = 11  # windows of 9(a): the JAX docstring's "11 EuRoC sequences"
DP_STEP = 20  # camera frames between the first frames of 9(a)'s windows
SHARDS = (1, 4, 8)  # 9(b)'s stacked landmark shards (192 / 8 and 64 / 8 divide)
LM_ITERS = 8  # the estimator's
# 9(f): `tests/test_large_window.py::test_distributed_large_window_from_images`'s recipe
DATASETS["large_window"] = (
    TRAJECTORY,
    dict(duration=12.0, n_points=500, n_lines=0, seed=31, acc_noise=0.18, gyr_noise=0.009,
         acc_bias=0.1, gyr_bias=0.004),
    dict(h=H, w=W, max_frames=240, blob_sigma=3.0, style="textured"))
GLOO_RANK = """import sys
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke.gloo_rank(int(sys.argv[1]), {store!r}, {window!r}, sys.argv[2])
"""


def smoke_windows(dev, dtype, count=DP_BATCH):
    """`count` full-width windows (phase 5's solver widths) packed from the
    smoke recipe's simulator, each perturbed as `tests/test_dp.py` does.
    Returns (solver config, layout, ground-truth pairs, perturbed pairs)."""
    import torch

    from plslam_torch.io import synthetic
    from plslam_torch.models import packing
    from plslam_torch.models.state import layout, retract

    cfg = smoke_config(np.load(os.path.join(render_dataset()[0], "meta.npz"))).solver
    lay = layout(cfg)
    seq = synthetic.make_sequence(params=synthetic.TrajectoryParams(**TRAJECTORY), **SEQUENCE)
    rng = np.random.default_rng(5)
    gt, pert = [], []
    for b in range(count):
        frames = list(range(b * DP_STEP, b * DP_STEP + 2 * lay.nw, 2))
        st, f = packing.factors_from_synthetic(seq, frames, cfg, lay, dtype=dtype, device=dev)
        d = np.zeros(lay.dim)
        d[6: lay.nw * 6] = rng.standard_normal((lay.nw - 1) * 6) * 0.005
        gt.append((st, f))
        pert.append((retract(st, torch.as_tensor(d, dtype=dtype, device=dev), lay), f))
    return cfg, lay, gt, pert


def timed(fn):
    """(fn(), ms) by CUDA events around one call."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def lm_trace(state, f, lay, cfg, num_iters, structured=False):
    """`solver.optimize_window`'s LM loop (its default options, or with
    `structured=True`) run step by step through `solver.lm_step`. Returns
    (the final positions, [num_iters, 4] rows of (accepted, λ of the step,
    the cost at the step's start, its trial cost)); vmappable. 9(a) holds
    the positions to the solve's own, bit for bit, so that the rows are the
    solve's."""
    import torch

    from plslam_torch.models import residuals as res
    from plslam_torch.models import solver

    mask = solver.free_mask(f, lay, cfg, False, False)
    groups = res.residual_groups(state, f, lay, cfg.focal_length, cfg.line_param)
    st = state
    lam = torch.full((), cfg.lm_lambda_init, dtype=state.p.dtype, device=state.p.device)
    rows = []
    for _ in range(num_iters):
        lam_step = lam
        st, groups, lam, accept, cost_here, cost_try = solver.lm_step(
            st, groups, lam, f, lay, cfg, mask, structured)
        rows.append(torch.stack([accept.to(lam.dtype), lam_step, cost_here, cost_try]))
    return solver.reanchor(st, state, line_param=cfg.line_param).p, torch.stack(rows)


def normal_matrix(state, f, lay, cfg):
    """The camera block J_camᵀJ_cam of the first LM step of
    `solver.optimize_window` (its default options); vmappable."""
    from plslam_torch.models import residuals as res
    from plslam_torch.models import solver

    mask = solver.free_mask(f, lay, cfg, False, False)
    groups = res.residual_groups(state, f, lay, cfg.focal_length, cfg.line_param)
    pt_w, ln_w, relo_w = res.weights_of_groups(groups, cfg.cauchy_c)
    _, J_cam, _ = solver.linearize_blocks(state, f, lay, cfg.focal_length, pt_w, ln_w, mask,
                                          relo_w, cfg.line_param)
    return J_cam.T @ J_cam


def dp_on_card(dev):
    """9(a): B = 11 windows through `batched_optimize_windows(devices=[cuda:0])`
    against a loop of 11 `optimize_window` calls, both timed by CUDA events.

    float64, 8 LM iterations: the positions agree within 1e-8 m. float32
    cannot be held to that: after 8 iterations the layouts part by cm in
    both packages, because λ falls 0.4× an accepted step from 1e-4 towards
    float32's epsilon while the reduced camera system's 4 gauge directions
    (x, y, z, yaw) have no curvature but λ, so at λ ~ 1e-6 its float32
    Cholesky fails (a NaN trial cost, a rejected step) in whichever layout
    rounding tips. So in float32: after one iteration (λ = 1e-4) each
    layout lies within 1e-3 m of the float64 step; `lm_trace` replays both
    solves bit for bit, and where their accept sequences part, the layout
    that rejected had a failed trial step — a non-finite cost or one ≥ 1 %
    above the step's start — not a near tie. Logged besides: each layout's
    distance to the float64 solve, the first step's JᵀJ error, a one-ulp
    nudge of the loop's input, and each window's accepts, final costs, gap
    and distance to the truth."""
    import torch

    from plslam_torch.models import solver
    from plslam_torch.parallel import dp

    ref = {}  # float64 loop positions after 1 and LM_ITERS iterations
    for dtype in (torch.float64, torch.float32):
        cfg, lay, gt, pert = smoke_windows(dev, dtype)
        states, factors = dp.stack_windows(pert)
        batched = lambda n: dp.batched_optimize_windows(  # noqa: E731
            states, factors, lay, cfg, num_iters=n, devices=[dev])
        loop = lambda n: [solver.optimize_window(s, f, lay, cfg, num_iters=n)  # noqa: E731
                          for s, f in pert]
        (st_1, _), singles_1 = batched(1), loop(1)  # warm-up, and the one-step check
        gap_1 = max(float((st_1.p[k] - s.p).abs().max()) for k, (s, _) in enumerate(singles_1))
        (st_b, cost_b), ms_b = timed(lambda: batched(LM_ITERS))
        singles, ms_l = timed(lambda: loop(LM_ITERS))
        gaps = [float((st_b.p[k] - s.p).abs().max()) for k, (s, _) in enumerate(singles)]
        name = str(dtype).split(".")[-1]
        log(f"  9(a) DP, {name}: {DP_BATCH} windows (window {cfg.window_size}, "
            f"{cfg.max_features} features, {cfg.max_line_feats} lines, {LM_ITERS} LM "
            f"iterations): batched {ms_b:.1f} ms, a loop of {DP_BATCH} optimize_window "
            f"{ms_l:.1f} ms (CUDA events; {ms_l / ms_b:.2f}×); max |Δp| batched vs loop "
            f"{max(gaps):.3e} m ({gap_1:.3e} m after one LM iteration)")
        if not torch.isfinite(cost_b).all():
            raise AssertionError(f"9(a): non-finite batched costs {cost_b.tolist()}")
        if dtype == torch.float64:
            if not max(gaps) <= 1e-8:
                raise AssertionError(f"9(a): f64 batched positions {max(gaps):.3e} m from the "
                                     "loop's")
            ref = {1: [s.p for s, _ in singles_1], LM_ITERS: [s.p for s, _ in singles],
                   "H": [normal_matrix(s, f, lay, cfg) for s, f in pert]}
            continue
        to64 = lambda a, b: float((a.double() - b).abs().max())  # noqa: E731
        l_1 = [s.p for s, _ in singles_1]
        for n, b_p, l_p in ((1, st_1.p, l_1),
                            (LM_ITERS, st_b.p, [s.p for s, _ in singles])):
            log(f"    after {n} LM iteration(s), |Δp| to the float64 loop, batched / loop (m): "
                + ", ".join(f"{to64(b_p[k], ref[n][k]):.2e} / {to64(l_p[k], ref[n][k]):.2e}"
                            for k in range(DP_BATCH)))
        if max(max(to64(p, r) for p, r in zip(ps, ref[1])) for ps in (st_1.p, l_1)) > 1e-3:
            raise AssertionError("9(a): an f32 layout's first step is over 1e-3 m from the f64 "
                                 "step")
        h32 = [normal_matrix(s, f, lay, cfg) for s, f in pert]
        hb = torch.func.vmap(lambda s, f: normal_matrix(s, f, lay, cfg))(states, factors)

        def rel(h, h64):  # the largest error of the Jacobi-scaled matrix the solve factors
            d = torch.rsqrt(torch.clamp(torch.diagonal(h64), min=1e-8))
            return float(((h.double() - h64) * d[:, None] * d[None, :]).abs().max())

        log("    the first step's camera block of JᵀJ, Jacobi-scaled, max |H - H_f64|, batched / "
            "loop: " + ", ".join(f"{rel(hb[k], ref['H'][k]):.1e} / {rel(h32[k], ref['H'][k]):.1e}"
                                 for k in range(DP_BATCH)))
        up = lambda a: torch.nextafter(a, torch.full_like(a, float("inf")))  # noqa: E731
        nudged = [solver.optimize_window(s._replace(p=up(s.p)), f, lay, cfg, num_iters=1)[0].p
                  for s, f in pert]
        log("    one LM iteration from positions one ulp up, |Δp| to the loop's (m): "
            + ", ".join(f"{float((a - s.p).abs().max()):.2e}"
                        for a, (s, _) in zip(nudged, singles_1)))
        p_tb, rows_b = torch.func.vmap(lambda s, f: lm_trace(s, f, lay, cfg, LM_ITERS))(
            states, factors)
        traced = [lm_trace(s, f, lay, cfg, LM_ITERS) for s, f in pert]
        if not (torch.equal(p_tb, st_b.p) and all(torch.equal(p, s.p) for (p, _), (s, _)
                                                   in zip(traced, singles))):
            raise AssertionError("9(a): the LM replay does not reproduce the f32 solves")
        torn = []
        for k, ((g, _), (_, rows_l)) in enumerate(zip(gt, traced)):
            rb, rl = rows_b[k].double().cpu().numpy(), rows_l.double().cpu().numpy()
            acc_b, acc_l = rb[:, 0].astype(int), rl[:, 0].astype(int)
            cost = lambda r: np.where(r[:, 0] > 0, r[:, 3], r[:, 2])[-1]  # noqa: E731
            err = [float(torch.linalg.norm(p - g.p, dim=-1).max()) for p in (st_b.p[k],
                                                                          singles[k][0].p)]
            line = (f"    window {k}: accepts batched {acc_b.tolist()} loop {acc_l.tolist()}; "
                    f"|Δp| {gaps[k]:.3e} m; final cost {cost(rb):.6g} / {cost(rl):.6g}; max "
                    f"|p - truth| {err[0]:.3e} / {err[1]:.3e} m")
            part = np.nonzero(acc_b != acc_l)[0]
            if len(part):
                i = int(part[0])
                rej = rl if acc_b[i] else rb
                failed = not np.isfinite(rej[i, 3]) or rej[i, 3] >= 1.01 * rej[i, 2]
                who = "loop" if acc_b[i] else "batched solve"
                line += (f"; part at step {i} (λ {rej[i, 1]:.2e}): the {who}'s trial cost "
                         f"{rej[i, 3]:.6g} against {rej[i, 2]:.6g} at the step's start")
                if not failed:
                    torn.append(k)
            log(line)
        if torn:
            raise AssertionError(f"9(a): f32 windows {torn} part at a near tie, not a failed step")


def _sharded_window(dev, dtype):
    """9(b)'s window: the first of 9(a)'s, perturbed as
    `tests/test_distributed.py` does (poses, velocities and biases)."""
    import torch

    from plslam_torch.models.state import retract

    cfg, lay, gt, _ = smoke_windows(dev, dtype, count=1)
    state, f = gt[0]
    rng = np.random.default_rng(9)
    nw = lay.nw
    delta = np.zeros(lay.dim)
    delta[6: nw * 6] = rng.standard_normal((nw - 1) * 6) * 0.005
    sb = rng.standard_normal((nw, 9))
    sb[:, 0:3] *= 0.01
    sb[:, 3:6] *= 5e-5
    sb[:, 6:9] *= 5e-6
    delta[lay.off_sb: lay.off_ext] = sb.reshape(-1)
    return cfg, lay, state, retract(state, torch.as_tensor(delta, dtype=dtype, device=dev), lay), f


def gloo_rank(rank, store, window, out):
    """One of 9(b)'s two gloo ranks on cuda:0: the window saved by the
    parent, 4 landmark shards, 2 a rank."""
    import torch
    import torch.distributed as dist

    from plslam_torch.parallel import distributed_ba as dba
    from plslam_torch.parallel import multihost

    multihost.init_distributed(init_method=f"file://{store}", world_size=2, rank=rank,
                               backend="gloo")
    cfg, lay, pert, f = torch.load(window, map_location="cuda:0", weights_only=False)
    mesh = dba.make_mesh(4, dist.group.WORLD)
    dba.distributed_optimize_window(pert, f, lay, cfg, mesh, num_iters=1)  # warm-up
    dist.barrier()
    (st, cost), ms = timed(lambda: dba.distributed_optimize_window(pert, f, lay, cfg, mesh,
                                                                   num_iters=LM_ITERS))
    torch.save({"p": st.p.cpu(), "v": st.v.cpu(), "inv_depth": st.inv_depth.cpu(),
                "line": st.line.cpu(), "cost": cost.cpu(), "ms": ms}, out)
    dist.barrier()
    dist.destroy_process_group()


def sharded_ba_on_card(dev):
    """9(b): one full-width window solved landmark-sharded three ways:
    stacked L = 1, 4, 8 against `optimize_window` (f64 within
    `test_distributed.py`'s 1e-5 m / 1e-4 m/s; the f32 gap reported);
    through a one-rank NCCL group (bit for bit the stacked L = 4); through
    two gloo ranks on cuda:0 (within 1e-6 m of the stacked L = 4)."""
    import subprocess

    import torch
    import torch.distributed as dist

    from plslam_torch.models import solver
    from plslam_torch.parallel import distributed_ba as dba
    from plslam_torch.parallel import multihost

    stacked = {}
    for dtype in (torch.float64, torch.float32):
        cfg, lay, state, pert, f = _sharded_window(dev, dtype)
        solver.optimize_window(pert, f, lay, cfg, num_iters=1)  # warm-up
        (single, _), ms_s = timed(lambda: solver.optimize_window(pert, f, lay, cfg,
                                                                 num_iters=LM_ITERS))
        name = str(dtype).split(".")[-1]
        log(f"  9(b) {name}: optimize_window {ms_s / LM_ITERS:.1f} ms an LM iteration; "
            f"max |p - truth| {float(torch.linalg.norm(single.p - state.p, dim=-1).max()):.3e} m")
        for n in SHARDS:
            mesh = dba.make_mesh(n)
            dba.distributed_optimize_window(pert, f, lay, cfg, mesh, num_iters=1)  # warm-up
            (st, cost), ms = timed(lambda: dba.distributed_optimize_window(
                pert, f, lay, cfg, mesh, num_iters=LM_ITERS))
            dp_ = float((st.p - single.p).abs().max())
            dv = float((st.v - single.v).abs().max())
            log(f"  9(b) {name} stacked L = {n}: {ms / LM_ITERS:.1f} ms an LM iteration; against "
                f"optimize_window max |Δp| {dp_:.3e} m, |Δv| {dv:.3e} m/s; cost {float(cost):.6g}")
            if dtype == torch.float64:
                stacked[n] = st
                if not (dp_ <= 1e-5 and dv <= 1e-4):
                    raise AssertionError(f"9(b): stacked L = {n} is {dp_:.3e} m / {dv:.3e} m/s "
                                         f"from optimize_window (> 1e-5 / 1e-4)")
        if dtype == torch.float64:
            window = (cfg, lay, pert, f)

    cfg, lay, pert, f = window
    tmp = tempfile.mkdtemp(prefix="plslam_torch_dist_")
    # one rank, NCCL: the reduction and the gather pass through the library
    multihost.init_distributed(init_method=f"file://{tmp}/nccl_store", world_size=1, rank=0)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"9(b): the one-rank group runs {dist.get_backend()}, not nccl")
    mesh = dba.make_mesh(4, dist.group.WORLD)
    dba.distributed_optimize_window(pert, f, lay, cfg, mesh, num_iters=1)  # warm-up
    (st, _), ms = timed(lambda: dba.distributed_optimize_window(pert, f, lay, cfg, mesh,
                                                                num_iters=LM_ITERS))
    dist.destroy_process_group()
    same = all(torch.equal(getattr(st, k), getattr(stacked[4], k)) for k in st._fields)
    log(f"  9(b) one-rank NCCL group, L = 4: {ms / LM_ITERS:.1f} ms an LM iteration; bit for bit "
        f"the stacked L = 4: {same}")
    if not same:
        raise AssertionError("9(b): the one-rank NCCL solve is not the stacked solve bit for bit")

    # two ranks on cuda:0 through gloo, which reduces CUDA tensors (NCCL puts
    # no two ranks of a group on one GPU)
    path = os.path.join(tmp, "window.pt")
    torch.save((cfg, lay, pert, f), path)
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
    script = GLOO_RANK.format(root=ROOT, store=os.path.join(tmp, "gloo_store"), window=path)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"9(b): gloo rank {r} exited {p.returncode}:\n{text[-3000:]}")
    ref = stacked[4]
    for r, out in enumerate(outs):
        got = torch.load(out, weights_only=False)
        gap = max(float((got[k].to(dev) - getattr(ref, k)).abs().max())
                  for k in ("p", "v", "inv_depth", "line"))
        log(f"  9(b) gloo rank {r} of 2 on cuda:0, 2 of 4 shards: {got['ms'] / LM_ITERS:.1f} ms an "
            f"LM iteration; max |Δ| to the stacked L = 4 over p, v, inverse depths, lines "
            f"{gap:.3e}")
        if not gap <= 1e-6:
            raise AssertionError(f"9(b): gloo rank {r} is {gap:.3e} from the stacked solve")


def _gt_error(p, gt_p):
    return float(np.linalg.norm(p - (gt_p - gt_p[0] + p[0]), axis=1).max())


def consensus_2d_on_card(dev):
    """9(c): `consensus_distributed_solve` at P = 3 × L = 2 on
    `tests/test_mesh2d.py`'s recipe at full width (192 features, 64 line
    slots, no lines packed, f32, 3 rounds of 6 iterations)."""
    import torch

    from plslam_torch.io import synthetic
    from plslam_torch.models import packing
    from plslam_torch.models.state import layout, retract
    from plslam_torch.parallel import consensus, dp, mesh2d

    cfg = smoke_config(np.load(os.path.join(render_dataset()[0], "meta.npz"))).solver
    lay = layout(cfg)
    n_frames = 31
    seq = synthetic.make_sequence(duration=10.0, n_points=200, n_lines=24, seed=7)
    kf = list(range(0, n_frames * 3, 3))
    parts = consensus.partition_frames(n_frames, cfg.window_size)
    rng = np.random.default_rng(4)
    pairs = []
    for pr in parts:
        st_gt, f = packing.factors_from_synthetic(seq, [kf[i] for i in pr], cfg, lay,
                                                  dtype=torch.float32, with_lines=False, device=dev)
        delta = np.zeros(lay.dim)
        delta[6: lay.nw * 6] = rng.standard_normal((lay.nw - 1) * 6) * 0.01
        pairs.append((retract(st_gt, torch.as_tensor(delta, dtype=torch.float32, device=dev), lay),
                      f))
    st_p, f_p = dp.stack_windows(pairs)
    mesh = mesh2d.make_mesh2d(len(parts), 2)
    st_out, ms = timed(lambda: mesh2d.consensus_distributed_solve(st_p, f_p, lay, cfg, mesh,
                                                                  rounds=3, num_iters=6))
    p, _ = consensus.stitch_trajectory(st_out, parts, n_frames)
    err = _gt_error(p, seq.gt_p.numpy()[kf])
    log(f"  9(c) 2-D layout {len(parts)} × 2 with consensus: {ms:.1f} ms (3 rounds × 6 LM "
        f"iterations); stitched trajectory within {err:.3e} m of the ground truth")
    if not err < 2e-2:
        raise AssertionError(f"9(c): stitched trajectory {err:.3e} m from the truth (≥ 2e-2)")


def synthetic_large_window_on_card(dev):
    """9(d): `run_synthetic_large_window` on `tests/test_large_window.py`'s
    recipe, held to that test's assertions."""
    import torch

    from plslam_torch.config import PLSlamConfig, SolverConfig
    from plslam_torch.eval.metrics import ate_rmse
    from plslam_torch.io import synthetic
    from plslam_torch.runner import run_synthetic_large_window

    seq = synthetic.make_sequence(duration=20.0, n_points=200, n_lines=0, seed=13, pix_noise=0.6,
                                  acc_noise=0.05, gyr_noise=0.003)
    cfg = PLSlamConfig(solver=SolverConfig(max_features=96, max_line_feats=8, dtype="float64"))
    t0 = time.perf_counter()
    kf_t, live_p, ref_p, _, _ = run_synthetic_large_window(seq, cfg, rounds=3, num_iters=8,
                                                           device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gt_t, gt_p = seq.frame_t.numpy(), seq.gt_p.numpy()
    ate_live = float(ate_rmse(kf_t, live_p, gt_t, gt_p, align="yaw"))
    ate_ref = float(ate_rmse(kf_t, ref_p, gt_t, gt_p, align="yaw"))
    log(f"  9(d) run_synthetic_large_window: {len(kf_t)} keyframes in {wall:.1f} s; ATE live "
        f"{ate_live:.4f} m, refined {ate_ref:.4f} m")
    checks = {"≥ 31 keyframes": len(kf_t) >= 31,
              "refined ≤ 1.02 × live": ate_ref <= ate_live * 1.02,
              "refined < 0.9 × live or < 0.02 m": ate_ref < ate_live * 0.9 or ate_ref < 0.02}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"9(d): {failed}")


def euroc_large_window_on_card(dev, main_traj):
    """9(e): `run_euroc_large_window` at full width on the smoke set
    (kf_stride 2, a 5 × 4 grid): the live trajectory against phase 5's, both
    ATEs, the live pass's launches, its last LK call and every Hamming call
    held against the plain versions. Returns (launches, kernels' numbers)."""
    import torch

    from plslam_torch.eval.metrics import ate_rmse
    from plslam_torch.ops.kernels import hamming, lk
    from plslam_torch.runner import run_euroc_large_window

    path, _ = render_dataset()
    meta = np.load(os.path.join(path, "meta.npz"))
    cfg = smoke_config(meta)
    n_cam, n_pub = _published(len(os.listdir(os.path.join(path, "mav0", "cam0", "data"))))
    with burst_kernel_calls(burst_steps_only=False, last_lk_only=True) as calls:
        lk.LAUNCHES = hamming.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kf_t, live_p, ref_p, _, est = run_euroc_large_window(path, cfg, kf_stride=2,
                                                             mesh_shape=(5, 4), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"lk_track": lk.LAUNCHES, "hamming_matrix": hamming.LAUNCHES}
    ts5, ps5, _ = main_traj
    idx = np.searchsorted(np.asarray(ts5), kf_t - 1e-9)
    idx = np.minimum(idx, len(ts5) - 1)
    d_t = float(np.abs(np.asarray(ts5)[idx] - kf_t).max())
    d_live = float(np.abs(np.asarray(ps5)[idx] - live_p).max())
    ate_live = float(ate_rmse(kf_t, live_p, meta["gt_t"], meta["gt_p"], align="yaw"))
    ate_ref = float(ate_rmse(kf_t, ref_p, meta["gt_t"], meta["gt_p"], align="yaw"))
    log(f"  9(e) run_euroc_large_window (5 × 4 grid): {len(kf_t)} keyframes in {wall:.1f} s; the "
        f"live keyframe poses against phase 5's max |Δp| {d_live:.3e} m; ATE live {ate_live:.4f} "
        f"m, refined {ate_ref:.4f} m; launches {launches}")
    checks = {"P·W + 1 keyframes": len(kf_t) == 5 * cfg.solver.window_size + 1,
              "live = phase 5's within 1e-6 m": d_t < 1e-9 and d_live <= 1e-6,
              f"ATE live < {ATE_LIMIT_M} m": ate_live < ATE_LIMIT_M,
              f"ATE refined < {ATE_LIMIT_M} m": ate_ref < ATE_LIMIT_M,
              "LK launches = tracked frames": launches["lk_track"] == n_cam - 1,
              "Hamming launches = published frames": launches["hamming_matrix"] == n_pub}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"9(e): {failed}")
    return launches, hold_burst_calls(calls, label="large window")


def images_large_window_on_card(dev):
    """9(f): `tests/test_large_window.py::test_distributed_large_window_from_images`'s
    recipe (the 12-s render, seed 31, 2 partitions × 4 shards, f64) with its
    assertions."""
    import torch

    from plslam_torch.config import (CameraConfig, ExtrinsicConfig, LoopConfig, PLSlamConfig,
                                     SolverConfig, TrackerConfig)
    from plslam_torch.eval.metrics import ate_rmse
    from plslam_torch.runner import run_euroc_large_window

    path, render_s = render_dataset("large_window")
    meta = np.load(os.path.join(path, "meta.npz"))
    cfg = PLSlamConfig(
        camera=CameraConfig(image_width=W, image_height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                            k1=0, k2=0, p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=100, min_dist=30, equalize=True, min_score=2e-3),
        solver=SolverConfig(max_features=96, max_line_feats=24, dtype="float64", focal_length=F),
        extrinsic=ExtrinsicConfig(0, tuple(meta["R_bc"].reshape(-1)), tuple(meta["p_bc"])),
        loop=LoopConfig(loop_closure=False))
    t0 = time.perf_counter()
    kf_t, live_p, ref_p, _, est = run_euroc_large_window(path, cfg, kf_stride=2, rounds=3,
                                                         num_iters=8, mesh_shape=(2, 4),
                                                         device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ate_live = float(ate_rmse(kf_t, live_p, meta["gt_t"], meta["gt_p"], align="yaw"))
    ate_ref = float(ate_rmse(kf_t, ref_p, meta["gt_t"], meta["gt_p"], align="yaw"))
    log(f"  9(f) from images (rendered in {render_s:.1f} s): {len(kf_t)} keyframes in {wall:.1f} "
        f"s; ATE live {ate_live:.4f} m, refined {ate_ref:.4f} m")
    checks = {"initialized": est.initialized,
              "2·W + 1 keyframes": len(kf_t) == 2 * cfg.solver.window_size + 1,
              "refined ATE finite": np.isfinite(ate_ref),
              "refined ≤ 1.02 × live": ate_ref <= ate_live * 1.02,
              "refined < 0.95 × live or < 0.03 m": ate_ref < ate_live * 0.95 or ate_ref < 0.03}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"9(f): {failed}")


def run_parallel(dev, main_traj):
    """Phase 9. Returns 9(e)'s (launches, kernels' numbers)."""
    t0 = time.perf_counter()
    log("  (a) DP")
    dp_on_card(dev)
    log("  (b) landmark-sharded BA")
    sharded_ba_on_card(dev)
    log("  (c) the 2-D layout with consensus")
    consensus_2d_on_card(dev)
    log("  (d) run_synthetic_large_window")
    synthetic_large_window_on_card(dev)
    log("  (e) run_euroc_large_window at full width")
    out = euroc_large_window_on_card(dev, main_traj)
    log("  (f) run_euroc_large_window from the JAX slow test's images")
    images_large_window_on_card(dev)
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    return out


# ---- phase 10: the structured normal-equation assembly and the last helpers ----
LINE_CHARTS = ("world", "incamera", "instartframe")
ASM_ROUNDS = 20  # 10(c): rounds of one call each, the calls in turns; medians kept
PREINT_STEPS = 512  # 10(d)'s long buffer
SCATTER_REPS = 20  # 10(c): scatters in the profiler session that counts them


def structured_window(dev, dtype):
    """9(a)'s first window, perturbed, at phase 5's solver widths.
    Returns (solver config, layout, state, factors)."""
    cfg, lay, _, pert = smoke_windows(dev, dtype, count=1)
    return (cfg, lay) + pert[0]


def assembly_vs_dense(dev):
    """10(a): float64, for each line chart, `assembly.assemble`'s H and b
    against the dense `linearize`'s JᵀJ and Jᵀr within 1e-9 × max, the
    cost within 1e-10 relative."""
    import torch

    from plslam_torch.models import assembly, solver
    from plslam_torch.models import residuals as res

    cfg, lay, st0, f = structured_window(dev, torch.float64)
    mask = torch.ones(lay.dim, dtype=torch.float64, device=dev)
    worst = 0.0
    for lp in LINE_CHARTS:
        st = st0._replace(line=res.lines_from_world(st0, st0.line, f.ln_start, lp))
        pt_w, ln_w, relo_w = res.robust_weights(st, f, cfg.focal_length, cfg.cauchy_c, lp)
        r, J = solver.linearize(st, f, lay, cfg.focal_length, pt_w, ln_w, mask, relo_w, lp)
        H, b, cost = assembly.assemble(st, f, lay, cfg.focal_length, pt_w, ln_w, relo_w, lp)
        H_d, b_d = J.T @ J, J.T @ r
        gap_H = float((H - H_d).abs().max() / H_d.abs().max())
        gap_b = float((b - b_d).abs().max() / b_d.abs().max())
        gap_c = abs(float(cost) / float(solver.cost_of(r)) - 1.0)
        log(f"  10(a) {lp}: max |H - JᵀJ| / max |JᵀJ| {gap_H:.3e}, b {gap_b:.3e}, cost "
            f"{gap_c:.3e} relative (D = {lay.dim}, {r.numel()} residuals)")
        if not (gap_H <= 1e-9 and gap_b <= 1e-9 and gap_c <= 1e-10):
            raise AssertionError(f"10(a): the structured normal equations of the {lp} chart are "
                                 "not the dense ones")
        worst = max(worst, gap_H, gap_b)
    log(f"  10(a) the worst relative gap over the three charts: {worst:.3e}")


def structured_vs_blocks(dev):
    """10(b): `optimize_window(structured=True)` against the blocks path
    after LM_ITERS iterations: float64 within 1e-8 m; float32 the gap and
    both accept sequences (replayed by `lm_trace`), and where they part, the
    step, its λ and both trial costs."""
    import torch

    from plslam_torch.models import solver

    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        cfg, lay, st, f = structured_window(dev, dtype)
        s_st, s_stats = solver.optimize_window(st, f, lay, cfg, num_iters=LM_ITERS, structured=True)
        b_st, b_stats = solver.optimize_window(st, f, lay, cfg, num_iters=LM_ITERS)
        gap = float((s_st.p - b_st.p).abs().max())
        log(f"  10(b) {name}: structured against blocks after {LM_ITERS} LM iterations: max |Δp| "
            f"{gap:.3e} m; accepted {int(s_stats.accepted)} / {int(b_stats.accepted)}; final cost "
            f"{float(s_stats.cost):.8g} / {float(b_stats.cost):.8g}")
        if not torch.isfinite(s_st.p).all():
            raise AssertionError(f"10(b): non-finite structured positions in {name}")
        if dtype == torch.float64:
            if not gap <= 1e-8:
                raise AssertionError(f"10(b): f64 structured positions {gap:.3e} m from the blocks "
                                     "path's")
            continue
        rows = [lm_trace(st, f, lay, cfg, LM_ITERS, structured=s)[1].double().cpu().numpy()
                for s in (True, False)]
        acc = [r[:, 0].astype(int) for r in rows]
        log(f"    accepts (replayed) structured {acc[0].tolist()}, blocks {acc[1].tolist()}; λ "
            f"structured {[float(f'{x:.3g}') for x in rows[0][:, 1]]}")
        part = np.nonzero(acc[0] != acc[1])[0]
        if len(part):
            i = int(part[0])
            log(f"    the sequences part at step {i} (λ {rows[0][i, 1]:.2e} / {rows[1][i, 1]:.2e}): "
                f"trial cost structured {rows[0][i, 3]:.8g} against {rows[0][i, 2]:.8g} at the "
                f"step's start, blocks {rows[1][i, 3]:.8g} against {rows[1][i, 2]:.8g}")
        else:
            log("    the accept sequences agree at every step")


def scatter_bound(blocks, D):
    """(least ms, what bounds it, float adds) of `assembly.scatter` on these
    blocks: each input (indices int64, J, r) read once and H, b written once,
    against the products JᵀJ, Jᵀr and the scattered adds at the float32 rate
    outside the tensor cores."""
    n_bytes, n_ops, adds = 4 * (D * D + D), 0, 0
    for idx, J, r in blocks:
        S, m, n = J.shape
        n_bytes += idx.numel() * idx.element_size() + (J.numel() + r.numel()) * J.element_size()
        adds += S * n * (n + 1)
        n_ops += 2 * S * m * n * (n + 1)
    ms, by = bound(n_bytes, n_ops + adds)
    return ms, by, adds


def device_ops(fn, reps=1):
    """(device operations, device ms) a call of `fn`, from torch.profiler's
    raw device events over `reps` calls in one session (their mean). A
    session can keep no record (see `measure.device_us`; a session of one
    scatter kept none three times running on the card): it is then run
    again, up to PROFILER_SESSIONS sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plslam_torch.utils.measure import PROFILER_SESSIONS

    for _ in range(PROFILER_SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
        if ev:
            return len(ev) / reps, 1e-6 * sum(e.duration_ns() for e in ev) / reps
    raise AssertionError(f"the profiler kept no device event in {PROFILER_SESSIONS} sessions")


def time_structured(dev):
    """10(c), float32 (the estimator's dtype), a record and no gate: one
    linearization + solve per path (the scatter of the structured one
    apart), and one whole `optimize_window` per path replayed from a CUDA
    graph (each path captures; its replay held against one eager solve), by
    CUDA events in turns (medians over ASM_ROUNDS rounds); device operations
    per LM iteration per path; the scatter's adds, its device time and its
    bound."""
    import torch

    from plslam_torch.models import assembly, solver
    from plslam_torch.models import residuals as res
    from plslam_torch.utils.cuda_graph import CudaGraph

    cfg, lay, st, f = structured_window(dev, torch.float32)
    focal, lp = cfg.focal_length, cfg.line_param
    mask = solver.free_mask(f, lay, cfg, False, False)
    pt_w, ln_w, relo_w = res.weights_of_groups(res.residual_groups(st, f, lay, focal, lp),
                                               cfg.cauchy_c)
    lam = torch.full((), cfg.lm_lambda_init, dtype=torch.float32, device=dev)
    _, _, blocks = assembly.factor_blocks(st, f, lay, focal, pt_w, ln_w, relo_w, lp)

    def structured_step():
        H, b, _ = assembly.assemble(st, f, lay, focal, pt_w, ln_w, relo_w, lp)
        return solver.schur_solve(H * mask[:, None] * mask[None, :], b * mask, lay, lam, mask)

    def blocks_step():
        r, J_cam, bl = solver.linearize_blocks(st, f, lay, focal, pt_w, ln_w, mask, relo_w, lp)
        return solver.schur_solve_blocks(r, J_cam, bl, lay, lam, mask)

    def solve(structured, iters=LM_ITERS):
        return lambda s, ff: solver.optimize_window(s, ff, lay, cfg, num_iters=iters,
                                                    structured=structured)

    fns = {
        "assemble": lambda: assembly.assemble(st, f, lay, focal, pt_w, ln_w, relo_w, lp),
        "assemble + schur_solve": structured_step,
        "  of which the scatter (4 × 2 index_add_)": lambda: assembly.scatter(blocks, lay.dim),
        "linearize_blocks + schur_solve_blocks": blocks_step,
    }
    for name, structured in (("structured", True), ("blocks", False)):
        graph = CudaGraph(solve(structured), st, f)
        fns[f"optimize_window {name}, CUDA graph"] = lambda g=graph: g(st, f)
        g_st = graph(st, f)[0]
        e_st = solve(structured)(st, f)[0]
        log(f"  10(c) {name}: the graph's replay against the eager solve, max |Δp| "
            f"{float((g_st.p - e_st.p).abs().max()):.3e} m")
    for fn in fns.values():
        fn()
    ms = {name: [] for name in fns}
    for _ in range(ASM_ROUNDS):
        for name, fn in fns.items():
            ms[name].append(timed(fn)[1])
    for name, v in ms.items():
        log(f"  10(c) {name}: median {np.median(v):.3f} ms over {ASM_ROUNDS} rounds (min "
            f"{min(v):.3f}, max {max(v):.3f})")
    for name, structured in (("structured", True), ("blocks", False)):
        n1, t1 = device_ops(lambda: solve(structured, 1)(st, f))
        n3, t3 = device_ops(lambda: solve(structured, 3)(st, f))
        log(f"  10(c) {name}: {(n3 - n1) / 2:.0f} device operations and {(t3 - t1) / 2:.3f} ms of "
            f"device time an LM iteration ({n1:g} operations in a 1-iteration solve)")
    n_sc, t_sc = device_ops(lambda: assembly.scatter(blocks, lay.dim), reps=SCATTER_REPS)
    b_ms, b_by, adds = scatter_bound(blocks, lay.dim)
    log(f"  10(c) the scatter: {adds} float adds into H and b, {n_sc:g} device operations, "
        f"{t_sc:.4f} ms device time (means over {SCATTER_REPS} calls); bound "
        f"{b_ms:.3e} ms ({b_by}; {HBM_BYTES_PER_S:.3g} B/s, {OPS_PER_S:.3g} float32 op/s)")


def preintegration_on_card(dev):
    """10(d): `imu.preintegrate_sequential` (the reference's step-by-step
    recursion) against the associative `imu.preintegrate` on the card, float64,
    over one camera interval of the smoke set's 200-Hz IMU and over
    PREINT_STEPS steps: `tests/test_imu.py`'s bounds (1e-8 relative, the
    covariance 1e-7, +1e-12 absolute); both timed by CUDA events (median of
    2 rounds in turns)."""
    import torch

    from plslam_torch.io import synthetic
    from plslam_torch.ops import imu

    seq = synthetic.make_sequence(params=synthetic.TrajectoryParams(**TRAJECTORY), **SEQUENCE)
    noise = imu.ImuNoise.euroc(torch.float64, dev)
    n = PREINT_STEPS
    cases = {
        "one camera interval": synthetic.imu_between(seq, float(seq.frame_t[0]),
                                                     float(seq.frame_t[1])),
        "a long buffer": (seq.imu_acc[:n + 1], seq.imu_gyr[:n + 1], torch.diff(seq.imu_t[:n + 1])),
    }
    for label, raw in cases.items():
        acc, gyr, dt = (x.to(dtype=torch.float64, device=dev) for x in raw)
        z = torch.zeros(3, dtype=torch.float64, device=dev)
        run = {"sequential": lambda: imu.preintegrate_sequential(acc, gyr, dt, z, z, noise),
               "associative": lambda: imu.preintegrate(acc, gyr, dt, z, z, noise)}
        out = {k: fn() for k, fn in run.items()}
        worst = 0.0
        for field in ("alpha", "beta", "gamma", "jac", "cov", "dt_sum"):
            a, b = getattr(out["associative"], field), getattr(out["sequential"], field)
            tol = 1e-7 if field == "cov" else 1e-8
            err = float(((a - b).abs() / (1e-12 + tol * b.abs())).max())
            worst = max(worst, err)
        ms = {k: [] for k in run}
        for _ in range(2):
            for k, fn in run.items():
                ms[k].append(timed(fn)[1])
        log(f"  10(d) {label} ({dt.numel()} steps): associative within "
            f"{worst:.3f} × the bound of the sequential; sequential {np.median(ms['sequential']):.3f} ms, "
            f"associative {np.median(ms['associative']):.3f} ms (CUDA events)")
        if not worst <= 1.0:
            raise AssertionError(f"10(d): preintegrate disagrees with the sequential recursion "
                                 f"over {label}")


# 10(e): (label, function of `tests/robustness_scenarios.py`)
SCENARIOS = (("frame drops", "frame_drops"),
             ("corrupted observations", "corrupted_observations"),
             ("feature collapse → re-initialization", "feature_collapse"),
             ("IMU-pad overflow forces a keyframe", "imu_pad_overflow"),
             ("oracle init, points and lines, imu_rate_pose", "oracle_points_lines"),
             ("the incamera line chart", "anchored_line_chart"),
             ("deferred solve bit for bit", "deferred_solve"))


def scenarios_on_card(dev):
    """10(e): the run-level scenarios that the CPU tests mark `slow`
    (`tests/robustness_scenarios.py`), on the card at the reference's
    settings, one after another, each held to the reference test's
    assertions (a failed one raises)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import robustness_scenarios as scen

    t_all = time.perf_counter()
    for label, name in SCENARIOS:
        t0 = time.perf_counter()
        out = getattr(scen, name)(dev)
        log(f"  10(e) {label}: the reference's assertions hold; "
            + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in out.items() if np.isscalar(v))
            + f"; {time.perf_counter() - t0:.1f} s")
    log(f"  10(e) {len(SCENARIOS)} scenarios in {time.perf_counter() - t_all:.1f} s")


def run_structured(dev):
    """Phase 10."""
    t0 = time.perf_counter()
    log("  (a) structured normal equations against the dense ones, float64")
    assembly_vs_dense(dev)
    log("  (b) optimize_window(structured=True) against the blocks path")
    structured_vs_blocks(dev)
    log("  (c) times on the card")
    time_structured(dev)
    log("  (d) the sequential IMU recursion against preintegrate")
    preintegration_on_card(dev)
    log("  (e) the run-level scenarios")
    scenarios_on_card(dev)
    log(f"  phase 10 took {time.perf_counter() - t0:.1f} s")


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
    launches, main_traj, main_ate = run_main_path(dev)
    time_line_tick(dev)
    run_points_only(dev)
    pallas_launches = drive_frontends(dev)
    profile_short_run(dev, frames=24)

    log("phase 6: the loop scene, run_euroc(loop_closure=True) on the card")
    search_launches, search_err, run_a = run_loop_scene(dev)

    log("phase 7: burst replay, run_euroc(burst=8) on the card")
    burst_launches, burst_rows = run_burst(dev)

    log("phase 8: the command line and the tools around run_euroc on the card")
    log("  (a) python -m plslam_torch run / eval")
    cli_launches = cli_run((main_traj, main_ate))
    log("  (b) checkpoint and resume")
    checkpoint_resume(dev)
    log("  (c) intrinsic calibration")
    calibration_on_card(dev)
    log("  (d) show_track on the loop scene")
    viz_launches, viz_rows = show_track_loop(dev, run_a)

    log("phase 9: the parallel solvers and the large-window runners on the card")
    lw_launches, lw_rows = run_parallel(dev, main_traj)

    log("phase 10: the structured normal-equation assembly and the last helpers on the card")
    run_structured(dev)

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
        {"name": "lk_track fast, CLI run", "route": "cuda", "source": LK_SOURCE,
         "replaces": LK_FAST_REPLACES, "launches": cli_launches["lk_track"], **lk_rows["fast"],
         "library_ms": None},
        {"name": "hamming_matrix, CLI run", "route": "cuda", "source": HAMMING_SOURCE,
         "replaces": HAMMING_REPLACES, "launches": cli_launches["hamming_matrix"],
         **ham_rows[HAMMING_SHAPES[0]]},
        {"name": "lk_track fast, show_track", "route": "cuda", "source": LK_SOURCE,
         "replaces": LK_FAST_REPLACES, "launches": viz_launches["lk_track"],
         **viz_rows["lk_track"]},
        {"name": "hamming_matrix loop search, show_track", "route": "cuda",
         "source": HAMMING_SOURCE, "replaces": HAMMING_REPLACES,
         "launches": viz_launches["hamming_matrix"], **viz_rows["hamming_matrix"]},
        {"name": "lk_track fast, large window", "route": "cuda", "source": LK_SOURCE,
         "replaces": LK_FAST_REPLACES, "launches": lw_launches["lk_track"], **lw_rows["lk_track"]},
        {"name": "hamming_matrix, large window", "route": "cuda", "source": HAMMING_SOURCE,
         "replaces": HAMMING_REPLACES, "launches": lw_launches["hamming_matrix"],
         **lw_rows["hamming_matrix"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
