"""Sequence runners: drive the estimator over a dataset.

Counterpart of `plslam/runner.py`. `run_euroc` is the streaming pipeline
(PNG decode + CLAHE → point and line frontends → IMU pairing → estimator),
`run_synthetic` feeds simulator observations straight to the estimator.
Every entry point runs on the card unless its `device=` names another.
"""
from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

from plslam_torch.config import ExtrinsicConfig, PLSlamConfig
from plslam_torch.models.estimator import Estimator
from plslam_torch.utils import timers
from plslam_torch.utils.device import HostCopy


class ImuFeeder:
    """`getMeasurements` pairing: feed every IMU sample strictly before
    `t_img + td`, then ONE boundary sample linearly interpolated exactly at
    `t_img + td` (td read live from the estimator at every frame)."""

    def __init__(self, imu_t, acc, gyr):
        self.t = np.asarray(imu_t, np.float64)
        self.acc = np.asarray(acc, np.float64)
        self.gyr = np.asarray(gyr, np.float64)
        self.i = 0
        self.prev_t = None
        self.prev_acc = None
        self.prev_gyr = None

    def _feed(self, est, t, acc, gyr):
        dt = (t - self.prev_t) if self.prev_t is not None else 0.005
        est.process_imu(dt, acc, gyr)
        self.prev_t, self.prev_acc, self.prev_gyr = t, acc, gyr

    def feed_until(self, est, t_img):
        """Feed samples up to the interpolated boundary at t_img + est.td."""
        t_b = float(t_img) + float(est.td)
        n = len(self.t)
        while self.i < n and self.t[self.i] < t_b - 1e-9:
            self._feed(est, self.t[self.i], self.acc[self.i], self.gyr[self.i])
            self.i += 1
        if self.i >= n:
            return
        t1 = self.t[self.i]
        if t1 <= t_b + 1e-9:  # a sample lies exactly on the boundary
            self._feed(est, t1, self.acc[self.i], self.gyr[self.i])
            self.i += 1
            return
        if self.prev_t is None:
            return  # boundary precedes the first IMU sample
        w = (t_b - self.prev_t) / (t1 - self.prev_t)
        acc_b = (1.0 - w) * self.prev_acc + w * self.acc[self.i]
        gyr_b = (1.0 - w) * self.prev_gyr + w * self.gyr[self.i]
        self._feed(est, t_b, acc_b, gyr_b)


def _clahe(img, clip=3.0, tiles=8):
    """Contrast-limited adaptive histogram equalization
    (`cv::createCLAHE(3.0, 8x8)` equivalent; shared native C++ with a numpy fallback)."""
    from plslam_torch.io import native

    out = native.clahe(img, clip, tiles)
    if out is not None:
        return out
    h, w = img.shape
    th, tw = h // tiles, w // tiles
    luts = np.empty((tiles, tiles, 256), np.float32)
    for i in range(tiles):
        for j in range(tiles):
            tile = img[i * th: (i + 1) * th, j * tw: (j + 1) * tw]
            hist, _ = np.histogram((tile * 255).astype(np.uint8), bins=256, range=(0, 256))
            excess = np.maximum(hist - clip * tile.size / 256, 0).sum()
            hist = np.minimum(hist, clip * tile.size / 256) + excess / 256
            cdf = np.cumsum(hist)
            luts[i, j] = (cdf / cdf[-1]).astype(np.float32)
    ys = np.clip((np.arange(h) - th / 2) / th, 0, tiles - 1.001)
    xs = np.clip((np.arange(w) - tw / 2) / tw, 0, tiles - 1.001)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    y1 = np.minimum(y0 + 1, tiles - 1)
    x1 = np.minimum(x0 + 1, tiles - 1)
    v = (img * 255).astype(np.uint8)
    l00 = luts[y0[:, None], x0[None, :], v]
    l01 = luts[y0[:, None], x1[None, :], v]
    l10 = luts[y1[:, None], x0[None, :], v]
    l11 = luts[y1[:, None], x1[None, :], v]
    return (l00 * (1 - fx) * (1 - fy) + l01 * fx * (1 - fy) + l10 * (1 - fx) * fy
            + l11 * fx * fy).astype(np.float32)


def run_euroc(seq_path: str, config: PLSlamConfig | None = None, use_lines: bool = True,
              loop_closure: bool | None = None, max_frames: int | None = None,
              progress: bool = False, pipeline: bool = True, burst: int = 0,
              record_tracks: dict | None = None, burst_log: list | None = None, device=None):
    """Pipeline on an EuRoC ASL sequence: image → CLAHE → point and line
    frontends → IMU pairing → estimator. Runs on the card unless `device`
    says otherwise.

    FREQ control: the point frontend tracks EVERY camera frame but publishes
    to the estimator every `stride`-th one; tracked-only frames run pyramid
    + LK. The line frontend (`use_lines`, matched by binary LBD when
    `config.tracker.line_desc == "binary"`) runs on published frames only,
    on the point pyramid's level 0 as its image and level 1 as its second
    octave; both frontends' bundles are read back with one wait.
    `pipeline=True` decodes frame k+1 on a worker thread while frame k runs
    and defers each solve's readback to the next published frame; the
    trajectory is identical to `pipeline=False`. A fisheye mask image
    (`config.tracker.fisheye_mask`) limits the tracked field of view; one
    that does not load falls back to the centered circle with a warning.

    Loop closure (`loop_closure`, by default `config.loop.loop_closure`):
    every solved keyframe enters the pose graph with its CLAHE'd image and
    the estimator's window points; a confirmed loop starts the
    relocalization round trip (`set_relo_frame` → the next joint solve →
    `update_loop_edge`), the 4-DoF PGO runs when an edge is pending, and
    every emitted pose is drift-corrected. The map is loaded and saved as
    `config.loop` says.

    `burst=B` (offline replay): once the estimator has run 7 solves with a
    prior, B published frames at a time run as one chunk of device steps
    with one readback (`models/burst.py`; each step also reads its keyframe
    flag back). Keyframes enter the pose graph a chunk at a time; a loop that
    wants the relocalization round trip, a timestamp jump, failure
    detection, and the frames left over for less than a chunk run
    streaming. `burst_log`, when given, receives one dict per chunk run and
    one per fallback to streaming (its "fallback" names the reason).
    `record_tracks`, when given, receives the published frames' tracks
    `{t: (ids, normalized obs)}`; it forces streaming, as in the JAX package.

    `config.tracker.show_track` writes a track overlay of every 4th camera
    frame and a match image of every loop under `<output_path>/viz/`
    (`eval/viz.TrackVisualizer`). As in JAX it reads every camera frame's
    tracks back, so tracked-only frames run the published frames' full
    tick (RANSAC, detection, refill) and the trajectory differs from a run
    without it; it forces streaming.

    Returns (ts, ps, qs, estimator, pose graph or None)."""
    from plslam_torch.io.euroc import EurocSequence
    from plslam_torch.models.frontend_lines import FrontendLines
    from plslam_torch.models.frontend_points import FrontendPoints
    from plslam_torch.models.pose_graph import PoseGraph
    from plslam_torch.ops.cameras import make_camera, normalized_to_pixel

    config = config or PLSlamConfig()
    loop_closure = config.loop.loop_closure if loop_closure is None else loop_closure
    tr = config.tracker
    seq = EurocSequence.load(seq_path)
    est = Estimator(config, device=device)
    cam = make_camera(config.camera)
    fisheye_mask = None
    if tr.fisheye and tr.fisheye_mask:  # nonzero pixels are the usable field of view
        from plslam_torch.io import native

        fisheye_mask = native.load_png_gray(tr.fisheye_mask)
        if fisheye_mask is None:
            warnings.warn(f"could not load fisheye_mask {tr.fisheye_mask!r}; "
                          f"using the centered circle")
    fp = FrontendPoints(cam, max_cnt=tr.max_cnt, min_dist=tr.min_dist,
                        f_thresh_px=tr.f_threshold, focal=config.camera.fx,
                        min_score=tr.min_score, fisheye=tr.fisheye, fisheye_mask=fisheye_mask,
                        device=est.device)
    f_lines = (FrontendLines(cam, max_lines=tr.max_lines, binary_desc=tr.line_desc == "binary",
                             device=est.device) if use_lines else None)
    pgraph = (PoseGraph(config.loop, focal=config.solver.focal_length,
                        R_bc=np.asarray(config.extrinsic.rot).reshape(3, 3),
                        p_bc=np.asarray(config.extrinsic.trans), device=est.device)
              if loop_closure else None)
    if pgraph is not None and config.loop.load_previous_pose_graph:
        pg_file = config.loop.pose_graph_save_path
        if os.path.isdir(pg_file):
            pg_file = os.path.join(pg_file, "pose_graph.npz")
        if os.path.exists(pg_file):
            pgraph.load(pg_file)
    viz = None
    if tr.show_track:
        from plslam_torch.eval.viz import TrackVisualizer

        viz = TrackVisualizer(config.output_path, every=4)
        if pgraph is not None:
            pgraph.keep_images = True  # the loop match_image dump
    stride = max(1, round(20 / tr.freq))
    max_pub = max_frames if max_frames is not None else len(seq.cam_t)

    def _load(k):
        with timers.span("runner.decode", frame=float(seq.cam_t[k])):
            img = seq.image(k)
            return _clahe(img) if tr.equalize else img

    executor = pending = None
    if pipeline:
        from concurrent.futures import ThreadPoolExecutor

        executor = ThreadPoolExecutor(max_workers=1)
        pending = executor.submit(_load, 0)

    ts_out, ps_out, qs_out = [], [], []
    feeder = ImuFeeder(seq.imu_t, seq.imu_acc, seq.imu_gyr)
    deferred = None
    relo_edge = {"ij": None}  # the loop edge awaiting the refined relative pose

    def _emit(ctx):
        """Trajectory and pose-graph output of a published frame, with that
        frame's own image (one published frame later in pipeline mode —
        `latest_pose()` finalizes the deferred solve)."""
        m, img_k = ctx
        with timers.span("runner.emit", frame=m["t"]):
            est.finalize()
            # the relocalization round trip closes (`updateKeyFrameLoop`): the
            # joint solve's refined old-keyframe pose replaces the raw PnP edge
            if pgraph is not None and est.relo_result is not None and relo_edge["ij"] is not None:
                oi, cj = relo_edge["ij"]
                pgraph.update_loop_edge(oi, cj, est.relo_result["p_old"], est.relo_result["q_old"])
                relo_edge["ij"] = None
                est.relo_result = None
            elif relo_edge["ij"] is not None and est.relo is None and est.relo_result is None:
                # the round trip died (failure detection cleared the estimator):
                # the raw PnP measurement stands
                relo_edge["ij"] = None
            if "cost" not in m or m.get("failure") or not est.initialized:
                return
            tt, p, q = est.latest_pose()
            if pgraph is not None and m.get("keyframe"):
                ids_w, norm_w, pts3d_w = est.window_points()
                uv_w = None
                if len(ids_w):
                    # a fixed max_features buffer, as the JAX runner projects it
                    buf = np.zeros((config.solver.max_features, 2))
                    buf[: len(ids_w)] = norm_w
                    uv_all = normalized_to_pixel(cam, torch.as_tensor(buf, dtype=torch.float32))
                    uv_w = uv_all.numpy().astype(np.float64)[: len(ids_w)]
                loop = pgraph.add_keyframe(tt, p, q, img=img_k, cam=cam, win_uv=uv_w,
                                           win_pts3d=pts3d_w, win_ids=ids_w)
                mm = pgraph.last_match
                if loop is not None and mm is not None:
                    # relocalization feedback (`setReloFrame`): the next solve
                    # refines the loop jointly
                    _set_relo(mm)
                    if viz is not None and mm["old_img"] is not None and mm["uv_cur"] is not None:
                        viz.match_image(img_k, mm["uv_cur"], mm["old_img"], mm["uv_old"],
                                        tag=f"{mm['old_idx']}_{mm['cur_idx']}")
                if (loop is not None and config.loop.fast_relocalization
                        and loop["i"] < pgraph.base_n):
                    pgraph.fast_relocalize(loop)  # the edge lands in the loaded map
            if pgraph is not None:
                if pgraph._pending_opt:
                    pgraph.optimize()
                p, q = pgraph.correct(p, q)  # every published pose, not only keyframes
            ts_out.append(tt)
            ps_out.append(p)
            qs_out.append(q)

    def _set_relo(mm):
        if est.set_relo_frame(mm["ids"], mm["obs_old"], mm["p_old"], mm["q_old"]):
            relo_edge["ij"] = (mm["old_idx"], mm["cur_idx"])

    def _burst_ready():
        return (est.initialized and est.prior is not None and est.relo is None
                and relo_edge["ij"] is None)

    # track recording and the track visualizer need every frame's tracks on
    # the host: they force streaming, as in the JAX package
    burst_on = burst > 0 and viz is None and record_tracks is None
    n_pub = 0
    prev_cam_t = None
    n_cam = len(seq.cam_t)
    k = 0
    try:
        while k < n_cam and n_pub < max_pub:
            # burst: once initialized with a live prior (its first solves in
            # streaming, where the post-init health gate runs) and with no
            # relocalization round trip pending, chunks of `burst` published
            # frames run on the device; streaming resumes for what is left
            if burst_on and k % stride == 0 and _burst_ready() and est.solves_since_init > 6:
                if deferred is not None:
                    _emit(deferred)
                    deferred = None
                est.finalize()
                if _burst_ready():  # finalize may have run failure detection
                    k2, n_pub, relo_match = _burst_tail(
                        seq, config, est, fp, f_lines, feeder, k, stride, burst, _load,
                        ts_out, ps_out, qs_out, n_pub, max_pub, progress, pgraph, cam, burst_log)
                    if relo_match is not None:
                        _set_relo(relo_match)  # the streaming solve refines the edge
                    elif k2 == k:
                        burst_on = False  # no chunk ran: stream on
                    k = k2
                    prev_cam_t = float(seq.cam_t[k - 1]) if k > 0 else None
                    if executor is not None and k < n_cam:
                        pending = executor.submit(_load, k)
                    continue
            t = float(seq.cam_t[k])
            # restart handshake: a timestamp discontinuity resets the trackers
            # (the estimator resets itself in process_frame)
            if prev_cam_t is not None and (t < prev_cam_t - 1e-9 or t - prev_cam_t > 1.0):
                fp.reset()
                if f_lines is not None:
                    f_lines.reset()
            prev_cam_t = t
            timers.frame(t)
            if executor is not None:
                with timers.span("runner.load_wait"):
                    img = pending.result()
                if k + 1 < n_cam:
                    pending = executor.submit(_load, k + 1)
            else:
                img = _load(k)
            publish = k % stride == 0
            # the visualizer reads every frame's tracks, so that every frame
            # runs the full tick (detection and refill too), as in JAX
            want_pts = publish or viz is not None
            pts_h = fp.process(img, t, want_output="defer" if want_pts else False,
                               light=not want_pts)
            k += 1
            ln_h = None
            if publish and f_lines is not None:
                pyr = fp.prev_pyr
                ln_h = f_lines.process(pyr[0], t, oct1=pyr[1] if len(pyr) > 1 else None,
                                       want_output="defer")
            if viz is not None:
                uv = pts_h.get()[3]
                viz.track_frame(img, uv, fp.track_cnt[fp.prev_valid])
            if not publish:
                continue
            with timers.span("runner.frontend_wait"):
                if ln_h is not None:
                    (ids, pts, vel, _), (ln_ids, ln_segs) = HostCopy.get_joint(pts_h, ln_h)
                else:
                    ids, pts, vel, _ = pts_h.get()
                    ln_ids = ln_segs = None
            n_pub += 1
            if record_tracks is not None and len(ids):
                # the published tracks keyed by time: global ids and normalized
                # observations (the `/feature` topic's payload)
                record_tracks[t] = (np.asarray(ids).copy(), np.asarray(pts, np.float64).copy())
            if deferred is not None:
                _emit(deferred)
                deferred = None
            with timers.span("runner.imu"):
                feeder.feed_until(est, t)
            m = est.process_frame(t, ids, pts, vel, ln_ids, ln_segs, defer_solve=pipeline)
            if pipeline:
                deferred = (m, img)
            else:
                _emit((m, img))
            if progress and (k - 1) % 100 == 0:
                print(f"[{k - 1}] t={t:.2f} init={est.initialized} pts={m.get('n_pts')} "
                      f"lines={m.get('n_lines')}")
        if deferred is not None:
            _emit(deferred)  # drain the last in-flight solve
        if pgraph is not None and pgraph._pending_opt:
            # a loop on the final published frame or chunk still gets its
            # 4-DoF solve, on the raw PnP edge
            pgraph.optimize()
    finally:
        if executor is not None:
            executor.shutdown(wait=True, cancel_futures=True)
    if pgraph is not None and config.loop.save_pose_graph:
        pg_file = config.loop.pose_graph_save_path
        if not pg_file.endswith(".npz"):
            os.makedirs(pg_file, exist_ok=True)
            pg_file = os.path.join(pg_file, "pose_graph.npz")
        pgraph.save(pg_file)
    return np.asarray(ts_out), np.asarray(ps_out), np.asarray(qs_out), est, pgraph


def _to_device(a: np.ndarray, dtype, device):
    """A host array on `device`: through pinned memory without waiting on
    the card, so that no upload stalls the host behind the device's queue."""
    t = torch.from_numpy(np.array(a)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _burst_tail(seq, config, est, fp, f_lines, feeder, k0, stride, B, load, ts_out, ps_out,
                qs_out, n_pub, max_pub, progress, pgraph, cam, burst_log):
    """The burst loop on the host (`models/burst.py`): the rest of the sequence in
    chunks of B published frames, one chunk of device steps and one readback
    each. A worker thread decodes the next chunk's frames and uploads them as
    uint8 while the card runs this one. With a pose graph every keyframe's
    payload rides the chunk's readback and loop closure runs on the host a
    chunk at a time. Returns (the next camera frame for the streaming loop,
    the updated published count, a loop match wanting the relocalization
    round trip or None). Stops early on a timestamp jump, failure detection
    or such a loop, and runs nothing with less than a chunk left: streaming
    handles each. Every chunk and every fallback lands in `burst_log`; a
    chunk's entry counts the published frames it emitted (`frames`) and
    those it did not (`dropped`: the frames from the one that failure
    detection flagged to the chunk's end, 0 for a whole chunk)."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    from plslam_torch.models import burst as burst_mod
    from plslam_torch.models.frontend_points import to_u8
    from plslam_torch.models.marginalization import EIGH_FAILED

    def note(**entry):
        if burst_log is not None:
            burst_log.append(entry)
        if progress and "fallback" in entry:
            print(f"[burst @{entry['k']}] back to streaming: {entry['fallback']}")

    cam_t = np.asarray(seq.cam_t, np.float64)
    n_cam = len(cam_t)
    if n_pub + B > max_pub or k0 + B * stride > n_cam:
        note(k=k0, fallback="fewer frames left than a chunk")
        return k0, n_pub, None
    try:
        carry = burst_mod.make_carry(est, fp, f_lines)
    except ValueError as e:
        note(k=k0, fallback=f"handoff refused: {e}")
        return k0, n_pub, None
    step = burst_mod.BurstStep(est, fp, f_lines, stride)
    packer = burst_mod.ImuChunkPacker(seq.imu_t, seq.imu_acc, seq.imu_gyr, feeder.i,
                                      feeder.prev_t, feeder.prev_acc, feeder.prev_gyr)
    dev = est.device
    W = est.cfg.window_size
    k = k0
    prev_t = float(cam_t[k0 - 1]) if k0 > 0 else float(cam_t[0]) - 0.05
    # the timestamps of each slot, replicated on the host from the publish
    # times and keyframe flags by the estimator's own slide rules
    ts_win = est.timestamps.copy()
    td = float(est.td)
    failed = False
    relo_match = None

    def decode(kk):
        frames = [load(kk + i) for i in range(B * stride)]
        u8 = np.stack([to_u8(f) for f in frames]).reshape(B, stride, *frames[0].shape)
        return frames, _to_device(u8, torch.uint8, dev)

    pool = ThreadPoolExecutor(max_workers=1)
    try:
        prefetch = pool.submit(decode, k0)
        while not failed and n_pub + B <= max_pub and k + B * stride <= n_cam:
            tchunk = cam_t[k: k + B * stride]
            dts_cam = np.diff(np.concatenate([[prev_t], tchunk]))
            if np.any(dts_cam <= 0) or np.any(dts_cam > 1.0):
                note(k=k, fallback="timestamp jump")
                break
            t0 = time.perf_counter()
            frames, imgs = prefetch.result()
            t_dec = time.perf_counter()
            prefetch = (pool.submit(decode, k + B * stride)
                        if k + 2 * B * stride <= n_cam else None)
            acc, gyr, dts, n_imu = zip(*[packer.interval(tchunk[j * stride], td)
                                         for j in range(B)])
            carry, outs = step.run_chunk(
                carry, imgs, dts_cam.reshape(B, stride).tolist(),
                *[_to_device(np.stack(a), torch.float64, dev) for a in (acc, gyr, dts)],
                list(n_imu), [td] * B)
            o = dict(zip(outs, HostCopy(*outs.values()).get()))  # the chunk's one wait
            t_read = time.perf_counter()
            if np.any(o["eigh_failed"] > 0):  # the steps' marginalization flags
                raise torch.linalg.LinAlgError(EIGH_FAILED)
            emitted = 0
            for j in range(B):
                if o["fail"][j]:
                    failed = True
                    break
                tt = float(tchunk[j * stride])
                # the slide of the slot timestamps (process_frame writes slot
                # W; MARGIN_OLD rolls left, SECOND_NEW copies W → W-1)
                ts_win[W] = tt
                if o["keyframe"][j]:
                    ts_win[:-1] = ts_win[1:]
                else:
                    ts_win[W - 1] = ts_win[W]
                p_raw = o["p"][j].astype(np.float64)
                q_raw = o["q"][j].astype(np.float64)
                p_out, q_out = p_raw, q_raw
                if pgraph is not None:
                    if o["keyframe"][j]:
                        sel = o["kf_points"][j]
                        loop = pgraph.add_keyframe(
                            tt, p_raw, q_raw, img=frames[j * stride], cam=cam,
                            win_uv=o["uv"][j][sel].astype(np.float64) if sel.any() else None,
                            win_pts3d=o["p_w"][j][sel].astype(np.float64),
                            win_ids=o["ids"][j][sel].astype(np.int64))
                        if loop is not None and relo_match is None:
                            if config.loop.fast_relocalization and loop["i"] < pgraph.base_n:
                                pgraph.fast_relocalize(loop)
                            # the round trip runs after this chunk, in streaming
                            if pgraph.last_match is not None:
                                relo_match = dict(pgraph.last_match)
                        if pgraph._pending_opt and relo_match is None:
                            pgraph.optimize()
                    p_out, q_out = pgraph.correct(p_raw, q_raw)
                ts_out.append(tt)
                ps_out.append(p_out)
                qs_out.append(q_out)
                est.metrics.append({"t": tt, "keyframe": bool(o["keyframe"][j]),
                                    "cost": float(o["cost"][j]),
                                    "tracked": int(o["long_tracked"][j]),
                                    "long_tracked": int(o["long_tracked"][j]),
                                    "n_pts": int(o["n_pts"][j]), "burst": True})
                n_pub += 1
                emitted += 1
            note(k=k, frames=emitted, dropped=B - emitted, decode_wait_s=t_dec - t0,
                 chunk_s=t_read - t_dec, t0=t0, t1=t_read)
            td = float(o["td"][-1])  # estimate_td: the next chunk pairs at the live td
            prev_t = float(tchunk[-1])
            k += B * stride
            if failed:
                note(k=k, fallback="failure detection")
            elif relo_match is not None:
                note(k=k, fallback="relocalization round trip")
                break
            if progress:
                print(f"[burst {k}] t={prev_t:.2f} pts={int(o['n_pts'][-1])} "
                      f"cost={float(o['cost'][-1]):.3g}")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    burst_mod.sync_back(est, fp, f_lines, carry, ts_win, last_cam_t=prev_t)
    feeder.i = packer.i
    feeder.prev_t, feeder.prev_acc, feeder.prev_gyr = (packer.prev_t, packer.prev_acc,
                                                       packer.prev_gyr)
    if packer.prev_acc is not None:
        # the next open interval seeds with the chunk's boundary sample
        est.last_acc = np.asarray(packer.prev_acc, np.float64)
        est.last_gyr = np.asarray(packer.prev_gyr, np.float64)
    if failed:
        est.clear_state()  # streaming's failureDetection: clearState and re-initialize
    return k, n_pub, relo_match


def run_synthetic(seq, config: PLSlamConfig | None = None, oracle_init: bool = False,
                  use_lines: bool = True, max_frames: int | None = None, frame_stride: int = 2,
                  progress: bool = False, drop_frames: set | None = None,
                  extrinsic_rot_override=None, device=None):
    """Feed a synthetic sequence (ground-truth associations: a perfect
    frontend) through the estimator. `frame_stride=2` turns the 20 Hz camera
    stream into the reference's 10 Hz processing rate.
    `extrinsic_rot_override`: a 3×3 R_bc the estimator starts from instead of
    the simulator's (a miscalibrated rig, for `estimate_extrinsic` 1 and 2).
    Returns (ts, ps, qs, estimator)."""
    from plslam_torch.utils.geometry import quat_to_rot

    config = config or PLSlamConfig()
    # the estimator must use the simulator's body_T_cam, not the config default
    R_bc = quat_to_rot(torch.as_tensor(np.asarray(seq.q_bc), dtype=torch.float64)).numpy()
    if extrinsic_rot_override is not None:
        R_bc = np.asarray(extrinsic_rot_override, np.float64).reshape(3, 3)
    config = dataclasses.replace(config, extrinsic=ExtrinsicConfig(
        estimate_extrinsic=config.extrinsic.estimate_extrinsic,
        rot=tuple(R_bc.reshape(-1).tolist()), trans=tuple(np.asarray(seq.p_bc).tolist())))
    est = Estimator(config, device=device)

    frame_t = np.asarray(seq.frame_t)[::frame_stride]
    obs = np.asarray(seq.obs)[::frame_stride]
    obs_valid = np.asarray(seq.obs_valid)[::frame_stride]
    line_obs = np.asarray(seq.line_obs)[::frame_stride]
    line_obs_valid = np.asarray(seq.line_obs_valid)[::frame_stride]
    if max_frames is not None:
        frame_t = frame_t[:max_frames]
    gt_p = np.asarray(seq.gt_p)[::frame_stride]
    gt_q = np.asarray(seq.gt_q)[::frame_stride]
    gt_v = np.asarray(seq.gt_v)[::frame_stride]

    drop_frames = drop_frames or set()
    ts_out, ps_out, qs_out = [], [], []
    feeder = ImuFeeder(np.asarray(seq.imu_t), np.asarray(seq.imu_acc), np.asarray(seq.imu_gyr))
    for k, t in enumerate(frame_t):
        if k in drop_frames:
            continue  # dropped camera frame; IMU keeps accumulating
        feeder.feed_until(est, t)
        vis = np.nonzero(obs_valid[k])[0]
        ln_ids = ln_segs = None
        if use_lines:
            ln_ids = np.nonzero(line_obs_valid[k])[0]
            ln_segs = line_obs[k, ln_ids]
        oracle = {"p": gt_p[k], "q": gt_q[k], "v": gt_v[k]} if oracle_init else None
        m = est.process_frame(float(t), vis, obs[k, vis], None, ln_ids, ln_segs, oracle_state=oracle)
        if progress and k % 20 == 0:
            print(f"[{k}/{len(frame_t)}] t={t:.2f} init={est.initialized} cost={m.get('cost')}")
        if est.initialized:
            tt, p, q = est.latest_pose()
            ts_out.append(tt)
            ps_out.append(p)
            qs_out.append(q)
    return np.asarray(ts_out), np.asarray(ps_out), np.asarray(qs_out), est


def _refine_large_window(parts, factors, live_t, live_p, live_q, ba, bg, p_bc, q_bc,
                         config: PLSlamConfig, rounds: int, num_iters: int, mesh=None,
                         device=None):
    """The large-window runners' refinement: partition states from the live
    pass (poses, finite-difference velocities, the final window's biases,
    inverse depths re-triangulated from the live poses; no ground truth),
    one consensus BA over the stacked partitions — the batched solve, or the
    landmark-sharded one on `mesh` (`parallel.mesh2d`) — and the stitched
    keyframe trajectory. `factors`: one `WindowFactors` a partition of
    `parts`. Returns (refined_p [K,3], refined_q [K,4])."""
    from plslam_torch.models import triangulate
    from plslam_torch.models.state import layout, zero_state
    from plslam_torch.parallel import consensus, dp, mesh2d
    from plslam_torch.utils import quat_np as qnp
    from plslam_torch.utils.device import astensor

    cfg = config.solver
    lay = layout(cfg)
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    T = lambda x: astensor(np.asarray(x, np.float64), dtype, device)  # noqa: E731
    nw = cfg.window_size + 1
    live_v = np.gradient(live_p, live_t, axis=0)  # finite-difference velocities
    p_bc, q_bc = np.asarray(p_bc, np.float64), np.asarray(q_bc, np.float64)
    states = []
    for pr, f in zip(parts, factors):
        st = zero_state(cfg, dtype, device)._replace(
            p=T(live_p[pr]), q=T(live_q[pr]), v=T(live_v[pr]),
            ba=T(np.tile(ba, (nw, 1))), bg=T(np.tile(bg, (nw, 1))), p_bc=T(p_bc), q_bc=T(q_bc))
        # re-triangulate landmark depths from the LIVE poses
        q_wc = qnp.quat_mul(live_q[pr], q_bc)
        p_wc = live_p[pr] + qnp.quat_rotate(live_q[pr], np.broadcast_to(p_bc, live_p[pr].shape))
        inv_d, ok = triangulate.triangulate_points(T(p_wc), T(q_wc), f.pt_obs, f.pt_mask,
                                                   f.pt_start)
        inv_d = torch.where(ok & (inv_d > 0), inv_d, torch.full_like(inv_d, 0.2))
        # rows that fail triangulation keep a default depth but stay valid —
        # the solver's robust loss handles them as streaming does
        states.append(st._replace(inv_depth=inv_d * f.pt_valid + 0.2 * (1 - f.pt_valid)))
    st_p, f_p = dp.stack_windows(zip(states, factors))
    if mesh is None:
        st_out = consensus.consensus_solve(st_p, f_p, lay, cfg, rounds=rounds,
                                           num_iters=num_iters)
    else:
        st_out = mesh2d.consensus_distributed_solve(st_p, f_p, lay, cfg, mesh, rounds=rounds,
                                                    num_iters=num_iters)
    return consensus.stitch_trajectory(st_out, parts, len(live_t))


def run_synthetic_large_window(seq, config: PLSlamConfig | None = None, frame_stride: int = 2,
                               kf_stride: int = 5, rounds: int = 3, num_iters: int = 8,
                               oracle_init: bool = True, device=None):
    """Live large-window mode: stream the sequence through the ordinary
    sliding-window estimator for the LIVE trajectory, keep every
    `kf_stride`-th published frame as a keyframe, then refine the FULL
    keyframe history with one keyframe-partitioned consensus BA
    (`parallel.consensus`: partitions of window_size+1 keyframes solved at
    once, boundary-pose consensus between rounds). Runs on the card unless
    `device` says otherwise.

    Returns (kf_t, live_p [K,3], refined_p [K,3], refined_q [K,4], est)."""
    from plslam_torch.models import packing
    from plslam_torch.models.state import layout
    from plslam_torch.parallel import consensus

    config = config or PLSlamConfig()
    cfg = config.solver
    lay = layout(cfg)
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32

    # ---- live pass: ordinary sliding-window streaming ----
    ts, ps, qs, est = run_synthetic(seq, config, oracle_init=oracle_init, use_lines=False,
                                    frame_stride=frame_stride, device=device)
    # map published outputs back to sequence frame indices by timestamp
    frame_t = np.asarray(seq.frame_t)
    out_idx = np.searchsorted(frame_t, np.asarray(ts) - 1e-9)
    # keyframes: every kf_stride-th published frame, trimmed to FULL
    # partitions — consensus_solve chain-aligns partitions through exactly
    # one shared boundary frame, so the history must be P·window + 1 long
    kf_sel = np.arange(0, len(ts), kf_stride)
    n_kf = len(kf_sel)
    if n_kf < cfg.window_size + 2:
        raise ValueError(f"only {n_kf} keyframes — need > window_size+1")
    n_kf = ((n_kf - 1) // cfg.window_size) * cfg.window_size + 1
    kf_sel = kf_sel[:n_kf]
    kf_frames = out_idx[kf_sel]
    live_p = np.asarray(ps)[kf_sel]
    live_q = np.asarray(qs)[kf_sel]
    live_t = np.asarray(ts)[kf_sel]

    # ---- partition + pack the full keyframe history ----
    parts = consensus.partition_frames(n_kf, cfg.window_size)
    factors = [packing.factors_from_synthetic(seq, [int(kf_frames[i]) for i in pr], cfg, lay,
                                              dtype=dtype, with_lines=False,
                                              device=est.device)[1] for pr in parts]
    ref_p, ref_q = _refine_large_window(
        parts, factors, live_t, live_p, live_q, est.ba[cfg.window_size], est.bg[cfg.window_size],
        np.asarray(seq.p_bc), np.asarray(seq.q_bc), config, rounds, num_iters, device=est.device)
    return live_t, live_p, ref_p, ref_q, est


def _grid_shape(mesh_shape, n_ranks: int, lay, n_keyframes: int, window: int) -> tuple:
    """The (kf_part, lmk) grid of `run_euroc_large_window`. The default is
    JAX's rule with "devices" read as ranks: L = 4 if there are ≥ 8 ranks
    and the capacities divide, else 1; as many rows as the ranks and the
    keyframes allow. With several ranks the grid must hold every rank (one
    cell a rank), where JAX would leave devices idle: a grid that does not
    raises `ValueError`."""
    if mesh_shape is None:
        L = 4 if (n_ranks >= 8 and lay.max_f % 4 == 0 and lay.max_l % 4 == 0) else 1
        n_parts_data = max((n_keyframes - 1) // window, 1)
        mesh_shape = (max(min(n_ranks // L, n_parts_data), 1), L)
    if n_ranks > 1 and mesh_shape[0] * mesh_shape[1] != n_ranks:
        raise ValueError(f"the (kf_part, lmk) grid {tuple(mesh_shape)} does not hold the "
                         f"{n_ranks} ranks of the world: pass a mesh_shape with P·L = {n_ranks} "
                         f"(P ≤ {max((n_keyframes - 1) // window, 1)} partitions of these "
                         "keyframes)")
    return tuple(mesh_shape)


def run_euroc_large_window(seq_path: str, config: PLSlamConfig | None = None, kf_stride: int = 3,
                           rounds: int = 3, num_iters: int = 8, mesh_shape: tuple | None = None,
                           max_frames: int | None = None, device=None):
    """Distributed large-window refinement FROM IMAGES: stream the image
    pipeline (`run_euroc` with the frontends' tracks recorded, loop closure
    off), then refine the full keyframe history by keyframe-partitioned
    consensus BA where every partition's landmark system is sharded over a
    (kf_part, lmk) grid (`parallel.mesh2d`). Poses from the live (drifted)
    trajectory, velocities by finite differences, biases from the
    estimator's final window, depths re-triangulated from live poses,
    observations from the real trackers. Runs on the card unless `device`
    says otherwise.

    mesh_shape (kf_part, lmk) defaults to JAX's rule over the ranks of the
    world: L = 4 if there are ≥ 8 ranks and the capacities divide, else 1,
    and P = min(ranks // L, the partitions the keyframes fill); one process
    gives (1, 1). With more than one rank the grid spans the world's process
    group, one cell a rank, so P·L must equal the world's size (`ValueError`
    otherwise, the default grid included); one process holds any grid on its
    device.
    Returns (kf_t, live_p [K,3], refined_p [K,3], refined_q [K,4], est)."""
    import torch.distributed as dist

    from plslam_torch.io.euroc import EurocSequence
    from plslam_torch.models import packing
    from plslam_torch.models.state import layout
    from plslam_torch.parallel import consensus, mesh2d, multihost

    config = config or PLSlamConfig()
    cfg = config.solver
    lay = layout(cfg)
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32

    # ---- live pass: the real image pipeline, tracks recorded ----
    tracks: dict = {}
    ts, ps, qs, est, _ = run_euroc(seq_path, config, loop_closure=False, max_frames=max_frames,
                                   record_tracks=tracks, device=device)
    ts = np.asarray(ts)
    have = np.asarray([float(t) in tracks for t in ts], bool)
    ts, ps, qs = ts[have], np.asarray(ps)[have], np.asarray(qs)[have]

    # ---- grid geometry: P partitions × L landmark shards ----
    n_dev = multihost.world_size()
    n_part_mesh, L = _grid_shape(mesh_shape, n_dev, lay, len(range(0, len(ts), kf_stride)),
                                 cfg.window_size)
    assert lay.max_f % L == 0 and lay.max_l % L == 0, \
        "max_features/max_line_feats must divide the lmk mesh axis"

    kf_sel = np.arange(0, len(ts), kf_stride)
    if len(kf_sel) < cfg.window_size + 2:
        raise ValueError(f"only {len(kf_sel)} keyframes — need > window_size+1")
    # the partition count must EQUAL the grid's row axis (each row owns
    # exactly one partition); trim the history to fit
    n_kf = n_part_mesh * cfg.window_size + 1
    if len(kf_sel) < n_kf:
        raise ValueError(f"need {n_kf} keyframes for a {n_part_mesh}-row mesh, "
                         f"have {len(kf_sel)} (lower kf_stride or mesh rows)")
    kf_sel = kf_sel[:n_kf]
    live_t = ts[kf_sel]
    live_p = ps[kf_sel]
    live_q = qs[kf_sel]

    # ---- pack each partition from the recorded REAL tracks ----
    seq = EurocSequence.load(seq_path)
    parts = consensus.partition_frames(n_kf, cfg.window_size)
    ba = np.asarray(est.ba[cfg.window_size])
    bg = np.asarray(est.bg[cfg.window_size])
    factors = []
    for pr in parts:
        kt = [float(ts[int(kf_sel[i])]) for i in pr]
        factors.append(packing.factors_from_tracks(
            kt, [tracks[t][0] for t in kt], [tracks[t][1] for t in kt],
            seq.imu_t, seq.imu_acc, seq.imu_gyr, cfg, lay, ba, bg, dtype=dtype,
            g_norm=config.imu.g_norm, device=est.device))
    mesh = mesh2d.make_mesh2d(n_part_mesh, L, dist.group.WORLD if n_dev > 1 else None)
    ref_p, ref_q = _refine_large_window(parts, factors, live_t, live_p, live_q, ba, bg,
                                        est.p_bc, est.q_bc, config, rounds, num_iters,
                                        mesh=mesh, device=est.device)
    return live_t, live_p, ref_p, ref_q, est
