"""Sequence runners: drive the estimator over a dataset.

Counterpart of `plslam/runner.py`. `run_euroc` is the streaming pipeline
(PNG decode + CLAHE → point and line frontends → IMU pairing → estimator),
`run_synthetic` feeds simulator observations straight to the estimator.
Every entry point runs on the card unless its `device=` names another.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from plslam_torch.config import ExtrinsicConfig, PLSlamConfig
from plslam_torch.models.estimator import Estimator
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
              progress: bool = False, pipeline: bool = True, burst: int = 0, device=None):
    """Streaming pipeline on an EuRoC ASL sequence: image → CLAHE → point
    and line frontends → IMU pairing → estimator. Runs on the card unless
    `device` says otherwise.

    FREQ control: the point frontend tracks EVERY camera frame but publishes
    to the estimator every `stride`-th one; tracked-only frames run pyramid
    + LK. The line frontend (`use_lines`, matched by binary LBD when
    `config.tracker.line_desc == "binary"`) runs on published frames only,
    on the point pyramid's level 0 as its image and level 1 as its second
    octave; both frontends' bundles are read back with one wait.
    `pipeline=True` decodes frame k+1 on a worker thread while frame k runs
    and defers each solve's readback to the next published frame; the
    trajectory is identical to `pipeline=False`.

    Loop closure (`loop_closure`, by default `config.loop.loop_closure`):
    every solved keyframe enters the pose graph with its CLAHE'd image and
    the estimator's window points; a confirmed loop starts the
    relocalization round trip (`set_relo_frame` → the next joint solve →
    `update_loop_edge`), the 4-DoF PGO runs when an edge is pending, and
    every emitted pose is drift-corrected. The map is loaded and saved as
    `config.loop` says.

    Returns (ts, ps, qs, estimator, pose graph or None)."""
    if burst:
        raise NotImplementedError(
            "run_euroc(burst>0): offline burst replay is ROADMAP queue 1 item 14 (slice E)")
    from plslam_torch.io.euroc import EurocSequence
    from plslam_torch.models.frontend_lines import FrontendLines
    from plslam_torch.models.frontend_points import FrontendPoints
    from plslam_torch.models.pose_graph import PoseGraph
    from plslam_torch.ops.cameras import make_camera, normalized_to_pixel

    config = config or PLSlamConfig()
    loop_closure = config.loop.loop_closure if loop_closure is None else loop_closure
    tr = config.tracker
    if tr.fisheye and tr.fisheye_mask:
        raise NotImplementedError("run_euroc: fisheye mask images are not ported yet")
    seq = EurocSequence.load(seq_path)
    est = Estimator(config, device=device)
    cam = make_camera(config.camera)
    fp = FrontendPoints(cam, max_cnt=tr.max_cnt, min_dist=tr.min_dist,
                        f_thresh_px=tr.f_threshold, focal=config.camera.fx,
                        min_score=tr.min_score, fisheye=tr.fisheye, device=est.device)
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
    stride = max(1, round(20 / tr.freq))
    max_pub = max_frames if max_frames is not None else len(seq.cam_t)

    def _load(k):
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
            if loop is not None and pgraph.last_match is not None:
                # relocalization feedback (`setReloFrame`): the next solve
                # refines the loop jointly
                mm = pgraph.last_match
                if est.set_relo_frame(mm["ids"], mm["obs_old"], mm["p_old"], mm["q_old"]):
                    relo_edge["ij"] = (mm["old_idx"], mm["cur_idx"])
            if loop is not None and config.loop.fast_relocalization and loop["i"] < pgraph.base_n:
                pgraph.fast_relocalize(loop)  # the edge lands in the loaded map
        if pgraph is not None:
            if pgraph._pending_opt:
                pgraph.optimize()
            p, q = pgraph.correct(p, q)  # every published pose, not only keyframes
        ts_out.append(tt)
        ps_out.append(p)
        qs_out.append(q)

    n_pub = 0
    prev_cam_t = None
    try:
        for k in range(len(seq.cam_t)):
            if n_pub >= max_pub:
                break
            t = float(seq.cam_t[k])
            # restart handshake: a timestamp discontinuity resets the trackers
            # (the estimator resets itself in process_frame)
            if prev_cam_t is not None and (t < prev_cam_t - 1e-9 or t - prev_cam_t > 1.0):
                fp.reset()
                if f_lines is not None:
                    f_lines.reset()
            prev_cam_t = t
            if executor is not None:
                img = pending.result()
                if k + 1 < len(seq.cam_t):
                    pending = executor.submit(_load, k + 1)
            else:
                img = _load(k)
            publish = k % stride == 0
            pts_h = fp.process(img, t, want_output="defer" if publish else False, light=not publish)
            if not publish:
                continue
            if f_lines is not None:
                pyr = fp.prev_pyr
                ln_h = f_lines.process(pyr[0], t, oct1=pyr[1] if len(pyr) > 1 else None,
                                       want_output="defer")
                (ids, pts, vel, _), (ln_ids, ln_segs) = HostCopy.get_joint(pts_h, ln_h)
            else:
                ids, pts, vel, _ = pts_h.get()
                ln_ids = ln_segs = None
            n_pub += 1
            if deferred is not None:
                _emit(deferred)
                deferred = None
            feeder.feed_until(est, t)
            m = est.process_frame(t, ids, pts, vel, ln_ids, ln_segs, defer_solve=pipeline)
            if pipeline:
                deferred = (m, img)
            else:
                _emit((m, img))
            if progress and k % 100 == 0:
                print(f"[{k}] t={t:.2f} init={est.initialized} pts={m.get('n_pts')} "
                      f"lines={m.get('n_lines')}")
        if deferred is not None:
            _emit(deferred)  # drain the last in-flight solve
        if pgraph is not None and pgraph._pending_opt:
            # a loop on the final published frame still gets its 4-DoF solve,
            # on the raw PnP edge
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


def run_synthetic(seq, config: PLSlamConfig | None = None, oracle_init: bool = False,
                  use_lines: bool = True, max_frames: int | None = None, frame_stride: int = 2,
                  progress: bool = False, drop_frames: set | None = None, device=None):
    """Feed a synthetic sequence (ground-truth associations: a perfect
    frontend) through the estimator. `frame_stride=2` turns the 20 Hz camera
    stream into the reference's 10 Hz processing rate.
    Returns (ts, ps, qs, estimator)."""
    from plslam_torch.utils.geometry import quat_to_rot

    config = config or PLSlamConfig()
    # the estimator must use the simulator's body_T_cam, not the config default
    R_bc = quat_to_rot(torch.as_tensor(np.asarray(seq.q_bc), dtype=torch.float64)).numpy()
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
