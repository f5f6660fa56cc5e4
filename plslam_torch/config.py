"""Configuration dataclasses — key-compatible with the reference's YAML surface.

The port's own copy of `plslam/config.py`: the same dataclasses, field
names, defaults and `from_yaml` loader (`tests/test_torch_lines.py` holds
the two equal; `plslam_torch.convert.config_from_jax` maps one to the
other). Mirrors the `readParameters()` key set of the reference
(`feature_tracker/src/parameters.cpp`, `vins_estimator/src/parameters.cpp`,
pose-graph params — SURVEY.md §5.6) so a reference EuRoC YAML translates
mechanically. Frozen + hashable → usable as a cache key.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class CameraConfig:
    """Camera intrinsics for every camodocal model the reference's
    `CameraFactory` dispatches on (SURVEY.md §2.5). Field use per model:
    PINHOLE — fx..cy + k1,k2,p1,p2 (radtan); KANNALA_BRANDT — fx..cy
    (= mu,mv,u0,v0) + kb2..kb5 (θ-polynomial); MEI — xi + fx..cy
    (= gamma1,gamma2,u0,v0) + k1,k2,p1,p2; SCARAMUZZA — a0,a2,a3,a4
    (ρ-polynomial) + ac,ad,ae (affine) + cx,cy (center)."""

    model_type: str = "PINHOLE"
    image_width: int = 752
    image_height: int = 480
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    k1: float = -0.28340811
    k2: float = 0.07395907
    p1: float = 0.00019359
    p2: float = 1.76187114e-05
    # Kannala-Brandt (Equidistant) θ-polynomial coefficients
    kb2: float = 0.0
    kb3: float = 0.0
    kb4: float = 0.0
    kb5: float = 0.0
    # MEI mirror parameter
    xi: float = 0.0
    # Scaramuzza ρ-polynomial + affine sensor map
    a0: float = 0.0
    a2: float = 0.0
    a3: float = 0.0
    a4: float = 0.0
    ac: float = 1.0
    ad: float = 0.0
    ae: float = 0.0


@dataclass(frozen=True)
class TrackerConfig:
    """`feature_tracker` node params (SURVEY.md §2.1)."""

    max_cnt: int = 150
    min_dist: int = 30
    freq: int = 10
    f_threshold: float = 1.0
    min_score: float = 1e-4  # Shi-Tomasi quality gate (goodFeaturesToTrack qualityLevel)
    equalize: bool = True
    fisheye: bool = False
    # optional mask image path (the reference's fisheye_mask.jpg): nonzero
    # pixels = usable FOV. Empty string = the standard centered circle.
    fisheye_mask: str = ""
    show_track: bool = False
    # line tracker
    max_lines: int = 64
    lsd_min_length: float = 30.0  # px
    lbd_match_thresh: int = 30  # Hamming distance gate
    line_desc: str = "float"  # "float" (cosine matmul) | "binary" (256-bit Hamming)


@dataclass(frozen=True)
class SolverConfig:
    """Backend solver params (`vins_estimator` globals, SURVEY.md §2.3)."""

    window_size: int = 10  # 11 states in the window
    max_num_iterations: int = 8
    max_solver_time: float = 0.04  # informational; TPU path is fixed-iteration
    keyframe_parallax: float = 10.0  # px, MIN_PARALLAX (divided by FOCAL internally)
    focal_length: float = 460.0  # FOCAL_LENGTH for residual whitening
    # fixed capacities (TPU static shapes) — no reference equivalent (lists there)
    max_features: int = 192
    max_line_feats: int = 64
    # damping / robust loss
    cauchy_c: float = 1.0
    lm_lambda_init: float = 1e-4
    lm_lambda_min: float = 1e-9
    lm_lambda_max: float = 1e2
    eig_eps: float = 1e-8  # marginalization eigenvalue floor
    # solver dtype for the normal equations ("float32" | "float64")
    dtype: str = "float32"
    # line factor parameterization (the reference ships three variants:
    # `lineProjectionFactor` world-frame, `…_incamera` anchored in the first
    # observing camera, `…_instartframe` anchored in the first observing body
    # frame — factor/line_projection_factor.cpp, SURVEY.md §2.3)
    line_param: str = "world"  # "world" | "incamera" | "instartframe"


@dataclass(frozen=True)
class ImuConfig:
    acc_n: float = 0.08
    gyr_n: float = 0.004
    acc_w: float = 4e-5
    gyr_w: float = 2e-6
    g_norm: float = 9.81007


@dataclass(frozen=True)
class ExtrinsicConfig:
    estimate_extrinsic: int = 0  # 0: fixed, 1: refine, 2: calibrate from scratch
    # body_T_cam0 rotation (row-major) + translation; EuRoC defaults (Kalibr)
    rot: tuple = (
        0.0148655429818, -0.999880929698, 0.00414029679422,
        0.999557249008, 0.0149672133247, 0.025715529948,
        -0.0257744366974, 0.00375618835797, 0.999660727178,
    )
    trans: tuple = (-0.0216401454975, -0.064676986768, 0.00981073058949)


@dataclass(frozen=True)
class TemporalConfig:
    estimate_td: bool = False
    td: float = 0.0
    rolling_shutter: bool = False
    rolling_shutter_tr: float = 0.0


@dataclass(frozen=True)
class LoopConfig:
    loop_closure: bool = True
    fast_relocalization: bool = False
    load_previous_pose_graph: bool = False
    save_pose_graph: bool = False  # persist the map at end of sequence
    pose_graph_save_path: str = "/tmp/plslam_pose_graph"
    # keyframe DB / matching gates (KeyFrame::findConnection thresholds)
    min_loop_gap: int = 50
    desc_hamming_thresh: int = 80
    min_pnp_inliers: int = 25
    max_loop_yaw_deg: float = 30.0
    max_loop_translation: float = 20.0
    max_keyframes: int = 2048  # fixed DB capacity (TPU static shapes)
    # detectLoop temporal consistency: a candidate is accepted only when the
    # previous (loop_consistency − 1) keyframe queries also produced a
    # candidate within ±consistency_gap indices of it — transient perceptual
    # aliasing fires once and is rejected; real revisits persist. Loaded-map
    # candidates bypass this (fast_relocalization wants immediacy).
    loop_consistency: int = 2
    consistency_gap: int = 12
    # global-descriptor cosine acceptance threshold of detectLoop (the
    # reference's 0.05/0.015 DBoW2 scores; ours is on the sign-random
    # -projection descriptor's scale — tuned on the rendered aliased-rooms
    # scene, tests/test_loop_e2e.py)
    loop_min_score: float = 0.15


@dataclass(frozen=True)
class PLSlamConfig:
    camera: CameraConfig = CameraConfig()
    tracker: TrackerConfig = TrackerConfig()
    solver: SolverConfig = SolverConfig()
    imu: ImuConfig = ImuConfig()
    extrinsic: ExtrinsicConfig = ExtrinsicConfig()
    temporal: TemporalConfig = TemporalConfig()
    loop: LoopConfig = LoopConfig()
    output_path: str = "/tmp/plslam_output"

    @staticmethod
    def from_yaml(path: str) -> "PLSlamConfig":
        """Load a reference-format YAML (cv::FileStorage layout, SURVEY.md §5.6)."""
        import yaml

        with open(path) as f:
            text = f.read()
        # cv::FileStorage files start with a %YAML directive + !!opencv tag
        lines = [l for l in text.splitlines() if not l.startswith("%YAML")]
        raw = yaml.safe_load("\n".join(lines).replace("!!opencv-matrix", ""))

        def g(key, default):
            return raw.get(key, default) if raw else default

        dist = g("distortion_parameters", {}) or {}
        proj = g("projection_parameters", {}) or {}
        mirror = g("mirror_parameters", {}) or {}
        poly = g("poly_parameters", {}) or {}
        affine = g("affine_parameters", {}) or {}
        mt = str(g("model_type", "PINHOLE")).upper()
        # camodocal key sets per model (CameraFactory YAML surface): KB stores
        # mu/mv/u0/v0 + k2..k5 in projection_parameters; MEI stores
        # gamma1/gamma2/u0/v0 + mirror xi; Scaramuzza stores the ρ-polynomial
        # + affine/center blocks
        fx = proj.get("fx", proj.get("mu", proj.get("gamma1", 458.654)))
        fy = proj.get("fy", proj.get("mv", proj.get("gamma2", 457.296)))
        cx = proj.get("cx", proj.get("u0", affine.get("cx", 367.215)))
        cy = proj.get("cy", proj.get("v0", affine.get("cy", 248.375)))
        cam = CameraConfig(
            model_type=mt,
            image_width=g("image_width", 752),
            image_height=g("image_height", 480),
            fx=fx, fy=fy, cx=cx, cy=cy,
            k1=dist.get("k1", 0.0), k2=dist.get("k2", 0.0),
            p1=dist.get("p1", 0.0), p2=dist.get("p2", 0.0),
            kb2=proj.get("k2", 0.0), kb3=proj.get("k3", 0.0),
            kb4=proj.get("k4", 0.0), kb5=proj.get("k5", 0.0),
            xi=mirror.get("xi", 0.0),
            a0=poly.get("p0", 0.0), a2=poly.get("p2", 0.0),
            a3=poly.get("p3", 0.0), a4=poly.get("p4", 0.0),
            ac=affine.get("ac", 1.0), ad=affine.get("ad", 0.0),
            ae=affine.get("ae", 0.0),
        )
        tracker = TrackerConfig(
            max_cnt=g("max_cnt", 150), min_dist=g("min_dist", 30),
            freq=g("freq", 10), f_threshold=g("F_threshold", 1.0),
            equalize=bool(g("equalize", 1)), fisheye=bool(g("fisheye", 0)),
            fisheye_mask=str(g("fisheye_mask", "")),
            show_track=bool(g("show_track", 0)),
            min_score=g("min_score", 1e-4),
            max_lines=g("max_lines", 64),
            lsd_min_length=g("lsd_min_length", 30.0),
            lbd_match_thresh=g("lbd_match_thresh", 30),
            line_desc=str(g("line_desc", "float")),
        )
        solver = SolverConfig(
            max_num_iterations=g("max_num_iterations", 8),
            max_solver_time=g("max_solver_time", 0.04),
            keyframe_parallax=g("keyframe_parallax", 10.0),
            window_size=g("window_size", 10),
            max_features=g("max_features", 192),
            max_line_feats=g("max_line_feats", 64),
            focal_length=g("focal_length", 460.0),
            dtype=g("solver_dtype", "float32"),
            line_param=g("line_param", "world"),
        )
        imu = ImuConfig(
            acc_n=g("acc_n", 0.08), gyr_n=g("gyr_n", 0.004),
            acc_w=g("acc_w", 4e-5), gyr_w=g("gyr_w", 2e-6),
            g_norm=g("g_norm", 9.81007),
        )
        ext = ExtrinsicConfig(estimate_extrinsic=g("estimate_extrinsic", 0))
        er = g("extrinsicRotation", None)
        et = g("extrinsicTranslation", None)
        if isinstance(er, dict) and "data" in er:
            ext = dataclasses.replace(ext, rot=tuple(er["data"]))
        if isinstance(et, dict) and "data" in et:
            ext = dataclasses.replace(ext, trans=tuple(et["data"]))
        temporal = TemporalConfig(
            estimate_td=bool(g("estimate_td", 0)), td=g("td", 0.0),
            rolling_shutter=bool(g("rolling_shutter", 0)),
            rolling_shutter_tr=g("rolling_shutter_tr", 0.0),
        )
        loop = LoopConfig(
            loop_closure=bool(g("loop_closure", 1)),
            fast_relocalization=bool(g("fast_relocalization", 0)),
            load_previous_pose_graph=bool(g("load_previous_pose_graph", 0)),
            save_pose_graph=bool(g("save_pose_graph", 0)),
            pose_graph_save_path=g("pose_graph_save_path", "/tmp/plslam_pose_graph"),
            min_loop_gap=g("min_loop_gap", 50),
            desc_hamming_thresh=g("desc_hamming_thresh", 80),
            min_pnp_inliers=g("min_pnp_inliers", 25),
            max_loop_yaw_deg=g("max_loop_yaw_deg", 30.0),
            max_loop_translation=g("max_loop_translation", 20.0),
            max_keyframes=g("max_keyframes", 2048),
            loop_consistency=g("loop_consistency", 2),
            consistency_gap=g("consistency_gap", 12),
            loop_min_score=g("loop_min_score", 0.15),
        )
        return PLSlamConfig(
            camera=cam, tracker=tracker, solver=solver, imu=imu, extrinsic=ext,
            temporal=temporal, loop=loop, output_path=g("output_path", "/tmp/plslam_output"),
        )
