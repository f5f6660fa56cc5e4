"""The JAX package's run-level estimator scenarios on the port (no JAX), each
at the reference test's settings and held to its assertions:
`tests/test_robustness.py` (frame drops, corrupted observations, feature
collapse → re-initialization, the IMU-pad-overflow keyframe) and
`tests/test_estimator.py` (oracle-init points and lines with the IMU-rate
pose, the anchored line chart, the deferred solve bit for bit).

Each scenario function takes the device to run on and returns a few numbers
for the log and the run's trajectory (`ts`, `ps`; the deferred solve: the
final window positions `p`). The inputs it changes (dropped frames,
corrupted observations, a blanked stretch, the low-parallax trajectory, the
frame loop) are built by the numpy helpers here, so that a JAX run can be
given the same ones. `tests/test_torch_robustness.py` runs the scenarios on
the CPU beside JAX's (marked `slow`: each takes minutes there) and
`chip_smoke.py` phase 10(e) on the card.
"""
import dataclasses

import numpy as np
import torch

from plslam_torch.config import PLSlamConfig, SolverConfig
from plslam_torch.eval.metrics import ate_rmse
from plslam_torch.io import synthetic
from plslam_torch.runner import run_synthetic

WIDTHS = dict(max_features=96, max_line_feats=24, dtype="float64")
CONFIG = PLSlamConfig(solver=SolverConfig(**WIDTHS))
ROBUSTNESS_SEQUENCE = dict(duration=8.0, n_points=140, n_lines=24, seed=13)
ESTIMATOR_SEQUENCE = dict(duration=10.0, n_points=140, n_lines=48, seed=11)
DROPPED_FRAMES = {18, 19, 25, 31, 32, 33}
# the IMU-pad overflow: a hover-like circle, narrower lines, a 64-sample bucket
PAD_TRAJECTORY = dict(radius=4.0, omega=0.005, z_amp=0.0, pitch_amp=0.0, roll_amp=0.0)
PAD_SEQUENCE = dict(duration=6.0, n_points=120, n_lines=8, seed=3)
PAD_WIDTHS = dict(max_features=96, max_line_feats=8, dtype="float64")
IMU_PAD = 64


def robustness_sequence():
    """`tests/test_robustness.py`'s fixture."""
    return synthetic.make_sequence(**ROBUSTNESS_SEQUENCE)


def estimator_sequence():
    """`tests/test_estimator.py`'s fixture."""
    return synthetic.make_sequence(**ESTIMATOR_SEQUENCE)


def pad_sequence():
    return synthetic.make_sequence(params=synthetic.TrajectoryParams(**PAD_TRAJECTORY),
                                   **PAD_SEQUENCE)


def corrupt(obs):
    """Half the observations of frames 40–45 moved by 0.1–0.3 (normalized
    coordinates), as the reference test does."""
    obs = np.asarray(obs).copy()
    rng = np.random.default_rng(0)
    for k in range(40, 46):
        n = obs.shape[1]
        sel = rng.choice(n, n // 2, replace=False)
        obs[k, sel] += rng.uniform(0.1, 0.3, (len(sel), 2)) * rng.choice([-1, 1], (len(sel), 2))
    return obs


def blank(obs_valid, line_obs_valid):
    """Camera frames 70–77 with no point and no line."""
    valid, lvalid = np.asarray(obs_valid).copy(), np.asarray(line_obs_valid).copy()
    valid[70:78] = False
    lvalid[70:78] = False
    return valid, lvalid


def drive(est, seq, defer):
    """`test_deferred_solve_bit_identical`'s frame loop: the first 60
    published frames with their IMU, oracle-initialized, the solve deferred
    or not; works on either package's `Estimator`."""
    imu_t = np.asarray(seq.imu_t)
    frame_t = np.asarray(seq.frame_t)[::2][:60]
    obs = np.asarray(seq.obs)[::2]
    obs_valid = np.asarray(seq.obs_valid)[::2]
    gt = (np.asarray(seq.gt_p)[::2], np.asarray(seq.gt_q)[::2], np.asarray(seq.gt_v)[::2])
    acc, gyr = np.asarray(seq.imu_acc), np.asarray(seq.imu_gyr)
    imu_i, prev_t = 0, None
    for k, t in enumerate(frame_t):
        while imu_i < len(imu_t) and imu_t[imu_i] <= t + 1e-9:
            dt = (imu_t[imu_i] - prev_t) if prev_t is not None else 0.005
            est.process_imu(dt, acc[imu_i], gyr[imu_i])
            prev_t = imu_t[imu_i]
            imu_i += 1
        vis = np.nonzero(obs_valid[k])[0]
        est.process_frame(float(t), vis, obs[k, vis], None,
                          oracle_state={"p": gt[0][k], "q": gt[1][k], "v": gt[2][k]},
                          defer_solve=defer)
    est.finalize()
    return est


def _ate(seq, ts, ps):
    return ate_rmse(ts, ps, np.asarray(seq.frame_t), np.asarray(seq.gt_p), align="yaw")


def frame_drops(device, seq=None):
    """Dropped camera frames (merged IMU intervals) must not derail tracking."""
    seq = seq or robustness_sequence()
    ts, ps, _, est = run_synthetic(seq, CONFIG, oracle_init=True, use_lines=False,
                                   drop_frames=DROPPED_FRAMES, device=device)
    assert est.initialized
    ate = _ate(seq, ts, ps)
    assert ate < 0.05, f"ATE {ate:.4f} with frame drops"
    return {"poses": len(ts), "ate_m": ate, "ts": ts, "ps": ps}


def corrupted_observations(device, seq=None):
    """A burst of grossly wrong observations is rejected by the robust loss
    and the outlier gating, and the clean first third stays accurate."""
    seq = seq or robustness_sequence()
    seq_bad = seq._replace(obs=torch.as_tensor(corrupt(seq.obs)))
    ts, ps, _, est = run_synthetic(seq_bad, CONFIG, oracle_init=True, use_lines=False,
                                   device=device)
    assert len(ts) > 20
    third = len(ts) // 3
    ate = _ate(seq, ts[:third], ps[:third])
    assert ate < 0.05, f"clean-prefix ATE {ate:.4f}"
    return {"poses": len(ts), "clean_prefix_ate_m": ate, "ts": ts, "ps": ps}


def feature_collapse(device, seq=None):
    """A texture-less stretch trips failure detection (tracked-feature
    collapse), and the estimator re-initializes and solves after it."""
    seq = seq or robustness_sequence()
    valid, lvalid = blank(seq.obs_valid, seq.line_obs_valid)
    seq_blank = seq._replace(obs_valid=torch.as_tensor(valid),
                             line_obs_valid=torch.as_tensor(lvalid))
    ts, ps, _, est = run_synthetic(seq_blank, CONFIG, oracle_init=True, use_lines=False,
                                   device=device)
    failures = [m for m in est.metrics if m.get("failure")]
    assert failures, "feature collapse never tripped failure detection"
    assert any(m.get("long_tracked", 99) < 2 for m in failures)
    t_fail = failures[0]["t"]
    post = [m for m in est.metrics if m["t"] > t_fail + 1.5 and "cost" in m]
    assert est.initialized and len(post) > 5, "no recovery after collapse"
    return {"failures": len(failures), "solves_after": len(post), "ts": ts, "ps": ps}


def imu_pad_overflow(device, seq=None):
    """Low-parallax stretches chain MARGIN_SECOND_NEW merges; a keyframe is
    forced before the merged interval outgrows the IMU bucket (IMU_PAD,
    made 64 here), so every IMU factor covers its whole frame gap."""
    from plslam_torch.models import estimator as est_mod

    seq = seq or pad_sequence()
    cfg = PLSlamConfig(solver=SolverConfig(**PAD_WIDTHS))
    pad = est_mod.IMU_PAD
    est_mod.IMU_PAD = IMU_PAD
    try:
        ts, ps, _, est = run_synthetic(seq, cfg, oracle_init=True, use_lines=False,
                                       device=device)
    finally:
        est_mod.IMU_PAD = pad
    longest = max(len(b.dt) for b in est.imu_bufs)
    assert longest > 32
    assert all(len(b.dt) <= IMU_PAD for b in est.imu_bufs)
    nw = est.cfg.window_size
    for k in range(1, min(nw + 1, len(est.pres))):
        pre = est.pres[k]
        if pre is None:
            continue
        gap = est.timestamps[k] - est.timestamps[k - 1]
        assert abs(float(pre["dt_sum"]) - gap) < 1e-6, (k, float(pre["dt_sum"]), gap)
    return {"longest_interval": longest, "ts": ts, "ps": ps}


def oracle_points_lines(device, seq=None):
    """Oracle-init points and lines track the truth, and the IMU-rate
    dead-reckoned newest slot sits near the last solved pose."""
    seq = seq or estimator_sequence()
    ts, ps, _, est = run_synthetic(seq, CONFIG, oracle_init=True, use_lines=True, device=device)
    assert est.initialized
    assert len(ts) > 30
    ate = _ate(seq, ts, ps)
    assert ate < 0.05, f"ATE {ate:.4f} m"
    p_hi, q_hi, v_hi = est.imu_rate_pose()
    _, p_kf, _ = est.latest_pose()
    gap = float(np.linalg.norm(p_hi - p_kf))
    assert gap < 0.2
    assert np.isfinite(v_hi).all()
    return {"poses": len(ts), "ate_m": ate, "imu_rate_gap_m": gap, "ts": ts, "ps": ps,
            "imu_rate_pose": (p_hi, q_hi, v_hi)}


def anchored_line_chart(device, seq=None):
    """End to end with the `…_incamera` line chart: lines solved in the
    anchor-camera chart, marginalized with the carried residual groups and
    converted back through world coordinates each frame."""
    seq = seq or estimator_sequence()
    cfg = dataclasses.replace(CONFIG, solver=dataclasses.replace(CONFIG.solver,
                                                                 line_param="incamera"))
    ts, ps, _, est = run_synthetic(seq, cfg, oracle_init=True, use_lines=True, device=device)
    assert est.initialized
    ate = _ate(seq, ts, ps)
    assert ate < 0.05, f"ATE {ate:.4f} m"
    return {"poses": len(ts), "ate_m": ate, "ts": ts, "ps": ps}


def deferred_solve(device, seq=None):
    """`defer_solve=True` (the solve overlapped with the next frame's work)
    gives BIT-identical state to the synchronous path: IMU samples that
    arrive while the solve is in flight are replayed onto the solved state
    at `finalize()`."""
    from plslam_torch.models.estimator import Estimator

    seq = seq or estimator_sequence()
    est_a = drive(Estimator(CONFIG, device=device), seq, False)
    est_b = drive(Estimator(CONFIG, device=device), seq, True)
    for name in ("p", "q", "v", "ba"):
        np.testing.assert_array_equal(getattr(est_a, name), getattr(est_b, name))
    np.testing.assert_array_equal(est_a.pt_table.inv_depth, est_b.pt_table.inv_depth)
    costs_a = [m.get("cost") for m in est_a.metrics if "cost" in m]
    costs_b = [m.get("cost") for m in est_b.metrics if "cost" in m]
    assert costs_a == costs_b
    return {"solves": len(costs_a), "p": est_a.p.copy()}
