"""The port held to the JAX package's measurement-pairing and time-offset
tests (`tests/test_measurement_pairing.py`, `tests/test_td.py`), which the
burst's IMU packing and its `td_pair` bookkeeping rest on.

Pairing: each case's own assertions on the port's `ImuFeeder` + `Estimator`
(an interval's dt_sum equals the frame gap to 1e-6 s off the IMU grid and
1e-9 s on it), and the port's preintegrations equal to the JAX package's
within 1e-12 (float64, the same samples). Time offset: the JAX test's
window (`packing.factors_from_synthetic`, which the port does not have)
handed to the port's `optimize_window`: td recovered within 2e-3 s of the
injected 12 ms and within 1e-8 s of the JAX solve's; the rolling-shutter
term undoes a row-dependent shift to 1e-9 and is > 0.1 without it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.config import PLSlamConfig, SolverConfig, TemporalConfig
from plslam.io import synthetic
from plslam.io.synthetic import gt_pose
from plslam.models import packing
from plslam.models import solver as jsolver
from plslam.models.estimator import Estimator as JEstimator
from plslam.models.state import layout as jlayout
from plslam.runner import ImuFeeder as JImuFeeder
from plslam.utils.geometry import quat_mul, quat_rotate, quat_to_rot
from plslam_torch.convert import config_from_jax, factors_from_numpy, window_state_from_numpy
from plslam_torch.models import residuals as tres
from plslam_torch.models import solver as tsolver
from plslam_torch.models.estimator import Estimator as TEstimator
from plslam_torch.models.state import layout as tlayout
from plslam_torch.runner import ImuFeeder as TImuFeeder

IMU_HZ = 200.0
TD_CFG = SolverConfig(max_features=48, max_line_feats=8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _imu_stream(duration=3.0):
    """Smoothly varying IMU signal on an exact 200 Hz grid (the JAX test's)."""
    t = np.arange(0.0, duration, 1.0 / IMU_HZ)
    acc = np.stack([0.3 * np.sin(2.1 * t), 0.2 * np.cos(1.7 * t), 9.81 + 0.1 * np.sin(0.9 * t)],
                   axis=1)
    gyr = np.stack([0.1 * np.sin(1.3 * t), 0.05 * np.cos(2.3 * t), 0.2 * np.sin(0.7 * t)], axis=1)
    return t, acc, gyr


def _run_frames(frame_t, td=0.0):
    """The same frames through both packages' feeder and estimator."""
    cfg = PLSlamConfig(solver=SolverConfig(max_features=32, max_line_feats=8, dtype="float64"),
                       temporal=TemporalConfig(td=td))
    jest, test = JEstimator(cfg), TEstimator(config_from_jax(cfg), device="cpu")
    imu_t, acc, gyr = _imu_stream()
    jfeed, tfeed = JImuFeeder(imu_t, acc, gyr), TImuFeeder(imu_t, acc, gyr)
    ids = np.arange(10)
    obs = np.tile(np.linspace(-0.3, 0.3, 10)[:, None], (1, 2))
    for t in frame_t:
        jfeed.feed_until(jest, t)
        tfeed.feed_until(test, t)
        jest.process_frame(float(t), ids, obs, None)
        test.process_frame(float(t), ids, obs, None)
    for k in range(1, len(test.pres)):
        if test.pres[k] is None:
            assert jest.pres[k] is None
            continue
        for name in ("alpha", "beta", "gamma", "dt_sum", "jac"):
            np.testing.assert_allclose(test.pres[k][name].numpy(), np.asarray(jest.pres[k][name]),
                                       rtol=0, atol=1e-12, err_msg=f"{k} {name}")
    return test


def test_offgrid_boundary_interpolation():
    frame_t = 0.1234 + np.arange(8) * 0.1051  # off the 5 ms grid
    est = _run_frames(frame_t)
    for k in range(2, 8):
        gap = frame_t[k] - frame_t[k - 1]
        assert abs(float(est.pres[k]["dt_sum"]) - gap) < 1e-6, (k, float(est.pres[k]["dt_sum"]))


def test_td_shifts_pairing():
    frame_t = 0.1234 + np.arange(8) * 0.1051
    est0 = _run_frames(frame_t, td=0.0)
    est1 = _run_frames(frame_t, td=0.0123)
    for k in range(2, 8):
        gap = frame_t[k] - frame_t[k - 1]
        assert abs(float(est1.pres[k]["dt_sum"]) - gap) < 1e-6
        assert not np.allclose(est0.pres[k]["alpha"].numpy(), est1.pres[k]["alpha"].numpy())


def test_ongrid_frames_consume_boundary_sample_once():
    frame_t = np.arange(1, 9) * 0.1  # every 20th IMU sample
    est = _run_frames(frame_t)
    for k in range(2, 8):
        assert abs(float(est.pres[k]["dt_sum"]) - 0.1) < 1e-9
    buf_dts = est.imu_bufs[-2].dt
    assert all(abs(d - 1.0 / IMU_HZ) < 1e-9 for d in buf_dts)


def _td_window():
    """`tests/test_td.py`'s window: observations sampled 12 ms after their
    stamps, with their normalized velocities (JAX package, numpy out)."""
    td_true = 0.012
    seq = synthetic.make_sequence(duration=6.0, n_points=120, n_lines=8, seed=3)
    frames = list(range(0, 55, 5))
    state, f = packing.factors_from_synthetic(seq, frames, TD_CFG, jlayout(TD_CFG),
                                              with_lines=False)
    params = synthetic.TrajectoryParams()
    obs = np.asarray(f.pt_obs).copy()
    vel = np.zeros_like(obs)
    mask = np.asarray(f.pt_mask)
    lm = np.asarray(seq.landmarks)
    for j, fr in enumerate(frames):
        t = float(seq.frame_t[fr])
        proj = {}
        for dt_i in (td_true, 1e-3, -1e-3):
            p_b, q_b = gt_pose(params, jnp.asarray(t + dt_i))
            q_wc = quat_mul(q_b, seq.q_bc)
            p_wc = p_b + quat_rotate(q_b, seq.p_bc)
            pc = (lm - np.asarray(p_wc)) @ np.asarray(quat_to_rot(q_wc))
            proj[dt_i] = (pc[:, 0:2] / pc[:, 2:3], pc)
        (shifted, _), (vp, _), (vm, pc) = proj[td_true], proj[1e-3], proj[-1e-3]
        dmn = (vp - vm) / 2e-3
        for s in range(obs.shape[0]):
            if mask[s, j] > 0:  # the slot's landmark: the nearest (t − 1 ms) projection
                li = int(np.argmin(np.sum((vm - obs[s, j]) ** 2, axis=1)
                                   + 1e9 * (pc[:, 2] < 0.1)))
                obs[s, j] = shifted[li]
                vel[s, j] = dmn[li]
    return td_true, state, f._replace(pt_obs=jnp.asarray(obs), pt_vel=jnp.asarray(vel))


def _np(tree):
    return type(tree)(*[np.asarray(x) for x in tree])


def test_solver_recovers_time_offset():
    td_true, state, f = _td_window()
    j_st, _ = jsolver.optimize_window(state, f, jlayout(TD_CFG), TD_CFG, estimate_td=True,
                                      num_iters=10)
    t_st, _ = tsolver.optimize_window(window_state_from_numpy(_np(state)),
                                      factors_from_numpy(_np(f)), tlayout(TD_CFG), TD_CFG,
                                      estimate_td=True, num_iters=10)
    td_port, td_jax = float(t_st.td), float(j_st.td)
    assert abs(td_port - td_true) < 2e-3, f"td {td_port:.4f} vs {td_true}"
    assert abs(td_port - td_jax) < 1e-8, (td_port, td_jax)


def test_rolling_shutter_correction_wiring():
    seq = synthetic.make_sequence(duration=6.0, n_points=120, n_lines=8, seed=3)
    state, f = packing.factors_from_synthetic(seq, list(range(0, 55, 5)), TD_CFG,
                                              jlayout(TD_CFG), with_lines=False)
    st, f = window_state_from_numpy(_np(state)), factors_from_numpy(_np(f))
    rng = np.random.default_rng(1)
    vel = torch.as_tensor(rng.standard_normal(tuple(f.pt_obs.shape)) * 0.3)
    rowf = torch.as_tensor(rng.uniform(0, 1, tuple(f.pt_mask.shape)))
    tr = 0.02
    f_rs = f._replace(pt_obs=f.pt_obs + tr * rowf[..., None] * vel, pt_vel=vel, pt_rowf=rowf,
                      rs_tr=torch.tensor(tr, dtype=torch.float64))
    assert float(tres.point_residuals(st, f_rs, TD_CFG.focal_length).abs().max()) < 1e-9
    f_off = f_rs._replace(rs_tr=torch.zeros((), dtype=torch.float64))
    assert float(tres.point_residuals(st, f_off, TD_CFG.focal_length).abs().max()) > 0.1
