"""Fault tolerance and the run-level estimator scenarios on the port
(`tests/test_robustness.py`, `tests/test_estimator.py`), held to the
reference tests' own assertions (`tests/robustness_scenarios.py`).

`test_gapped_track_depth_transfer` runs the port's `PointTable` beside the
JAX package's on the same observations: depths, anchors and masks equal
(the same float64 host arithmetic; depths within 1e-12).

The run-level scenarios run the whole port at the reference's settings (96
features, 24 lines, float64) and take minutes each on a CPU, more than the
Tier-1 budget holds: they are marked `slow` here, and `chip_smoke.py` phase
10(e) runs every one of them on the card with the same assertions. Here
each also runs the JAX package on the same inputs, and the port's published
timestamps must be JAX's and its poses within TRAJ_TOL of JAX's (the
deferred solve: the final window positions; the oracle run: also
`imu_rate_pose`). Both run the same float64 estimator, so they part only
by summation order; 1e-6 m is milestone A's bound
(`tests/test_torch_backend.py`).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustness_scenarios as scen
from plslam.config import PLSlamConfig as JPLSlamConfig
from plslam.config import SolverConfig as JSolverConfig
from plslam.io import synthetic as jsyn
from plslam.models.feature_table import PointTable as JPointTable
from plslam.runner import run_synthetic as j_run_synthetic
from plslam_torch.config import SolverConfig
from plslam_torch.models.feature_table import PointTable


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _gapped_table(cls, cfg):
    tbl = cls(cfg)
    # feature 10: frames 0, 2, 3 (gap at 1); feature 11: frames 0, 1, 2
    tbl.add_frame(0, [10, 11], [[0.1, 0.0], [0.2, 0.1]])
    tbl.add_frame(1, [11], [[0.21, 0.1]])
    tbl.add_frame(2, [10, 11], [[0.12, 0.0], [0.22, 0.1]])
    tbl.add_frame(3, [10], [[0.13, 0.0]])
    return tbl


def test_gapped_track_depth_transfer():
    """Gapped tracks are kept, but `slide_old` never re-anchors a depth on a
    frame the feature was not observed in: a frame-0-anchored depth
    transfers only when frame 1 is observed, resets to -1 otherwise, and
    `start` follows the first observed column."""
    tbl = _gapped_table(PointTable, SolverConfig(max_features=8, max_line_feats=4))
    ref = _gapped_table(JPointTable, JSolverConfig(max_features=8, max_line_feats=4))
    s10 = int(np.nonzero(tbl.ids == 10)[0][0])
    s11 = int(np.nonzero(tbl.ids == 11)[0][0])
    assert tbl.mask[s10, 0] and not tbl.mask[s10, 1] and tbl.mask[s10, 2]
    assert tbl.start[s10] == 0

    p0, q0 = np.zeros(3), np.array([1.0, 0, 0, 0])
    p1, q1 = np.array([0.1, 0.0, 0.0]), np.array([1.0, 0, 0, 0])
    for t in (tbl, ref):
        t.inv_depth[s10] = 0.5
        t.inv_depth[s11] = 0.5
        t.slide_old(p0, q0, p1, q1)
    np.testing.assert_allclose(tbl.inv_depth[s11], 0.5, atol=1e-12)
    assert tbl.start[s11] == 0
    assert tbl.inv_depth[s10] == -1.0
    assert tbl.start[s10] == 1
    # the port's table against the reference's, field by field
    np.testing.assert_array_equal(tbl.ids, ref.ids)
    np.testing.assert_array_equal(tbl.mask, ref.mask)
    np.testing.assert_array_equal(tbl.start, ref.start)
    np.testing.assert_array_equal(tbl.obs, ref.obs)
    np.testing.assert_allclose(tbl.inv_depth, ref.inv_depth, rtol=0, atol=1e-12)


TRAJ_TOL = 1e-6  # m
JCONFIG = JPLSlamConfig(solver=JSolverConfig(**scen.WIDTHS))


def _jax_seq(seq, **fields):
    """The port's simulated sequence as the JAX package's, `fields` (numpy)
    replaced."""
    arrays = {name: np.asarray(x) for name, x in zip(seq._fields, seq)}
    arrays.update(fields)
    return jsyn.SyntheticSequence(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _same_run(out, jax_run):
    jts, jps = jax_run[:2]
    np.testing.assert_array_equal(out["ts"], jts)
    np.testing.assert_allclose(out["ps"], jps, rtol=0, atol=TRAJ_TOL)


@pytest.fixture(scope="module")
def rseq():
    return scen.robustness_sequence()


@pytest.fixture(scope="module")
def eseq():
    return scen.estimator_sequence()


@pytest.mark.slow
def test_survives_frame_drops(rseq):
    out = scen.frame_drops("cpu", rseq)
    _same_run(out, j_run_synthetic(_jax_seq(rseq), JCONFIG, oracle_init=True, use_lines=False,
                                   drop_frames=scen.DROPPED_FRAMES))


@pytest.mark.slow
def test_survives_corrupted_observations(rseq):
    out = scen.corrupted_observations("cpu", rseq)
    jseq = _jax_seq(rseq, obs=scen.corrupt(rseq.obs))
    _same_run(out, j_run_synthetic(jseq, JCONFIG, oracle_init=True, use_lines=False))


@pytest.mark.slow
def test_feature_collapse_triggers_reinit(rseq):
    out = scen.feature_collapse("cpu", rseq)
    valid, lvalid = scen.blank(rseq.obs_valid, rseq.line_obs_valid)
    jseq = _jax_seq(rseq, obs_valid=valid, line_obs_valid=lvalid)
    _same_run(out, j_run_synthetic(jseq, JCONFIG, oracle_init=True, use_lines=False))


@pytest.mark.slow
def test_imu_pad_overflow_forces_keyframe(monkeypatch):
    from plslam.models import estimator as jest_mod

    seq = scen.pad_sequence()
    out = scen.imu_pad_overflow("cpu", seq)
    monkeypatch.setattr(jest_mod, "IMU_PAD", scen.IMU_PAD)
    jcfg = JPLSlamConfig(solver=JSolverConfig(**scen.PAD_WIDTHS))
    _same_run(out, j_run_synthetic(_jax_seq(seq), jcfg, oracle_init=True, use_lines=False))


@pytest.mark.slow
def test_vio_oracle_init_points_lines(eseq):
    out = scen.oracle_points_lines("cpu", eseq)
    jrun = j_run_synthetic(_jax_seq(eseq), JCONFIG, oracle_init=True, use_lines=True)
    _same_run(out, jrun)
    for ours, theirs in zip(out["imu_rate_pose"], jrun[3].imu_rate_pose()):
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=TRAJ_TOL)


@pytest.mark.slow
def test_vio_anchored_line_chart(eseq):
    out = scen.anchored_line_chart("cpu", eseq)
    jcfg = dataclasses.replace(JCONFIG, solver=dataclasses.replace(JCONFIG.solver,
                                                                   line_param="incamera"))
    _same_run(out, j_run_synthetic(_jax_seq(eseq), jcfg, oracle_init=True, use_lines=True))


@pytest.mark.slow
def test_deferred_solve_bit_identical(eseq):
    from plslam.models.estimator import Estimator as JEstimator

    out = scen.deferred_solve("cpu", eseq)
    jest = scen.drive(JEstimator(JCONFIG), _jax_seq(eseq), False)
    np.testing.assert_allclose(out["p"], np.asarray(jest.p), rtol=0, atol=TRAJ_TOL)
