"""Port parity of the relocalization round trip on the CPU: the solver's
relo factors on `tests/test_relocalization.py`'s three cases, and the
estimator's `set_relo_frame` → solve → `relo_result` against the JAX
estimator on a recorded rendered run, in both pipeline modes.

Tolerances (float64 in both packages): relo residuals and the refined
state 1e-6; `relo_result` 1e-6, as the JAX run's and the two port replays'
trajectories.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.config import SolverConfig
from plslam.io import synthetic as jsyn
from plslam.models import estimator as jestimator
from plslam.models import packing
from plslam.models import residuals as jres
from plslam.models import solver as jsolver
from plslam.models.state import layout
from plslam.runner import run_euroc as j_run_euroc
from plslam.utils import quat_np as qnp
from plslam.utils.geometry import quat_box_plus, quat_conj, quat_mul, quat_rotate
from plslam_torch import convert
from plslam_torch.models import residuals as tres
from plslam_torch.models import solver as tsolver
from plslam_torch.models.estimator import Estimator as TEstimator
from test_torch_slice import small_config, small_dataset

CFG = SolverConfig(max_features=48, max_line_feats=12, dtype="float64")
LAY = layout(CFG)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def npy(nt):
    return type(nt)(*[np.asarray(x) for x in nt])


@pytest.fixture(scope="module")
def window_with_relo():
    """`test_relocalization.py`'s window (float64): the camera at t = 0 is
    the old keyframe, observing the window's points."""
    seq = jsyn.make_sequence(duration=8.0, n_points=120, n_lines=24, seed=3)
    state, f = packing.factors_from_synthetic(seq, list(range(20, 75, 5)), CFG, LAY)
    p_old, q_old = seq.gt_p[0], seq.gt_q[0]
    q_wc = quat_mul(q_old, seq.q_bc)
    p_wc = p_old + quat_rotate(q_old, seq.p_bc)
    p_w = jres._world_points(state, f)
    x_c = quat_rotate(jnp.broadcast_to(quat_conj(q_wc), (p_w.shape[0], 4)), p_w - p_wc)
    obs = x_c[:, 0:2] / x_c[:, 2:3]
    vis = (x_c[:, 2] > 0.3) & (jnp.abs(obs[:, 0]) < 0.8) & (jnp.abs(obs[:, 1]) < 0.6)
    relo_mask = (vis & (f.pt_valid > 0)).astype(f.pt_valid.dtype)
    assert float(relo_mask.sum()) >= 10
    f = f._replace(relo_obs=obs, relo_mask=relo_mask, relo_valid=jnp.ones((), f.pt_valid.dtype))
    state = state._replace(relo_p=jnp.asarray(p_old), relo_q=jnp.asarray(q_old))
    rng = np.random.default_rng(2)
    state_pert = state._replace(
        relo_p=state.relo_p + jnp.asarray(rng.standard_normal(3) * 0.1),
        relo_q=quat_box_plus(state.relo_q, jnp.asarray(rng.standard_normal(3) * 0.03)))
    return state, state_pert, f, np.asarray(p_old), np.asarray(q_old)


def _port(state, f):
    return convert.window_state_from_numpy(npy(state)), convert.factors_from_numpy(npy(f))


def test_relo_residual_zero_at_truth_matches_jax(window_with_relo):
    state, _, f, _, _ = window_with_relo
    want = np.asarray(jres.relo_residuals(state, f, CFG.focal_length))
    got = tres.relo_residuals(*_port(state, f), CFG.focal_length).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() < 1e-6


def test_solve_refines_relo_pose_matches_jax(window_with_relo):
    state, state_pert, f, p_old, q_old = window_with_relo
    js, jst = jsolver.optimize_window(state_pert, f, LAY, CFG, num_iters=10)
    ts, tst = tsolver.optimize_window(*_port(state_pert, f), LAY, CFG, num_iters=10)
    for name in ts._fields:
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert int(tst.accepted) == int(jst.accepted)
    # the JAX test's own assertions, on the port's result
    assert np.linalg.norm(ts.relo_p.numpy() - p_old) < 5e-3
    dq = qnp.quat_mul(qnp.quat_conj(q_old), ts.relo_q.numpy())
    assert 2 * np.linalg.norm(dq[1:]) < 5e-3
    assert np.linalg.norm(ts.p.numpy() - np.asarray(state.p), axis=-1).max() < 5e-3


def test_relo_inactive_is_noop(window_with_relo):
    state, _, f, _, _ = window_with_relo
    ts, tf = _port(state, f)
    r = tres.relo_residuals(ts._replace(relo_p=ts.relo_p + 5.0),
                            tf._replace(relo_valid=torch.zeros_like(tf.relo_valid)),
                            CFG.focal_length)
    assert float(r.abs().max()) == 0.0


# --------------------------------------------------------- estimator round trip
RELO_AFTER_SOLVES = 4  # the relo frame follows the 4th solve after initialization
RUN_FRAMES = 20  # published frames of the recorded run (it initializes at the 11th)


def _relo_request(est):
    """A relo request built from the JAX estimator's newest solved frame:
    its window points seen from the window's oldest body pose (the "old
    keyframe"), with a perturbed guess of that pose."""
    ids, _, p_w = est.window_points()
    p_old, q_old = np.array(est.p[0]), np.array(est.q[0])
    q_wc = qnp.quat_mul(q_old, est.q_bc)
    p_wc = p_old + qnp.quat_rotate(q_old, est.p_bc)
    x_c = qnp.quat_rotate(np.broadcast_to(qnp.quat_conj(q_wc), (len(p_w), 4)), p_w - p_wc)
    obs = x_c[:, :2] / x_c[:, 2:3]
    q_guess = qnp.quat_normalize(qnp.quat_mul(q_old, np.array([1.0, 0.004, -0.006, 0.01])))
    return ids.copy(), obs, p_old + np.array([0.05, -0.03, 0.02]), q_guess


@pytest.fixture(scope="module")
def relo_run(tmp_path_factory):
    """The 5-s 320×240 render, the JAX `run_euroc` (points only, pipelined)
    over it with a relo request set before the frame after the 4th solve,
    and every call that run made into its estimator, the request included."""
    path = tmp_path_factory.mktemp("render")
    seq = small_dataset(path, 5.0)
    cfg = small_config(seq)
    calls = []
    process_imu, process_frame = jestimator.Estimator.process_imu, jestimator.Estimator.process_frame

    def imu(self, dt, acc, gyr):
        calls.append(("imu", dt, np.array(acc), np.array(gyr)))
        return process_imu(self, dt, acc, gyr)

    def frame(self, t, *obs, **kw):
        if (self.initialized and self.solves_since_init == RELO_AFTER_SOLVES
                and not any(c[0] == "relo" for c in calls)):
            req = _relo_request(self)
            assert self.set_relo_frame(*req)
            calls.append(("relo", *req))
        calls.append(("frame", t, *(None if a is None else np.array(a) for a in obs)))
        return process_frame(self, t, *obs, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jestimator.Estimator, "process_imu", imu)
        mp.setattr(jestimator.Estimator, "process_frame", frame)
        out = j_run_euroc(str(path), cfg, use_lines=False, loop_closure=False, pipeline=True,
                          max_frames=RUN_FRAMES)
    return cfg, out, calls


@pytest.mark.parametrize("pipeline", [False, True])
def test_estimator_relo_round_trip_matches_jax(relo_run, pipeline):
    """The port's estimator replays the JAX run's inputs with the same relo
    request: the refined old-keyframe pose (`relo_result`) within 1e-6. In
    pipeline mode the request arrives between a solve's dispatch and its
    finalize: it must stay pending for the next solve, not be consumed
    against the one in flight."""
    cfg, (jts, jps, _, jest, _), calls = relo_run
    assert jest.relo_result is not None and jest.relo is None
    est = TEstimator(convert.config_from_jax(cfg), device="cpu")
    ts, ps = [], []
    after = None  # frames replayed since the relo request
    for kind, *args in calls:
        if after == 2:
            break  # the relo frame and the next one: the round trip is closed
        if kind == "imu":
            est.process_imu(*args)
        elif kind == "relo":
            ids, obs, p, q = args
            assert not est.set_relo_frame(ids[:7], obs[:7], p, q)  # < 8 matches: refused
            assert est.relo is None
            assert est.set_relo_frame(ids, obs, p, q)
            request = est.relo
            after = 0
            if pipeline:
                assert est._pending is not None and est._pending["relo"] is None
                est.finalize()  # the solve in flight did not carry the request
                assert est.relo is request and est.relo_result is None
        else:
            m = est.process_frame(*args, defer_solve=pipeline)
            after = None if after is None else after + 1
            if not pipeline and "cost" in m and not m.get("failure") and est.initialized:
                t, p, _ = est.latest_pose()
                ts.append(t)
                ps.append(p)
    est.finalize()
    assert est.relo is None
    for key in ("t", "q", "p_old", "q_old"):
        np.testing.assert_allclose(est.relo_result[key], jest.relo_result[key], rtol=0,
                                   atol=1e-6, err_msg=key)
    if not pipeline:
        assert len(ts) >= RELO_AFTER_SOLVES + 1
        np.testing.assert_allclose(ts, jts[: len(ts)], rtol=0, atol=1e-9)
        np.testing.assert_allclose(ps, jps[: len(ps)], rtol=0, atol=1e-6)
    # the refined old pose lies nearer the truth (the window's oldest pose) than the guess
    relo = next(c for c in calls if c[0] == "relo")
    assert np.linalg.norm(est.relo_result["p_old"] - (relo[3] - [0.05, -0.03, 0.02])) < \
        np.linalg.norm([0.05, -0.03, 0.02])
