"""Estimator checkpoints across the two packages (`plslam_torch/io/checkpoint.py`
against `plslam/io/checkpoint.py`): the port writes and reads the JAX
package's npz format, in float64 on the CPU, with the JAX checkpoint tests'
small configuration (64 features, 16 lines) over at most 24 published
frames of a synthetic sequence fed with oracle initialization.

Tolerances: a save → load → save round trip is exact in every array; the
port's resumed run equals its uninterrupted one within 1e-9 (the port's
`test_checkpoint_exact_resume`); a checkpoint of one package continued by
the other equals the first package's uninterrupted run within 1e-6 m (the
backend ticks of the two agree to 1e-8 a frame); saves of both packages at
the same point, a pending solve included, hold the same keys and equal
arrays within 1e-9, or 1e-8 of the array's largest magnitude where that is
larger (the prior's square-root information comes out of an
eigendecomposition: 2.6e-8 apart at a scale of 26).
"""

import numpy as np
import pytest
import torch

from plslam.config import PLSlamConfig as JConfig
from plslam.config import SolverConfig as JSolver
from plslam.io import checkpoint as jck
from plslam.io import synthetic
from plslam.models.estimator import Estimator as JEstimator
from plslam_torch.convert import config_from_jax
from plslam_torch.io import checkpoint as tck
from plslam_torch.models.estimator import Estimator as TEstimator

N_FRAMES, SAVE_AT = 20, 14  # published frames; the window (10) solves from frame 10


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _drive(est, seq, k0, k1, defer_last=False, stride=2):
    """`test_io._run_frames`: published frames [k0, k1) with index-determined
    IMU dts, oracle state for initialization; the last frame's solve left
    pending with `defer_last`."""
    imu_t = np.asarray(seq.imu_t)
    frame_t = np.asarray(seq.frame_t)[::stride]
    obs = np.asarray(seq.obs)[::stride]
    valid = np.asarray(seq.obs_valid)[::stride]
    gt_p, gt_q, gt_v = (np.asarray(a)[::stride] for a in (seq.gt_p, seq.gt_q, seq.gt_v))
    for k in range(k0, k1):
        t = frame_t[k]
        lo = frame_t[k - 1] if k > 0 else -np.inf
        for i in np.nonzero((imu_t > lo + 1e-9) & (imu_t <= t + 1e-9))[0]:
            dt = imu_t[i] - imu_t[i - 1] if i > 0 else 0.005
            est.process_imu(dt, np.asarray(seq.imu_acc[i]), np.asarray(seq.imu_gyr[i]))
        vis = np.nonzero(valid[k])[0]
        est.process_frame(float(t), vis, obs[k, vis], None, None, None,
                          oracle_state={"p": gt_p[k], "q": gt_q[k], "v": gt_v[k]},
                          defer_solve=defer_last and k == k1 - 1)
    return est


def _saves(est, seq, d, name):
    """Drive published frames [0, SAVE_AT) leaving the last solve pending,
    save (`<name>_pending.npz`), finalize, save again (`<name>.npz`), then
    run on uninterrupted to N_FRAMES. Returns the estimator."""
    ck = {"jax": jck, "port": tck}[name]
    _drive(est, seq, 0, SAVE_AT, defer_last=True)
    assert est._pending is not None
    ck.save_estimator(est, str(d / f"{name}_pending.npz"))
    assert est._pending is not None, "a save leaves the pending solve in place"
    est.finalize()
    assert est.initialized and est.prior is not None
    ck.save_estimator(est, str(d / f"{name}.npz"))
    return _drive(est, seq, SAVE_AT, N_FRAMES)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    torch.set_num_threads(1)  # module fixtures run before the autouse one
    d = tmp_path_factory.mktemp("ckpt")
    jcfg = JConfig(solver=JSolver(max_features=64, max_line_feats=16, dtype="float64"))
    cfg = config_from_jax(jcfg)
    seq = synthetic.make_sequence(duration=6.0, n_points=100, n_lines=8, seed=5)
    w = dict(d=d, seq=seq, port=lambda: TEstimator(cfg, device="cpu"),
             jax=lambda: JEstimator(jcfg))
    w["port_full"] = _saves(w["port"](), seq, d, "port")
    w["jax_full"] = _saves(w["jax"](), seq, d, "jax")
    w["port_ckpt"], w["jax_ckpt"] = str(d / "port.npz"), str(d / "jax.npz")
    return w


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_arrays(a, b, atol):
    assert sorted(a) == sorted(b), set(a) ^ set(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        if atol == 0:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            x, y = a[k].astype(np.float64), b[k].astype(np.float64)
            scale = float(np.abs(y).max()) if y.size else 0.0
            np.testing.assert_allclose(x, y, rtol=0, atol=max(atol, 1e-8 * scale), err_msg=k)


def _assert_same_poses(a, b, atol):
    for name in ("p", "q", "v", "ba", "bg"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name), rtol=0, atol=atol,
                                   err_msg=name)


def test_round_trip_exact(world):
    """save → load → save keeps every array bit for bit, and the loaded
    estimator's device tensors sit on its device in its dtype."""
    est = tck.load_estimator(world["port"](), world["port_ckpt"])
    z = _arrays(world["port_ckpt"])
    for name in ("p", "q", "v", "ba", "bg", "p_bc", "q_bc", "timestamps", "td_pair", "line_w"):
        np.testing.assert_array_equal(getattr(est, name), z[name], err_msg=name)
    np.testing.assert_array_equal(est.pt_table.ids, z["pt_ids"])
    for name, t in zip(est.prior._fields, est.prior):
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), z[f"prior_{name}"], err_msg=name)
    assert len(est.pres) == len(est.imu_bufs) == int(z["n_bufs"])
    for k, pre in enumerate(est.pres):
        assert (pre is not None) == bool(z[f"pre{k}_has"])
        for name, t in (pre or {}).items():
            np.testing.assert_array_equal(t.numpy(), z[f"pre{k}_{name}"], err_msg=f"pre{k} {name}")
    again = str(world["d"] / "again.npz")
    tck.save_estimator(est, again)
    _assert_same_arrays(_arrays(again), z, atol=0)


def test_exact_resume(world):
    """The port's `test_checkpoint_exact_resume`: load, continue, and equal
    the uninterrupted run."""
    est = tck.load_estimator(world["port"](), world["port_ckpt"])
    assert est.last_acc is not None, "the boundary sample survives the checkpoint"
    _drive(est, world["seq"], SAVE_AT, N_FRAMES)
    _assert_same_poses(est, world["port_full"], atol=1e-9)


def test_jax_checkpoint_continues_in_the_port(world):
    """A checkpoint written by the JAX package, loaded by the port; both
    packages continue over the same frames."""
    est = tck.load_estimator(world["port"](), world["jax_ckpt"])
    _drive(est, world["seq"], SAVE_AT, N_FRAMES)
    _assert_same_poses(est, world["jax_full"], atol=1e-6)
    np.testing.assert_array_equal(est.pt_table.ids, world["jax_full"].pt_table.ids)


def test_port_checkpoint_loads_into_jax(world):
    """The port's file has the JAX file's key set and arrays at the same
    point, and the JAX package resumes from it like the port does."""
    _assert_same_arrays(_arrays(world["port_ckpt"]), _arrays(world["jax_ckpt"]), atol=1e-9)
    jest = jck.load_estimator(world["jax"](), world["port_ckpt"])
    _drive(jest, world["seq"], SAVE_AT, N_FRAMES)
    _assert_same_poses(jest, world["port_full"], atol=1e-6)


def test_pending_solve(world):
    """A save while `process_frame(defer_solve=True)`'s solve is pending: the
    port writes what JAX writes at that point (the window before that solve,
    with the next interval's buffer already open), and the save leaves the
    pending solve in place (the fixture's runs continue from it)."""
    d = world["d"]
    pend, done = _arrays(str(d / "port_pending.npz")), _arrays(world["port_ckpt"])
    _assert_same_arrays(pend, _arrays(str(d / "jax_pending.npz")), atol=1e-9)
    assert int(pend["n_bufs"]) == int(done["n_bufs"]) + 1  # the open buffer of the next interval
    assert not np.array_equal(pend["p"], done["p"])  # the window before the pending solve
    # loaded, it holds the pre-solve window and no solve to run
    est = tck.load_estimator(world["port"](), str(d / "port_pending.npz"))
    assert est._pending is None and est.frame_count == int(pend["frame_count"])
