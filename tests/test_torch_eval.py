"""The port's evaluation tools against the JAX package's: ATE / RPE /
association (`eval/metrics.py`), TUM files, the JSONL metrics log and the
timers. The same seeded numpy trajectories go through both packages.

Tolerances: metrics 1e-12 (both are float64 numpy with the same operations);
TUM files byte for byte; a TUM file read back within its 6-decimal text
precision (5e-7 m, 5e-8 in q). `test_eval.py`'s three cases and
`test_io.py`'s TUM / ATE / logger cases run on both packages as
parametrised cases.
"""
import json
import time

import numpy as np
import pytest
import torch

from plslam.eval import metrics as jm
from plslam.utils import metrics_log as jlog
from plslam_torch.eval import metrics as tm
from plslam_torch.utils import metrics_log as tlog
from plslam_torch.utils import quat_np as qnp
from plslam_torch.utils.timers import Timers, profiler_trace

PACKAGES = {"jax": jm, "port": tm}
LOGGERS = {"jax": jlog, "port": tlog}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _traj(n=80, dt=0.1, seed=0):
    rng = np.random.default_rng(seed)
    ts = np.arange(n) * dt
    ps = np.cumsum(rng.standard_normal((n, 3)) * 0.1, axis=0)
    qs = np.zeros((n, 4))
    qs[:, 0] = 1.0
    for k in range(1, n):
        qs[k] = qnp.quat_normalize(qnp.quat_mul(qs[k - 1], qnp.quat_exp(rng.standard_normal(3) * 0.05)))
    return ts, ps, qs


def _yaw(th):
    return np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])


def _apply_rigid(ps, qs, R, t):
    return ps @ R.T + t, np.stack([qnp.quat_mul(qnp.rot_to_quat(R), q) for q in qs])


def _noisy_pair(seed=3):
    """An estimate and a ground truth on jittered, partly unmatched clocks."""
    rng = np.random.default_rng(seed)
    ts, ps, qs = _traj(n=120, seed=seed)
    est_t = ts + rng.uniform(-0.015, 0.015, len(ts))
    est_p = ps @ _yaw(0.3).T + rng.standard_normal(ps.shape) * 0.02 + np.array([1.0, 2.0, 0.5])
    est_q = np.stack([qnp.quat_normalize(qnp.quat_mul(q, qnp.quat_exp(rng.standard_normal(3) * 0.01)))
                      for q in qs])
    return (est_t[5:], est_p[5:], est_q[5:]), (ts[::1], ps, qs)


@pytest.mark.parametrize("align", ["yaw", "se3", "sim3"])
def test_ate_matches_jax(align):
    (et, ep, _), (gt, gp, _) = _noisy_pair()
    a = tm.ate_rmse(et, ep, gt, gp, align=align)
    b = jm.ate_rmse(et, ep, gt, gp, align=align)
    assert np.isfinite(a) and abs(a - b) <= 1e-12


@pytest.mark.parametrize("with_q", [True, False])
@pytest.mark.parametrize("delta", [0.5, 1.0])
def test_rpe_matches_jax(with_q, delta):
    (et, ep, eq), (gt, gp, gq) = _noisy_pair(seed=4)
    kw = dict(est_q=eq, gt_q=gq) if with_q else {}
    a = tm.rpe(et, ep, gt, gp, delta=delta, **kw)
    b = jm.rpe(et, ep, gt, gp, delta=delta, **kw)
    assert np.isfinite(a[0])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("max_dt", [0.005, 0.02])
def test_associate_return_t_matches_jax(max_dt):
    (et, ep, _), (gt, gp, _) = _noisy_pair(seed=5)
    a = tm.associate(et, ep, gt, gp, max_dt=max_dt, return_t=True)
    b = jm.associate(et, ep, gt, gp, max_dt=max_dt, return_t=True)
    assert len(a) == 3
    # the clocks jitter by up to 15 ms: the tight window drops some pairs
    assert (0 < len(a[2]) < len(et)) if max_dt < 0.015 else len(a[2]) == len(et)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
    two = tm.associate(et, ep, gt, gp, max_dt=max_dt)
    assert len(two) == 2
    np.testing.assert_array_equal(two[0], a[0])


def test_write_tum_byte_identical(tmp_path):
    ts, ps, qs = _traj(n=40, seed=7)
    ps = ps * 37.0  # wide values: signs, several integer digits
    jm.write_tum(tmp_path / "j.tum", ts + 1403636579.763555, ps, qs)
    tm.write_tum(tmp_path / "t.tum", ts + 1403636579.763555, ps, qs)
    assert (tmp_path / "j.tum").read_bytes() == (tmp_path / "t.tum").read_bytes()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_read_tum_reads_the_other_package(tmp_path, writer, reader):
    ts, ps, qs = _traj(n=30, seed=8)
    path = tmp_path / "traj.tum"
    PACKAGES[writer].write_tum(path, ts, ps, qs)
    t2, p2, q2 = PACKAGES[reader].read_tum(path)
    t3, p3, q3 = PACKAGES[writer].read_tum(path)
    np.testing.assert_array_equal(t2, t3)
    np.testing.assert_array_equal(p2, p3)
    np.testing.assert_array_equal(q2, q3)
    np.testing.assert_allclose(p2, ps, rtol=0, atol=5e-7)
    np.testing.assert_allclose(q2, qs, rtol=0, atol=5e-8)


# ---- test_eval.py's cases, on both packages ----
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rpe_invariant_to_global_rigid_transform(pkg):
    m = PACKAGES[pkg]
    ts, ps, qs = _traj()
    ps2, qs2 = _apply_rigid(ps, qs, _yaw(0.7), np.array([5.0, -2.0, 1.0]))
    t_rmse, r_rmse = m.rpe(ts, ps2, ts, ps, est_q=qs2, gt_q=qs, delta=0.5)
    assert t_rmse < 1e-12
    assert r_rmse < 1e-4


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rpe_detects_relative_error(pkg):
    m = PACKAGES[pkg]
    ts, ps, qs = _traj()
    rng = np.random.default_rng(1)
    ps2 = ps + np.cumsum(rng.standard_normal((len(ts), 3)) * 0.01, axis=0)
    t_rmse, r_rmse = m.rpe(ts, ps2, ts, ps, est_q=qs, gt_q=qs, delta=0.5)
    assert 0.005 < t_rmse < 0.5
    assert r_rmse < 1e-4
    qs2 = qs.copy()
    dz = np.array([0.0, 0.0, 0.005])
    for k in range(1, len(ts)):
        qs2[k] = qnp.quat_normalize(qnp.quat_mul(qnp.quat_exp(dz * k), qs[k]))
    _, r_rmse2 = m.rpe(ts, ps, ts, ps, est_q=qs2, gt_q=qs, delta=0.5)
    assert 0.1 < r_rmse2 < 5.0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_ate_zero_on_yaw_rotated_copy(pkg):
    m = PACKAGES[pkg]
    ts, ps, qs = _traj()
    ps2, _ = _apply_rigid(ps, qs, _yaw(-0.4), np.array([1.0, 2.0, 3.0]))
    assert m.ate_rmse(ts, ps2, ts, ps, align="yaw") < 1e-9


# ---- test_io.py's TUM / ATE / logger cases, on both packages ----
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_tum_roundtrip(tmp_path, pkg):
    m = PACKAGES[pkg]
    rng = np.random.default_rng(0)
    ts = np.arange(10) * 0.1
    ps = rng.standard_normal((10, 3))
    qs = rng.standard_normal((10, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    path = str(tmp_path / "traj.tum")
    m.write_tum(path, ts, ps, qs)
    t2, p2, q2 = m.read_tum(path)
    np.testing.assert_allclose(p2, ps, atol=1e-6)
    np.testing.assert_allclose(np.abs(np.sum(q2 * qs, axis=1)), 1.0, atol=1e-6)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_ate_zero_for_identical(pkg):
    m = PACKAGES[pkg]
    ts = np.arange(50) * 0.1
    ps = np.cumsum(np.random.default_rng(1).standard_normal((50, 3)) * 0.1, axis=0)
    assert m.ate_rmse(ts, ps, ts, ps, align="yaw") < 1e-12
    ps2 = ps @ _yaw(0.4).T + np.array([1.0, -2.0, 0.5])
    assert m.ate_rmse(ts, ps2, ts, ps, align="yaw") < 1e-9


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_metrics_logger(tmp_path, pkg):
    lg = LOGGERS[pkg]
    path = str(tmp_path / "m.jsonl")
    log = lg.MetricsLogger(path)
    log.log({"t": 1.0, "cost": np.float64(3.5), "n": 4})
    log.log({"t": 2.0, "keyframe": True})
    log.close()
    rows = lg.read_jsonl(path)
    assert len(rows) == 2 and rows[0]["cost"] == 3.5


def test_metrics_logger_tensors(tmp_path):
    """Tensor values: a 0-d tensor becomes a number, any other a list; the
    port's lines read back with the JAX package's reader and agree with it
    where JAX writes the same value."""
    path = str(tmp_path / "m.jsonl")
    log = tlog.MetricsLogger(path)
    log.log({"cost": torch.tensor(2.25, dtype=torch.float64), "p": torch.arange(3.0),
             "ids": torch.tensor([[1, 2], [3, 4]], dtype=torch.int32), "n": np.int64(7),
             "flag": np.bool_(True), "name": "kf"})
    log.close()
    assert tlog.read_jsonl(path) == jlog.read_jsonl(path)
    row = tlog.read_jsonl(path)[0]
    assert row == {"cost": 2.25, "p": [0.0, 1.0, 2.0], "ids": [[1, 2], [3, 4]], "n": 7,
                   "flag": 1.0, "name": "kf"}
    jpath = str(tmp_path / "j.jsonl")
    jl = jlog.MetricsLogger(jpath)
    jl.log({"n": np.int64(7), "flag": np.bool_(True), "name": "kf"})
    jl.close()
    assert {k: row[k] for k in ("n", "flag", "name")} == jlog.read_jsonl(jpath)[0]
    assert json.loads(open(path).read())["p"] == [0.0, 1.0, 2.0]


def test_timers_on_cpu(tmp_path):
    t = Timers()
    for _ in range(3):
        with t.timed("solve", sync=(torch.ones(3), {"x": torch.zeros(2)})):
            time.sleep(0.002)
    with t.timed("io"):
        pass
    s = t.summary()
    assert s["solve"]["n"] == 3 and s["io"]["n"] == 1
    assert s["solve"]["total_s"] >= 0.006 and s["solve"]["mean_ms"] >= 2.0
    assert list(s) == ["io", "solve"]
    lines = t.report().splitlines()
    assert len(lines) == 2 and lines[1].startswith("solve") and "n=    3" in lines[1]
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
