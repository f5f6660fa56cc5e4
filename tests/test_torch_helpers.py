"""Port parity, the last helpers of the JAX package: `cameras.pixel_to_normalized`
over the four camera models, `lines.trim_line_to_segment`, `geometry.so3_log`,
the sequential IMU recursion (`imu._midpoint_step` / `preintegrate_sequential`)
and `Estimator.imu_rate_pose`, `plslam_torch` against `plslam` in float64.

Tolerances: the closed-form helpers 1e-10 relative (+1e-12 absolute), the
same formulas in both packages; `preintegrate_sequential` against JAX's
1e-10 relative (+1e-12), the same recursion; against the port's associative
`preintegrate` `tests/test_imu.py`'s own bounds (1e-8 relative on α, β, γ, J;
1e-7 on the covariance, +1e-12 absolute), a prefix scan against a recursion.
`imu_rate_pose` holds `tests/test_estimator.py`'s assertions (within 0.2 m
of `latest_pose`, finite velocity) and equals JAX's on the same run within
1e-10 absolute (p, q, v), after the last solve and after 50 ms of
dead-reckoning: the same float64 host arithmetic (the runs' poses agree to
~3e-14 m).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.ops import cameras as jcam
from plslam.ops import imu as jimu
from plslam.ops import lines as jlines
from plslam.utils import geometry as jgeo
from plslam_torch.config import PLSlamConfig, SolverConfig
from plslam_torch.ops import cameras as tcam
from plslam_torch.ops import imu as timu
from plslam_torch.ops import lines as tlines
from plslam_torch.utils import geometry as tgeo

RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def close(t_out, j_out, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), rtol=rtol, atol=atol)


def T(x):
    return torch.as_tensor(np.array(x, np.float64))


def J(x):
    return jnp.asarray(np.asarray(x, np.float64))


CAMERAS = {
    "pinhole": (dict(fx=458.6, fy=457.3, cx=367.2, cy=248.4, k1=-0.283, k2=0.074, p1=1.9e-4,
                     p2=1.8e-5), "PinholeRadTan"),
    "equidistant": (dict(fx=190.0, fy=190.5, cx=254.9, cy=256.9, k2=-0.0057, k3=0.0077,
                         k4=-0.0062, k5=0.0016), "EquidistantCamera"),
    "mei": (dict(xi=1.7, fx=1400.0, fy=1400.5, cx=376.0, cy=240.0, k1=-0.1, k2=0.02, p1=1e-4,
                 p2=-2e-4), "MeiCamera"),
    "scaramuzza": (dict(a0=-180.0, a2=0.0012, a3=-1.5e-6, a4=4e-9, c=1.0, d=0.001, e=-0.002,
                        cx=376.0, cy=240.0), "ScaramuzzaCamera"),
}


@pytest.mark.parametrize("kind", sorted(CAMERAS))
def test_pixel_to_normalized(kind):
    params, cls = CAMERAS[kind]
    jc = getattr(jcam, cls).create(**params, dtype=jnp.float64)
    tc = getattr(tcam, cls).create(**params, dtype=torch.float64)
    rng = np.random.default_rng(1)
    uv = np.stack([rng.uniform(200, 550, 32), rng.uniform(120, 360, 32)], axis=1)
    close(tcam.pixel_to_normalized(tc, T(uv)), jcam.pixel_to_normalized(jc, J(uv)))
    close(tcam.pixel_to_normalized(tc, T(uv), iters=3), jcam.pixel_to_normalized(jc, J(uv), 3))
    # the alias of `lift` with its own default
    close(tcam.pixel_to_normalized(tc, T(uv)), tcam.lift(tc, T(uv), 8).numpy(), rtol=0, atol=0)


def test_trim_line_to_segment():
    rng = np.random.default_rng(2)
    p1, p2 = rng.standard_normal((12, 3)) * 3, rng.standard_normal((12, 3)) * 3
    L = jlines.plucker_from_points(J(p1), J(p2))
    s_dir, e_dir = rng.standard_normal((12, 3)), rng.standard_normal((12, 3))
    ts, te = tlines.trim_line_to_segment(T(np.asarray(L)), T(s_dir), T(e_dir))
    js, je = jlines.trim_line_to_segment(L, J(s_dir), J(e_dir))
    close(ts, js)
    close(te, je)
    # both endpoints lie on the line: (p × v) = n
    n, v = T(np.asarray(L))[:, :3], T(np.asarray(L))[:, 3:]
    for p in (ts, te):
        close(torch.linalg.cross(p, v), n.numpy(), rtol=0, atol=1e-9)


def test_so3_log():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((16, 3))
    v *= rng.uniform(0.0, 3.0, (16, 1)) / np.linalg.norm(v, axis=1, keepdims=True)  # |θ| < π
    v[0] = 0.0  # the identity
    v[1] *= 1e-9  # next to it
    R = np.asarray(jgeo.so3_exp(J(v)))
    close(tgeo.so3_log(T(R)), jgeo.so3_log(J(R)))
    close(tgeo.so3_log(T(R)), v, rtol=1e-9, atol=1e-12)  # log ∘ exp


def _imu_case(rng, n, pad):
    N = n + pad
    acc, gyr, dt = np.zeros((N + 1, 3)), np.zeros((N + 1, 3)), np.zeros(N)
    acc[: n + 1] = rng.normal(0, 2, (n + 1, 3)) + [0, 0, 9.81]
    gyr[: n + 1] = rng.normal(0, 0.5, (n + 1, 3))
    acc[n + 1:] = acc[n]
    gyr[n + 1:] = gyr[n]
    dt[:n] = 0.005
    return acc, gyr, dt, rng.normal(0, 0.05, 3), rng.normal(0, 0.01, 3)


@pytest.mark.parametrize("n,pad", [(20, 0), (20, 492), (200, 0), (1, 0)])
def test_preintegrate_sequential(n, pad):
    """`tests/test_imu.py::test_associative_scan_matches_sequential`'s cases
    on the port, and the port's recursion against JAX's."""
    args = _imu_case(np.random.default_rng(0 + n + pad), n, pad)
    t_seq = timu.preintegrate_sequential(*[T(a) for a in args], timu.ImuNoise.euroc(torch.float64))
    t_par = timu.preintegrate(*[T(a) for a in args], timu.ImuNoise.euroc(torch.float64))
    j_seq = jimu.preintegrate_sequential(*[J(a) for a in args], jimu.ImuNoise.euroc(jnp.float64))
    for name in ("alpha", "beta", "gamma", "jac", "cov", "dt_sum", "ba", "bg"):
        close(getattr(t_seq, name), getattr(j_seq, name))
        tol = 1e-7 if name == "cov" else 1e-8
        close(getattr(t_par, name), getattr(t_seq, name).numpy(), rtol=tol, atol=1e-12)


def test_midpoint_step_matches_jax():
    rng = np.random.default_rng(4)
    acc0, acc1 = rng.normal(0, 2, (2, 3)) + [0, 0, 9.81]
    gyr0, gyr1 = rng.normal(0, 0.5, (2, 3))
    ba, bg = rng.normal(0, 0.05, 3), rng.normal(0, 0.01, 3)
    q = rng.standard_normal(4)
    P = rng.standard_normal((15, 15)) * 1e-3
    carry = (rng.standard_normal(3), rng.standard_normal(3), q / np.linalg.norm(q),
             np.eye(15) + rng.standard_normal((15, 15)) * 0.1, P @ P.T, 0.25)
    inp = (acc0, gyr0, acc1, gyr1, 0.005, ba, bg)
    t_out = timu._midpoint_step(tuple(T(a) for a in carry), tuple(T(a) for a in inp),
                                timu._noise_diag(timu.ImuNoise.euroc(torch.float64),
                                                 torch.float64, None))
    j_out, _ = jimu._midpoint_step(tuple(J(a) for a in carry), tuple(J(a) for a in inp),
                                   jimu._noise_diag(jimu.ImuNoise.euroc(jnp.float64), jnp.float64))
    for a, b in zip(t_out, j_out):
        close(a, b)


def test_imu_rate_pose():
    """`tests/test_estimator.py::test_vio_oracle_init_points_lines`'s
    `imu_rate_pose` assertions on a short oracle-init `run_synthetic`, run
    by both packages on the same sequence; then 50 ms of IMU past the last
    frame dead-reckons the newest slot in both, and the port's (p, q, v)
    must be JAX's (the same float64 host recursion) before and after."""
    from plslam.config import PLSlamConfig as JPLSlamConfig
    from plslam.config import SolverConfig as JSolverConfig
    from plslam.io import synthetic as jsyn
    from plslam.runner import run_synthetic as j_run_synthetic
    from plslam_torch.io import synthetic
    from plslam_torch.runner import run_synthetic

    seq = synthetic.make_sequence(duration=1.5, n_points=140, n_lines=0, seed=11)
    jseq = jsyn.SyntheticSequence(*[jnp.asarray(np.asarray(x)) for x in seq])
    widths = dict(window_size=5, max_features=48, max_line_feats=8, dtype="float64")
    ts, ps, _, est = run_synthetic(seq, PLSlamConfig(solver=SolverConfig(**widths)),
                                   oracle_init=True, use_lines=False, device="cpu")
    jts, jps, _, jest = j_run_synthetic(jseq, JPLSlamConfig(solver=JSolverConfig(**widths)),
                                        oracle_init=True, use_lines=False)
    assert est.initialized and len(ts) > 5
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_allclose(ps, jps, rtol=0, atol=1e-10)

    def rate_poses():
        hi, j_hi = est.imu_rate_pose(), jest.imu_rate_pose()
        for a, b in zip(hi, j_hi):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-10)
        return hi

    p_solved = rate_poses()[0]
    imu_t = np.asarray(seq.imu_t)
    acc, gyr = np.asarray(seq.imu_acc), np.asarray(seq.imu_gyr)
    prev = float(ts[-1])
    for i in np.nonzero((imu_t > prev) & (imu_t <= prev + 0.05))[0]:
        for e in (est, jest):
            e.process_imu(imu_t[i] - prev, acc[i], gyr[i])
        prev = imu_t[i]
    p_hi, _, v_hi = rate_poses()
    _, p_kf, _ = est.latest_pose()
    assert np.linalg.norm(p_hi - p_kf) < 0.2
    assert np.isfinite(v_hi).all()
    assert 0 < np.linalg.norm(p_hi - p_solved) < 0.2  # the slot was dead-reckoned
