"""Port parity, math layer: geometry, the four camera models, Plücker lines,
IMU preintegration and the ATE metric in `plslam_torch` against `plslam` on
the same numpy inputs, in float64.

Tolerance: 1e-10 relative (+1e-12 absolute for values near zero). Both
packages evaluate the same formulas in float64; the differences are
operation order only (for the associative preintegration, a prefix scan and
tree reduction grouped differently from `jax.lax.associative_scan`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.eval import metrics as jmetrics
from plslam.ops import cameras as jcam
from plslam.ops import imu as jimu
from plslam.ops import lines as jlines
from plslam.utils import geometry as jgeo
from plslam_torch import convert
from plslam_torch.eval import metrics as tmetrics
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


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("name", [
    "skew", "quat_mul", "quat_rotate", "quat_to_rot", "rot_to_quat", "quat_exp", "quat_log",
    "quat_box_plus", "quat_box_minus", "so3_exp", "ypr_to_rot", "rot_to_ypr",
    "rot_from_two_vectors", "gravity_to_rot", "pose_inverse",
])
def test_geometry(name):
    rng = np.random.default_rng(0)
    n = 16
    v = rng.standard_normal((n, 3))
    v[0] = 0.0  # exp/log at the identity
    q1, q2 = _quats(rng, n), _quats(rng, n)
    R = np.asarray(jgeo.quat_to_rot(J(q1)))
    args = {
        "skew": (v,), "quat_mul": (q1, q2), "quat_rotate": (q1, v), "quat_to_rot": (q1,),
        "rot_to_quat": (R,), "quat_exp": (v,), "quat_log": (q1,), "quat_box_plus": (q1, v),
        "quat_box_minus": (q2, q1), "so3_exp": (v,), "ypr_to_rot": (v,), "rot_to_ypr": (R,),
        "rot_from_two_vectors": (v[1:], rng.standard_normal((n - 1, 3))),
        "gravity_to_rot": (v[1:] + [0, 0, 9.8],), "pose_inverse": (v, q1),
    }[name]
    t_out = getattr(tgeo, name)(*[T(a) for a in args])
    j_out = getattr(jgeo, name)(*[J(a) for a in args])
    if isinstance(t_out, tuple):
        for a, b in zip(t_out, j_out):
            close(a, b)
    else:
        close(t_out, j_out)


def _camera_pairs():
    return [
        ("pinhole", dict(fx=458.6, fy=457.3, cx=367.2, cy=248.4, k1=-0.283, k2=0.074,
                         p1=1.9e-4, p2=1.8e-5), jcam.PinholeRadTan, tcam.PinholeRadTan),
        ("equidistant", dict(fx=190.0, fy=190.5, cx=254.9, cy=256.9, k2=-0.0057, k3=0.0077,
                             k4=-0.0062, k5=0.0016), jcam.EquidistantCamera, tcam.EquidistantCamera),
        ("mei", dict(xi=1.7, fx=1400.0, fy=1400.5, cx=376.0, cy=240.0, k1=-0.1, k2=0.02,
                     p1=1e-4, p2=-2e-4), jcam.MeiCamera, tcam.MeiCamera),
        ("scaramuzza", dict(a0=-180.0, a2=0.0012, a3=-1.5e-6, a4=4e-9, c=1.0, d=0.001, e=-0.002,
                            cx=376.0, cy=240.0), jcam.ScaramuzzaCamera, tcam.ScaramuzzaCamera),
    ]


@pytest.mark.parametrize("kind", [c[0] for c in _camera_pairs()])
def test_cameras(kind):
    _, params, jcls, tcls = next(c for c in _camera_pairs() if c[0] == kind)
    jc = jcls.create(**params, dtype=jnp.float64)
    tc = tcls.create(**params, dtype=torch.float64)
    rng = np.random.default_rng(1)
    p_c = rng.uniform(-1.0, 1.0, (32, 3)) * [0.6, 0.4, 0.0] + [0.0, 0.0, 2.0]
    uv = np.stack([rng.uniform(200, 550, 32), rng.uniform(120, 360, 32)], axis=1)
    mn = p_c[:, :2] / p_c[:, 2:]
    close(tcam.project(tc, T(p_c)), jcam.project(jc, J(p_c)))
    close(tcam.lift(tc, T(uv)), jcam.lift(jc, J(uv)))
    close(tcam.normalized_to_pixel(tc, T(mn)), jcam.normalized_to_pixel(jc, J(mn)))
    # fixed-width serialization round-trips through the other package
    kind_i, vals = jcam.cam_to_params(jc)
    assert tcam.cam_to_params(tc)[0] == kind_i
    back = convert.camera_from_params(kind_i, vals, dtype=torch.float64)
    close(tcam.project(back, T(p_c)), jcam.project(jc, J(p_c)))


def test_make_camera_factory():
    from plslam.config import CameraConfig

    for mt in ("PINHOLE", "KANNALA_BRANDT", "MEI", "SCARAMUZZA"):
        cc = CameraConfig(model_type=mt, xi=1.2, a0=-180.0, a2=0.001)
        tc = tcam.make_camera(cc, dtype=torch.float64)
        jc = jcam.make_camera(cc, dtype=jnp.float64)
        assert type(tc).__name__ == type(jc).__name__
        np.testing.assert_allclose([float(v) for v in tc], [float(v) for v in jc], rtol=0, atol=0)


@pytest.mark.parametrize("name", [
    "plucker_from_points", "orth_retract", "plucker_transform", "plane_from_cam_segment",
    "plucker_from_planes", "line_projection_residual", "closest_point_on_line",
])
def test_lines(name):
    rng = np.random.default_rng(2)
    n = 12
    p1, p2 = rng.standard_normal((n, 3)) * 3, rng.standard_normal((n, 3)) * 3
    L = np.asarray(jlines.plucker_from_points(J(p1), J(p2)))
    R = np.asarray(jgeo.so3_exp(J(rng.standard_normal((n, 3)))))
    t = rng.standard_normal((n, 3))
    s2 = rng.standard_normal((n, 2)) * 0.3
    args = {
        "plucker_from_points": (p1, p2), "orth_retract": (L, rng.standard_normal((n, 4)) * 0.1),
        "plucker_transform": (L, R, t), "plane_from_cam_segment": (R, t, s2, s2[::-1]),
        "plucker_from_planes": (rng.standard_normal((n, 4)), rng.standard_normal((n, 4))),
        "line_projection_residual": (L, s2, s2[::-1]), "closest_point_on_line": (L, p2),
    }[name]
    close(getattr(tlines, name)(*[T(a) for a in args]), getattr(jlines, name)(*[J(a) for a in args]))


def _imu_stream(rng, n):
    acc = rng.standard_normal((n + 1, 3)) * 0.5 + [0.0, 0.0, 9.81]
    gyr = rng.standard_normal((n + 1, 3)) * 0.3
    dt = np.full(n, 0.005)
    return acc, gyr, dt


@pytest.mark.parametrize("n,pad", [(0, 0), (1, 0), (37, 0), (40, 24)])
def test_preintegrate(n, pad):
    """Against the JAX associative form, including n=0 (identity) and
    zero-dt padding (exact identity steps)."""
    rng = np.random.default_rng(3 + n)
    acc, gyr, dt = _imu_stream(rng, n)
    if pad:
        acc = np.concatenate([acc, np.repeat(acc[-1:], pad, 0)])
        gyr = np.concatenate([gyr, np.repeat(gyr[-1:], pad, 0)])
        dt = np.concatenate([dt, np.zeros(pad)])
    ba, bg = rng.standard_normal(3) * 0.05, rng.standard_normal(3) * 0.01
    jn = jimu.ImuNoise.euroc(jnp.float64)
    tn = timu.ImuNoise.euroc(torch.float64)
    jp = jimu.preintegrate(J(acc), J(gyr), J(dt), J(ba), J(bg), jn)
    tp = timu.preintegrate(T(acc), T(gyr), T(dt), T(ba), T(bg), tn)
    for a, b in zip(tp, jp):
        close(a, b, atol=1e-14)
    if n:
        # the whitening and the factor residual on top of it. A one-step
        # covariance is near-singular (its whitening is conditioning-limited,
        # ~1e6 entries), so the whitening is compared on real intervals only
        if n > 1:
            close(timu.sqrt_info_from_cov(tp.cov), jimu.sqrt_info_from_cov(jp.cov), rtol=1e-8)
        s = [rng.standard_normal(k) for k in (3, 4, 3, 3, 3, 3, 4, 3, 3, 3)]
        s[1] /= np.linalg.norm(s[1])
        s[6] /= np.linalg.norm(s[6])
        g = np.array([0.0, 0.0, 9.81007])
        close(timu.imu_residual(*[T(x) for x in s], tp, T(g)),
              jimu.imu_residual(*[J(x) for x in s], jp, J(g)))
        close(torch.cat(timu.bias_corrected_delta(tp, T(s[3]), T(s[4]))),
              jnp.concatenate(jimu.bias_corrected_delta(jp, J(s[3]), J(s[4]))))


@pytest.mark.parametrize("align", ["yaw", "se3", "sim3"])
def test_ate_rmse(align):
    """The port's numpy ATE against the JAX package's, on a trajectory with
    a rotated, shifted, scaled and noisy estimate and offset timestamps."""
    rng = np.random.default_rng(5)
    gt_t = np.arange(200) * 0.05
    gt_p = np.cumsum(rng.standard_normal((200, 3)) * 0.1, axis=0)
    c, s = np.cos(0.7), np.sin(0.7)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    est_t = gt_t[::2] + rng.uniform(-0.015, 0.015, 100)
    est_p = 1.1 * gt_p[::2] @ R.T + [1.0, -2.0, 0.5] + rng.standard_normal((100, 3)) * 0.02
    want = jmetrics.ate_rmse(est_t, est_p, gt_t, gt_p, align=align)
    got = tmetrics.ate_rmse(est_t, est_p, gt_t, gt_p, align=align)
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=RTOL)
    assert np.isnan(tmetrics.ate_rmse(est_t[:2], est_p[:2], gt_t, gt_p, align=align))
