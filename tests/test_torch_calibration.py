"""Intrinsic calibration on the port (`plslam_torch/ops/calibration.py`)
against the JAX package's (`plslam/ops/calibration.py`): `test_calibration.py`'s
case with views made by the port's own camera and geometry, and the same
seeded views through both packages.

Tolerances: the JAX test's bounds (rms < 0.2 px; fx, fy within 1 px, cx, cy
within 1.5 px, k1 within 0.01, k2 within 0.03); port against JAX: every
intrinsic within 1e-6 and the rms within 1e-9 (both float64; the host init
is the same numpy, the Gauss-Newton the same steps in another library).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.ops import cameras as jcam
from plslam.ops.calibration import calibrate_pinhole_radtan as jax_calibrate
from plslam.utils import geometry as jgeo
from plslam_torch.ops import cameras as tcam
from plslam_torch.ops.calibration import calibrate_pinhole_radtan
from plslam_torch.utils import geometry as tgeo

GT = (460.0, 455.0, 370.0, 245.0, -0.25, 0.06, 5e-4, -3e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _board():
    """9×6 chessboard, 4 cm squares."""
    gx, gy = np.meshgrid(np.arange(9) * 0.04, np.arange(6) * 0.04)
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def _port_views(n_views, seed=0, noise=0.1):
    """`test_calibration.py`'s views, made with the port's camera and geometry."""
    rng = np.random.default_rng(seed)
    cam = tcam.PinholeRadTan.create(*GT, dtype=torch.float64)
    obj = _board()
    obj3 = torch.as_tensor(np.concatenate([obj, np.zeros((len(obj), 1))], axis=1))
    views = []
    for _ in range(n_views):
        R = tgeo.so3_exp(torch.as_tensor(rng.uniform(-0.4, 0.4, 3)))
        t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), rng.uniform(0.5, 0.9)])
        q = tgeo.rot_to_quat(R)
        p_c = tgeo.quat_rotate(q.expand(len(obj), 4), obj3) + torch.as_tensor(t)
        uv = tcam.project(cam, p_c).numpy().copy()
        uv += rng.standard_normal(uv.shape) * noise  # detector noise, px
        views.append(uv)
    return obj, np.stack(views)


def _jax_views(n_views, seed=0, noise=0.1):
    """The same views made by the JAX package (`test_calibration.py` verbatim)."""
    rng = np.random.default_rng(seed)
    cam = jcam.PinholeRadTan.create(*GT, dtype=jnp.float64)
    obj = _board()
    obj3 = jnp.asarray(np.concatenate([obj, np.zeros((len(obj), 1))], axis=1))
    views = []
    for _ in range(n_views):
        R = np.asarray(jgeo.so3_exp(jnp.asarray(rng.uniform(-0.4, 0.4, 3))))
        t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), rng.uniform(0.5, 0.9)])
        q = jgeo.rot_to_quat(jnp.asarray(R))
        p_c = jgeo.quat_rotate(jnp.broadcast_to(q, (len(obj), 4)), obj3) + jnp.asarray(t)
        uv = np.array(jcam.project(cam, p_c))
        uv += rng.standard_normal(uv.shape) * noise
        views.append(uv)
    return obj, np.stack(views)


def test_calibrate_recovers_intrinsics():
    obj, views = _port_views(8)
    np.testing.assert_allclose(views, _jax_views(8)[1], rtol=0, atol=1e-9)
    cam, rms = calibrate_pinhole_radtan(obj, views, device="cpu")
    assert cam.fx.dtype == torch.float64
    assert rms < 0.2, rms
    assert abs(float(cam.fx) - 460.0) < 1.0
    assert abs(float(cam.fy) - 455.0) < 1.0
    assert abs(float(cam.cx) - 370.0) < 1.5
    assert abs(float(cam.cy) - 245.0) < 1.5
    assert abs(float(cam.k1) + 0.25) < 0.01
    assert abs(float(cam.k2) - 0.06) < 0.03


@pytest.mark.parametrize("n_views,noise", [(8, 0.1), (5, 0.5)])
def test_calibration_matches_jax(n_views, noise):
    obj, views = _jax_views(n_views, noise=noise)
    cam_t, rms_t = calibrate_pinhole_radtan(obj, views, device="cpu")
    cam_j, rms_j = jax_calibrate(obj, views)
    np.testing.assert_allclose([float(v) for v in cam_t], [float(v) for v in cam_j],
                               rtol=0, atol=1e-6)
    assert abs(rms_t - rms_j) < 1e-9


def test_calibrate_defaults_to_the_card(monkeypatch):
    """No `device` means the card, and on a host without one it raises
    (no CPU fallback)."""
    obj, views = _port_views(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate_pinhole_radtan(obj, views)
