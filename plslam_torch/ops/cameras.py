"""Camera models: pinhole-radtan, Kannala-Brandt, MEI and Scaramuzza.

Counterpart of `plslam/ops/cameras.py` (the camodocal subset of the reference:
`liftProjective` / `spaceToPlane` per model, `CameraFactory` dispatch). A
camera is a NamedTuple of 0-d tensors; every op is vectorised over arbitrary
leading axes and dispatches on the camera's class in Python.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _params(values, dtype, device):
    return [torch.as_tensor(float(v), dtype=dtype, device=device) for v in values]


class PinholeRadTan(NamedTuple):
    """fx, fy, cx, cy intrinsics + k1,k2,p1,p2 radtan distortion."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, dtype=torch.float32, device=None):
        return PinholeRadTan(*_params((fx, fy, cx, cy, k1, k2, p1, p2), dtype, device))

    @staticmethod
    def euroc_cam0(dtype=torch.float32, device=None):
        """EuRoC MAV cam0 intrinsics."""
        return PinholeRadTan.create(
            458.654, 457.296, 367.215, 248.375,
            -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, dtype=dtype, device=device,
        )


def distort(cam: PinholeRadTan, mn):
    """Apply radtan distortion to normalized coords mn [...,2]."""
    x, y = mn[..., 0], mn[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    rad = cam.k1 * r2 + cam.k2 * r2 * r2
    dx = x * rad + 2.0 * cam.p1 * xy + cam.p2 * (r2 + 2.0 * x2)
    dy = y * rad + cam.p1 * (r2 + 2.0 * y2) + 2.0 * cam.p2 * xy
    return mn + torch.stack([dx, dy], dim=-1)


def _pinhole_project(cam: PinholeRadTan, p_c):
    z = p_c[..., 2:3]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    mn = p_c[..., 0:2] / z_safe
    md = distort(cam, mn)
    u = cam.fx * md[..., 0] + cam.cx
    v = cam.fy * md[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def _distort_jac(cam: PinholeRadTan, mn):
    """Analytic 2×2 jacobian of the distortion map (for Newton undistortion)."""
    x, y = mn[..., 0], mn[..., 1]
    r2 = x * x + y * y
    rad = cam.k1 * r2 + cam.k2 * r2 * r2
    dr = cam.k1 + 2.0 * cam.k2 * r2
    j00 = 1.0 + rad + 2.0 * x * x * dr + 2.0 * cam.p1 * y + 6.0 * cam.p2 * x
    j01 = 2.0 * x * y * dr + 2.0 * cam.p1 * x + 2.0 * cam.p2 * y
    j10 = 2.0 * x * y * dr + 2.0 * cam.p1 * x + 2.0 * cam.p2 * y
    j11 = 1.0 + rad + 2.0 * y * y * dr + 6.0 * cam.p1 * y + 2.0 * cam.p2 * x
    return j00, j01, j10, j11


def _pinhole_lift(cam: PinholeRadTan, uv, iters: int = 5):
    """Pixel coords [...,2] -> undistorted normalized coords [...,2] by a
    fixed-count batched Newton iteration (closed-form 2×2 solve)."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    md = torch.stack([mx, my], dim=-1)
    mn = md
    for _ in range(iters):
        f = distort(cam, mn) - md
        j00, j01, j10, j11 = _distort_jac(cam, mn)
        det = j00 * j11 - j01 * j10
        det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
        dx = (j11 * f[..., 0] - j01 * f[..., 1]) / det
        dy = (-j10 * f[..., 0] + j00 * f[..., 1]) / det
        mn = mn - torch.stack([dx, dy], dim=-1)
    return mn


def _pinhole_normalized_to_pixel(cam: PinholeRadTan, mn):
    md = distort(cam, mn)
    u = cam.fx * md[..., 0] + cam.cx
    v = cam.fy * md[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


class EquidistantCamera(NamedTuple):
    """Kannala-Brandt fisheye: r(θ) = θ + k2 θ³ + k3 θ⁵ + k4 θ⁷ + k5 θ⁹."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    k4: torch.Tensor
    k5: torch.Tensor

    @staticmethod
    def create(fx, fy, cx, cy, k2=0.0, k3=0.0, k4=0.0, k5=0.0, dtype=torch.float32, device=None):
        return EquidistantCamera(*_params((fx, fy, cx, cy, k2, k3, k4, k5), dtype, device))


def equi_project(cam: EquidistantCamera, p_c):
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    rd = theta * (1.0 + t2 * (cam.k2 + t2 * (cam.k3 + t2 * (cam.k4 + t2 * cam.k5))))
    r_safe = torch.clamp(r, min=1e-12)
    u = cam.fx * rd * x / r_safe + cam.cx
    v = cam.fy * rd * y / r_safe + cam.cy
    return torch.stack([u, v], dim=-1)


def equi_lift(cam: EquidistantCamera, uv, iters: int = 8):
    """Newton on the θ-polynomial, batched + branch-free."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    rd = torch.sqrt(mx * mx + my * my)
    theta = rd
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (cam.k2 + t2 * (cam.k3 + t2 * (cam.k4 + t2 * cam.k5)))) - rd
        fp = 1.0 + t2 * (3 * cam.k2 + t2 * (5 * cam.k3 + t2 * (7 * cam.k4 + t2 * 9 * cam.k5)))
        theta = theta - f / torch.clamp(fp, min=1e-6)
    scale = torch.tan(theta) / torch.clamp(rd, min=1e-12)
    return torch.stack([mx * scale, my * scale], dim=-1)


class MeiCamera(NamedTuple):
    """MEI / unified omnidirectional model: unit-sphere projection with
    mirror parameter ξ + radtan distortion."""

    xi: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    @staticmethod
    def create(xi, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, dtype=torch.float32, device=None):
        return MeiCamera(*_params((xi, fx, fy, cx, cy, k1, k2, p1, p2), dtype, device))


def _mei_radtan(cam: MeiCamera) -> PinholeRadTan:
    return PinholeRadTan(cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2, cam.p1, cam.p2)


def mei_project(cam: MeiCamera, p_c):
    n = torch.linalg.norm(p_c, dim=-1, keepdim=True)
    s = p_c / torch.clamp(n, min=1e-12)
    denom = torch.clamp(s[..., 2:3] + cam.xi, min=1e-6)
    mn = s[..., 0:2] / denom
    md = distort(_mei_radtan(cam), mn)
    u = cam.fx * md[..., 0] + cam.cx
    v = cam.fy * md[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def mei_lift(cam: MeiCamera, uv, iters: int = 8):
    """Undistort (Newton on radtan), then invert the sphere projection."""
    mn = _pinhole_lift(_mei_radtan(cam), uv, iters)
    r2 = torch.sum(mn * mn, dim=-1, keepdim=True)
    xi = cam.xi
    disc = torch.clamp(1.0 + (1.0 - xi * xi) * r2, min=0.0)
    lam = (xi + torch.sqrt(disc)) / (1.0 + r2)
    z = lam - xi
    xy = lam * mn
    return xy / torch.clamp(z, min=1e-6)


class ScaramuzzaCamera(NamedTuple):
    """Scaramuzza omnidirectional model: z(ρ) = a0 + a2 ρ² + a3 ρ³ + a4 ρ⁴,
    affine (c, d, e) + center (cx, cy)."""

    a0: torch.Tensor
    a2: torch.Tensor
    a3: torch.Tensor
    a4: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    e: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @staticmethod
    def create(a0, a2, a3, a4, c=1.0, d=0.0, e=0.0, cx=0.0, cy=0.0, dtype=torch.float32, device=None):
        return ScaramuzzaCamera(*_params((a0, a2, a3, a4, c, d, e, cx, cy), dtype, device))


def _scara_poly(cam: ScaramuzzaCamera, rho):
    r2 = rho * rho
    return cam.a0 + r2 * (cam.a2 + rho * (cam.a3 + rho * cam.a4))


def _scara_dpoly(cam: ScaramuzzaCamera, rho):
    return rho * (2.0 * cam.a2 + rho * (3.0 * cam.a3 + rho * 4.0 * cam.a4))


def scara_lift(cam: ScaramuzzaCamera, uv):
    up = uv[..., 0] - cam.cx
    vp = uv[..., 1] - cam.cy
    det = cam.c - cam.d * cam.e
    x = (up - cam.d * vp) / det
    y = (-cam.e * up + cam.c * vp) / det
    rho = torch.sqrt(x * x + y * y)
    z = _scara_poly(cam, rho)
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.stack([x / z_safe, y / z_safe], dim=-1)


def scara_project(cam: ScaramuzzaCamera, p_c, iters: int = 12):
    """Solve ρ with Newton on z(ρ)·r_xy − ρ·z_3d = 0 (ray alignment)."""
    x, y, z3 = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    r_xy = torch.sqrt(x * x + y * y)
    r_safe = torch.clamp(r_xy, min=1e-12)
    rho = torch.full_like(r_xy, 100.0)
    for _ in range(iters):
        g = _scara_poly(cam, rho) * r_xy - rho * z3
        gp = _scara_dpoly(cam, rho) * r_xy - z3
        rho = rho - g / torch.where(torch.abs(gp) < 1e-9, torch.full_like(gp, 1e-9), gp)
    sx = x / r_safe * rho
    sy = y / r_safe * rho
    u = sx * cam.c + sy * cam.d + cam.cx
    v = sx * cam.e + sy + cam.cy
    return torch.stack([u, v], dim=-1)


def project(cam, p_c):
    """3D camera-frame points [...,3] -> pixel coords [...,2] (`spaceToPlane`)."""
    if isinstance(cam, EquidistantCamera):
        return equi_project(cam, p_c)
    if isinstance(cam, MeiCamera):
        return mei_project(cam, p_c)
    if isinstance(cam, ScaramuzzaCamera):
        return scara_project(cam, p_c)
    return _pinhole_project(cam, p_c)


def lift(cam, uv, iters: int = 5):
    """Pixel coords [...,2] -> normalized z=1 coords [...,2] (`liftProjective`)."""
    if isinstance(cam, EquidistantCamera):
        return equi_lift(cam, uv, max(iters, 8))
    if isinstance(cam, MeiCamera):
        return mei_lift(cam, uv, max(iters, 8))
    if isinstance(cam, ScaramuzzaCamera):
        return scara_lift(cam, uv)
    return _pinhole_lift(cam, uv, iters)


def pixel_to_normalized(cam, uv, iters: int = 8):
    """`lift` with 8 undistortion iterations by default."""
    return lift(cam, uv, iters)


def normalized_to_pixel(cam, mn):
    """Normalized z=1 coords -> pixel: project the ray (x, y, 1)."""
    if isinstance(cam, PinholeRadTan):
        return _pinhole_normalized_to_pixel(cam, mn)
    ones = torch.ones_like(mn[..., :1])
    return project(cam, torch.cat([mn, ones], dim=-1))


def make_camera(cc, dtype=torch.float32, device=None):
    """Build the camera model named by `CameraConfig.model_type` (the
    reference's `CameraFactory::generateCameraFromYamlFile`)."""
    mt = str(cc.model_type).upper()
    if mt in ("PINHOLE", ""):
        return PinholeRadTan.create(cc.fx, cc.fy, cc.cx, cc.cy,
                                    cc.k1, cc.k2, cc.p1, cc.p2, dtype=dtype, device=device)
    if mt in ("KANNALA_BRANDT", "EQUIDISTANT", "FISHEYE"):
        return EquidistantCamera.create(cc.fx, cc.fy, cc.cx, cc.cy,
                                        cc.kb2, cc.kb3, cc.kb4, cc.kb5, dtype=dtype, device=device)
    if mt in ("MEI", "CATA"):
        return MeiCamera.create(cc.xi, cc.fx, cc.fy, cc.cx, cc.cy,
                                cc.k1, cc.k2, cc.p1, cc.p2, dtype=dtype, device=device)
    if mt in ("SCARAMUZZA", "OCAM"):
        return ScaramuzzaCamera.create(cc.a0, cc.a2, cc.a3, cc.a4,
                                       cc.ac, cc.ad, cc.ae, cc.cx, cc.cy, dtype=dtype, device=device)
    raise ValueError(f"unknown camera model_type {cc.model_type!r}")


_CAM_CLASSES = (PinholeRadTan, EquidistantCamera, MeiCamera, ScaramuzzaCamera)


def cam_to_params(cam):
    """-> (kind_index, float64[9]), the fixed-width serialization of
    `plslam.ops.cameras.cam_to_params`."""
    vals = [float(v) for v in cam]
    vals += [0.0] * (9 - len(vals))
    return _CAM_CLASSES.index(type(cam)), np.asarray(vals, np.float64)


def cam_from_params(kind, params, dtype=torch.float32, device=None):
    cls = _CAM_CLASSES[int(kind)]
    return cls(*_params(list(params)[: len(cls._fields)], dtype, device))


def cam_to(cam, dtype=None, device=None):
    """The same camera with its parameters cast / moved."""
    return type(cam)(*[v.to(dtype=dtype or v.dtype, device=device or v.device) for v in cam])
