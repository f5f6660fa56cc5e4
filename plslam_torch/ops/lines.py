"""Plücker line geometry: orthonormal parameterisation, frame transforms,
two-plane triangulation, point-line residual helpers.

Counterpart of `plslam/ops/lines.py` (the reference's `line_geometry.cpp`).
A line is a Plücker 6-vector ``[n; v]`` (``v`` the direction, ``n = p × v``);
the solver updates it through the 4-DoF orthonormal chart (`orth_retract`).
All functions are vectorised over leading axes.
"""
from __future__ import annotations

import torch

from plslam_torch.utils.geometry import cross, skew, so3_exp


def plucker_from_points(p1, p2):
    """Line through 3D points p1, p2: v = p2-p1, n = p1 × p2."""
    return torch.cat([cross(p1, p2), p2 - p1], dim=-1)


def plucker_split(L):
    return L[..., 0:3], L[..., 3:6]


def plucker_frame(L):
    """Orthonormal frame U = [n̂, v̂, n̂×v̂] and magnitudes (‖n‖, ‖v‖)."""
    n, v = plucker_split(L)
    nn = torch.linalg.norm(n, dim=-1, keepdim=True)
    nv = torch.linalg.norm(v, dim=-1, keepdim=True)
    n_hat = n / torch.clamp(nn, min=1e-12)
    v_hat = v / torch.clamp(nv, min=1e-12)
    u3 = cross(n_hat, v_hat)
    U = torch.stack([n_hat, v_hat, u3], dim=-1)  # columns
    return U, nn[..., 0], nv[..., 0]


def plucker_to_orth(L):
    """(U, w1, w2) with w = (cosφ, sinφ), ‖w‖=1 (the reference's `plk_to_orth`)."""
    U, nn, nv = plucker_frame(L)
    d = torch.sqrt(nn * nn + nv * nv)
    w1 = nn / torch.clamp(d, min=1e-12)
    w2 = nv / torch.clamp(d, min=1e-12)
    return U, w1, w2


def orth_to_plucker(U, w1, w2):
    """(U, cosφ, sinφ) -> unit-scale Plücker [w1·u1; w2·u2] (`orth_to_plk`)."""
    n = w1[..., None] * U[..., :, 0]
    v = w2[..., None] * U[..., :, 1]
    return torch.cat([n, v], dim=-1)


def orth_retract(L, delta):
    """⊞ on the 4-DoF orthonormal chart, applied to a Plücker 6-vector
    (`LineOrthParameterization::Plus`); keeps the overall scale."""
    U, w1, w2 = plucker_to_orth(L)
    n, v = plucker_split(L)
    d = torch.sqrt(torch.sum(n * n, dim=-1) + torch.sum(v * v, dim=-1))
    dR = so3_exp(delta[..., 0:3])
    U_new = U @ dR
    c, s = torch.cos(delta[..., 3]), torch.sin(delta[..., 3])
    w1_new = c * w1 - s * w2
    w2_new = s * w1 + c * w2
    return d[..., None] * orth_to_plucker(U_new, w1_new, w2_new)


def _matvec(M, x):
    return torch.einsum("...ij,...j->...i", M, x)


def plucker_transform(L, R, t):
    """Transform a Plücker line between frames: x_dst = R x_src + t.
    n' = R n + [t]× R v ;  v' = R v."""
    n, v = plucker_split(L)
    Rv = _matvec(R, v)
    Rn = _matvec(R, n)
    n_new = Rn + _matvec(skew(t), Rv)
    return torch.cat([n_new, Rv], dim=-1)


def plane_from_cam_segment(R_wc, p_wc, s_n, e_n):
    """Plane through the camera center and an observed segment (normalized
    endpoints [...,2]) -> homogeneous world plane [...,4]."""
    s_c = torch.cat([s_n, torch.ones_like(s_n[..., :1])], dim=-1)
    e_c = torch.cat([e_n, torch.ones_like(e_n[..., :1])], dim=-1)
    s_w = _matvec(R_wc, s_c) + p_wc
    e_w = _matvec(R_wc, e_c) + p_wc
    nrm = cross(s_w - p_wc, e_w - p_wc)
    d = -torch.sum(nrm * p_wc, dim=-1, keepdim=True)
    return torch.cat([nrm, d], dim=-1)


def plucker_from_planes(pi1, pi2):
    """Two planes -> Plücker line via the dual matrix L* = π₁π₂ᵀ − π₂π₁ᵀ (`pipi_plk`)."""
    Ls = pi1[..., :, None] * pi2[..., None, :] - pi2[..., :, None] * pi1[..., None, :]
    n = Ls[..., 0:3, 3]
    v = torch.stack([Ls[..., 2, 1], Ls[..., 0, 2], Ls[..., 1, 0]], dim=-1)
    return torch.cat([n, v], dim=-1)


def line_projection_residual(L_c, s_n, e_n):
    """Signed distances of the two observed endpoints to the projected
    infinite line l = n_c, each / √(l₁²+l₂²) (`lineProjectionFactor::Evaluate`)."""
    l = L_c[..., 0:3]
    denom = torch.clamp(torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2), min=1e-12)
    s_h = torch.cat([s_n, torch.ones_like(s_n[..., :1])], dim=-1)
    e_h = torch.cat([e_n, torch.ones_like(e_n[..., :1])], dim=-1)
    rs = torch.sum(s_h * l, dim=-1) / denom
    re = torch.sum(e_h * l, dim=-1) / denom
    return torch.stack([rs, re], dim=-1)


def closest_point_on_line(L, p):
    """Closest point on line (n,v) to point p."""
    n, v = plucker_split(L)
    v2 = torch.sum(v * v, dim=-1, keepdim=True)
    p0 = cross(v, n) / torch.clamp(v2, min=1e-12)
    t = torch.sum((p - p0) * v, dim=-1, keepdim=True) / torch.clamp(v2, min=1e-12)
    return p0 + t * v


def trim_line_to_segment(L, s_w_dir, e_w_dir):
    """3D endpoints of an infinite line for two viewing rays: the line's
    closest points to the rays' points (a visualization helper)."""
    return closest_point_on_line(L, s_w_dir), closest_point_on_line(L, e_w_dir)
