"""Offline intrinsic calibration from planar-target views.

Counterpart of `plslam/ops/calibration.py` (the reference's
`camera_model/src/intrinsic_calib.cc` chessboard calibrator). Given the
detected target corners of N views of a planar grid, it estimates
pinhole+radtan intrinsics:

  1. per-view homographies (DLT) and Zhang's closed-form intrinsics, on the
     host in numpy (distortion starts at 0),
  2. per-view poses from the homographies, on the host,
  3. a joint Gauss-Newton over [intrinsics(8) | poses(6N)] on `device` in
     float64: all views × corners evaluate as one batch, and the Jacobian is
     `torch.func.jacfwd` through the port's `ops/cameras.project`. The
     normal equations are Jacobi-scaled before their Cholesky solve, and
     no step reads a value back to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from plslam_torch.ops.cameras import PinholeRadTan, project
from plslam_torch.utils.device import resolve_device
from plslam_torch.utils.geometry import quat_box_plus, quat_rotate, rot_to_quat


def _homography_dlt(obj_xy, img_uv):
    """Planar DLT homography (normalized)."""
    n = len(obj_xy)
    A = []
    for k in range(n):
        X, Y = obj_xy[k]
        u, v = img_uv[k]
        A.append([-X, -Y, -1, 0, 0, 0, u * X, u * Y, u])
        A.append([0, 0, 0, -X, -Y, -1, v * X, v * Y, v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    return H / H[2, 2]


def _zhang_init(Hs):
    """Closed-form intrinsics from ≥3 homographies (Zhang 2000)."""

    def v_ij(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    V = []
    for H in Hs:
        V.append(v_ij(H, 0, 1))
        V.append(v_ij(H, 0, 0) - v_ij(H, 1, 1))
    _, _, Vt = np.linalg.svd(np.asarray(V))
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return fx, fy, cx, cy


def _pose_from_homography(H, K):
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / np.linalg.norm(Kinv @ h1)
    r1 = lam * Kinv @ h1
    r2 = lam * Kinv @ h2
    t = lam * Kinv @ h3
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = -R
    if t[2] < 0:  # target must be in front
        R[:, 0:2] *= -1
        t = -t
    return R, t


def calibrate_pinhole_radtan(obj_xy, img_uv_views, iters=20, device=None):
    """Calibrate from N views: obj_xy [M,2] planar target points (z = 0, e.g.
    chessboard corners × square size), img_uv_views [N,M,2] detections.
    Runs on the card unless `device` says otherwise.

    Returns (PinholeRadTan of float64 0-d tensors on the device, rms
    reprojection error in px)."""
    dev = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    obj_xy = np.asarray(obj_xy, np.float64)
    img_uv_views = np.asarray(img_uv_views, np.float64)
    N, M = len(img_uv_views), len(obj_xy)
    Hs = [_homography_dlt(obj_xy, img_uv_views[k]) for k in range(N)]
    fx, fy, cx, cy = _zhang_init(Hs)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    poses = [_pose_from_homography(H, K) for H in Hs]

    obj3 = torch.as_tensor(np.concatenate([obj_xy, np.zeros((M, 1))], axis=1), **f64)
    uv = torch.as_tensor(img_uv_views, **f64)  # [N,M,2]
    q0 = rot_to_quat(torch.as_tensor(np.stack([R for R, _ in poses]), **f64))
    t0 = torch.as_tensor(np.stack([t for _, t in poses]), **f64)
    intr0 = torch.as_tensor([fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0], **f64)
    D = 8 + 6 * N
    eye = torch.eye(D, **f64)

    def residual(intr, qs, ts):
        cam = PinholeRadTan(*intr.unbind())
        p_c = quat_rotate(qs[:, None, :].expand(N, M, 4), obj3.expand(N, M, 3)) + ts[:, None, :]
        return (project(cam, p_c) - uv).reshape(-1)

    def gn_step(intr, qs, ts, lam):
        def r_of(d):
            return residual(intr + d[0:8], quat_box_plus(qs, d[8: 8 + 3 * N].reshape(N, 3)),
                            ts + d[8 + 3 * N:].reshape(N, 3))

        zero = torch.zeros(D, **f64)
        r0 = r_of(zero)
        J = torch.func.jacfwd(r_of)(zero)
        H = J.T @ J
        b = J.T @ r0
        sc = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-9))
        Hs_ = H * sc[:, None] * sc[None, :] + lam * eye
        d = -torch.cholesky_solve((b * sc)[:, None], torch.linalg.cholesky(Hs_))[:, 0] * sc
        intr2 = intr + d[0:8]
        qs2 = quat_box_plus(qs, d[8: 8 + 3 * N].reshape(N, 3))
        ts2 = ts + d[8 + 3 * N:].reshape(N, 3)
        c0 = 0.5 * torch.sum(r0 * r0)
        r1 = residual(intr2, qs2, ts2)
        c1 = 0.5 * torch.sum(r1 * r1)
        accept = c1 < c0
        return (torch.where(accept, intr2, intr), torch.where(accept, qs2, qs),
                torch.where(accept, ts2, ts),
                torch.where(accept, torch.clamp(lam * 0.3, min=1e-10),
                            torch.clamp(lam * 8, max=1e3)),
                torch.where(accept, c1, c0))

    intr, qs, ts, lam = intr0, q0, t0, torch.tensor(1e-3, **f64)
    cost = torch.tensor(float("inf"), **f64)
    for _ in range(iters):
        intr, qs, ts, lam, cost = gn_step(intr, qs, ts, lam)
    rms = float(torch.sqrt(2.0 * cost / (N * M)))
    return PinholeRadTan(*intr.unbind()), rms
