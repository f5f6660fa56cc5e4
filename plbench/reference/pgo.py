"""The 4-DoF pose-graph solve in plain torch: Gauss-Newton with LM damping
over [K,3] positions and [K] yaws, dense normal equations, Huber weights on
the loop edges, the first valid node as the gauge anchor. A frozen copy of
the port's `optimize_4dof`, run here in float64."""
from __future__ import annotations

import numpy as np
import torch

from plbench.reference.geometry import ypr_to_rot
from plbench.reference.imu import cholesky


def _rot_ypr(yaw, pitch, roll):
    return ypr_to_rot(torch.stack([yaw, pitch, roll], dim=-1))


def _wrap(a):
    return torch.remainder(a + np.pi, 2 * np.pi) - np.pi


def _edge_system(pitch, roll, e_i, e_j, e_t, e_yaw, e_w, e_valid, e_loop, yaw_scale=0.1):
    pitch_i, roll_i = pitch[e_i], roll[e_i]
    scale = (e_w * e_valid)[:, None]
    inv_ys = 1.0 / yaw_scale

    def residuals_at(xyz, yaw):
        d = xyz[e_j] - xyz[e_i]
        R = _rot_ypr(yaw[e_i], pitch_i, roll_i)
        r_t = (R.transpose(-1, -2) @ d[:, :, None])[:, :, 0] - e_t
        r_y = _wrap(yaw[e_j] - yaw[e_i] - e_yaw) * inv_ys
        return torch.cat([r_t, r_y[:, None]], dim=-1) * e_w[:, None] * e_valid[:, None], R, d

    def system(xyz, yaw):
        r, R, d = residuals_at(xyz, yaw)
        RT = R.transpose(-1, -2)
        sd = torch.stack([d[:, 1], -d[:, 0], torch.zeros_like(d[:, 0])], dim=-1)
        J = torch.zeros((r.shape[0], 4, 8), dtype=r.dtype)
        J[:, 0:3, 0:3] = -RT
        J[:, 0:3, 3] = (RT @ sd[:, :, None])[:, :, 0]
        J[:, 0:3, 4:7] = RT
        J[:, 3, 3] = -inv_ys
        J[:, 3, 7] = inv_ys
        J = J * scale[:, :, None]
        rn2 = torch.sum(r * r, dim=-1)
        hub = torch.where(rn2 > 1.0, 1.0 / torch.sqrt(torch.sqrt(rn2)), torch.ones_like(rn2))
        w = torch.where(e_loop > 0, hub, torch.ones_like(hub))
        return r * w[:, None], J * w[:, None, None], w

    return (lambda xyz, yaw: residuals_at(xyz, yaw)[0]), system


def optimize_4dof(xyz0, yaw0, pitch, roll, node_valid, e_i, e_j, e_t, e_yaw, e_w, e_valid,
                  e_loop, iters: int = 12):
    """Returns (xyz [K,3], yaw [K]) after `iters` damped steps."""
    K = xyz0.shape[0]
    dtype = xyz0.dtype
    first = int(torch.argmax(node_valid))
    free = node_valid * (torch.arange(K) != first).to(dtype)
    fm = torch.repeat_interleave(free, 4)
    all_residuals, system = _edge_system(pitch, roll, e_i, e_j, e_t, e_yaw, e_w, e_valid, e_loop)
    n4 = 4 * K
    cols = torch.arange(4)
    xyz, yaw = xyz0, yaw0
    lam = torch.tensor(1e-4, dtype=dtype)
    for _ in range(iters):
        r, Jk, w = system(xyz, yaw)
        H = torch.zeros((n4, n4), dtype=dtype)
        b = torch.zeros(n4, dtype=dtype)
        idx = torch.cat([e_i[:, None] * 4 + cols, e_j[:, None] * 4 + cols], dim=1)  # [E,8]
        for e in range(r.shape[0]):
            Je = Jk[e]
            H[idx[e][:, None], idx[e][None, :]] += Je.T @ Je
            b[idx[e]] += Je.T @ r[e]
        sc = fm / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-6))
        Hs = H * sc[:, None] * sc[None, :] + torch.diag(1.0 - fm + lam)
        delta = -torch.cholesky_solve((b * sc)[:, None], cholesky(Hs))[:, 0] * sc
        xyz_new = xyz + delta.reshape(K, 4)[:, 0:3]
        yaw_new = yaw + delta.reshape(K, 4)[:, 3]
        cost0 = torch.sum(r * r)
        r_new = all_residuals(xyz_new, yaw_new) * w[:, None]
        cost1 = torch.sum(r_new * r_new)
        if bool(cost1 < cost0):
            xyz, yaw, lam = xyz_new, yaw_new, torch.clamp(lam * 0.3, min=1e-8)
        else:
            lam = torch.clamp(lam * 8.0, max=1e2)
    return xyz, yaw
