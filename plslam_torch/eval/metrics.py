"""Trajectory evaluation: ATE with yaw-only (4-DoF) or Umeyama alignment.

A numpy copy of the ATE half of `plslam/eval/metrics.py`, so that the port
and its smoke script score a trajectory without importing the JAX package.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(est_p, gt_p, with_scale=False):
    """Least-squares similarity/SE(3) alignment: returns (s, R, t) minimizing
    ‖gt − (s·R·est + t)‖²."""
    mu_e = est_p.mean(axis=0)
    mu_g = gt_p.mean(axis=0)
    xe = est_p - mu_e
    xg = gt_p - mu_g
    C = xg.T @ xe / len(est_p)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xe * xe).sum() / len(est_p))) if with_scale else 1.0
    return s, R, mu_g - s * R @ mu_e


def yaw_only_alignment(est_p, gt_p):
    """4-DoF (yaw + translation) alignment — the gauge of VIO, where pitch and
    roll are observable."""
    mu_e = est_p.mean(axis=0)
    mu_g = gt_p.mean(axis=0)
    xe = est_p - mu_e
    xg = gt_p - mu_g
    a = float((xe[:, 0] * xg[:, 0] + xe[:, 1] * xg[:, 1]).sum())
    b = float((xe[:, 0] * xg[:, 1] - xe[:, 1] * xg[:, 0]).sum())
    theta = np.arctan2(b, a)
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return R, mu_g - R @ mu_e


def associate(est_t, est_p, gt_t, gt_p, max_dt=0.02):
    """Nearest-timestamp association of two trajectories."""
    est_t = np.asarray(est_t)
    gt_t = np.asarray(gt_t)
    idx = np.clip(np.searchsorted(gt_t, est_t), 1, len(gt_t) - 1)
    use_left = np.abs(est_t - gt_t[idx - 1]) < np.abs(est_t - gt_t[idx])
    gi = np.where(use_left, idx - 1, idx)
    ok = np.abs(gt_t[gi] - est_t) <= max_dt
    return np.asarray(est_p)[ok], np.asarray(gt_p)[gi][ok]


def ate_rmse(est_t, est_p, gt_t, gt_p, align="yaw", max_dt=0.02):
    """Absolute trajectory error RMSE after temporal association + alignment.

    align: 'yaw' (4-DoF, VIO standard), 'se3', or 'sim3'."""
    est_p_a, gt_p_a = associate(est_t, est_p, gt_t, gt_p, max_dt)
    if len(est_p_a) < 3:
        return float("nan")
    if align == "yaw":
        R, t = yaw_only_alignment(est_p_a, gt_p_a)
        err = gt_p_a - (est_p_a @ R.T + t)
    else:
        s, R, t = umeyama_alignment(est_p_a, gt_p_a, with_scale=(align == "sim3"))
        err = gt_p_a - (s * est_p_a @ R.T + t)
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))
