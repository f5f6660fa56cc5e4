"""Trajectory evaluation: ATE / RPE with yaw-only (4-DoF) or Umeyama
alignment, and TUM trajectory files.

A numpy copy of `plslam/eval/metrics.py`, so that the port, its command line
and its smoke script score a trajectory without importing the JAX package.
`write_tum` writes JAX's exact text (6 decimals for t and p, 7 for q, in
xyzw order), so both packages write byte-identical files for equal arrays.
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


def _nearest(est_t, gt_t, max_dt):
    """For each est time, the index of the nearest gt time, and whether it
    lies within `max_dt`."""
    idx = np.clip(np.searchsorted(gt_t, est_t), 1, len(gt_t) - 1)
    use_left = np.abs(est_t - gt_t[idx - 1]) < np.abs(est_t - gt_t[idx])
    gi = np.where(use_left, idx - 1, idx)
    return gi, np.abs(gt_t[gi] - est_t) <= max_dt


def associate(est_t, est_p, gt_t, gt_p, max_dt=0.02, return_t=False):
    """Nearest-timestamp association of two trajectories: (est_p, gt_p) of the
    pairs within `max_dt`, and their est times too with `return_t`."""
    est_t = np.asarray(est_t)
    gi, ok = _nearest(est_t, np.asarray(gt_t), max_dt)
    if return_t:
        return np.asarray(est_p)[ok], np.asarray(gt_p)[gi][ok], est_t[ok]
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


def rpe(est_t, est_p, gt_t, gt_p, est_q=None, gt_q=None, delta=1.0, max_dt=0.02):
    """Relative pose error over windows of `delta` seconds, evo/TUM
    semantics: for each pair (i, j = i + Δ) the error motion
    E = (Q_i⁻¹ Q_j)⁻¹ (P_i⁻¹ P_j), Q ground truth, P estimate, compared in the
    frame of pose i. Returns (trans_rmse [m], rot_rmse [deg]); the rotation is
    NaN without quaternions (est_q / gt_q: [N,4] wxyz). Position-only input
    is yaw-aligned first and compares world-frame deltas."""
    from plslam_torch.utils import quat_np as qnp

    est_t = np.asarray(est_t)
    gi, ok = _nearest(est_t, np.asarray(gt_t), max_dt)
    P_p = np.asarray(est_p)[ok]
    G_p = np.asarray(gt_p)[gi][ok]
    have_rot = est_q is not None and gt_q is not None
    if not have_rot and len(P_p) >= 3:
        R, t = yaw_only_alignment(P_p, G_p)  # world-frame deltas are gauge-sensitive
        P_p = P_p @ R.T + t
    ts = est_t[ok]
    if have_rot:
        P_q = np.asarray(est_q)[ok]
        G_q = np.asarray(gt_q)[gi][ok]

    t_errs, r_errs = [], []
    j = 0
    for i in range(len(ts)):
        while j < len(ts) and ts[j] < ts[i] + delta:
            j += 1
        if j >= len(ts):
            break
        if have_rot:
            d_est_t = qnp.quat_rotate(qnp.quat_conj(P_q[i]), P_p[j] - P_p[i])
            d_gt_t = qnp.quat_rotate(qnp.quat_conj(G_q[i]), G_p[j] - G_p[i])
            d_est_q = qnp.quat_mul(qnp.quat_conj(P_q[i]), P_q[j])
            d_gt_q = qnp.quat_mul(qnp.quat_conj(G_q[i]), G_q[j])
            e_q = qnp.quat_mul(qnp.quat_conj(d_gt_q), d_est_q)  # E = d_gt⁻¹ ∘ d_est
            e_t = qnp.quat_rotate(qnp.quat_conj(d_gt_q), d_est_t - d_gt_t)
            t_errs.append(np.linalg.norm(e_t))
            r_errs.append(2.0 * np.arccos(np.clip(abs(e_q[0]), -1.0, 1.0)))
        else:
            t_errs.append(np.linalg.norm((P_p[j] - P_p[i]) - (G_p[j] - G_p[i])))
    if not t_errs:
        return float("nan"), float("nan")
    t_rmse = float(np.sqrt(np.mean(np.square(t_errs))))
    r_rmse = float(np.rad2deg(np.sqrt(np.mean(np.square(r_errs))))) if r_errs else float("nan")
    return t_rmse, r_rmse


def write_tum(path, ts, ps, qs):
    """TUM trajectory file: `t x y z qx qy qz qw` a line (qs in wxyz)."""
    with open(path, "w") as fh:
        for t, p, q in zip(ts, ps, qs):
            fh.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                     f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def read_tum(path):
    """(ts, ps, qs wxyz) of a TUM trajectory file."""
    data = np.loadtxt(path)
    return data[:, 0], data[:, 1:4], data[:, [7, 4, 5, 6]]
