"""Visual-inertial initialization.

Counterpart of `plslam/models/initializer.py` (the reference's `initial/`):
  * `essential_ransac` — normalized 8-point essential-matrix RANSAC (host numpy),
  * `_sfm` — vision-only window BA reusing the LM/Schur solver with IMU and
    prior factors masked off (on the estimator's device, in float64),
  * `_solve_gyro_bias`, `_linear_alignment`, `_refine_gravity` — small
    dense least-squares solves on the host,
  * `try_initialize` — `initialStructure()` + `visualInitialAlign()`.
"""
from __future__ import annotations

import numpy as np
import torch

from plslam_torch.models import residuals as res
from plslam_torch.models import solver as solver_mod
from plslam_torch.models import triangulate
from plslam_torch.models.state import zero_state
from plslam_torch.utils import quat_np as qnp
from plslam_torch.utils import timers
from plslam_torch.utils.device import astensor
from plslam_torch.utils.geometry import gravity_to_rot

MIN_CORRESPONDENCES = 20
MIN_PARALLAX_INIT = 30.0 / 460.0  # 30 px-equivalent in normalized coords
# physical sanity ceiling on the aligned velocities (m/s): a degenerate init
# window leaves scale nearly unobservable and a wildly wrong scale passes
# every algebraic gate, but shows up as implausible metric velocities
MAX_INIT_VELOCITY = 3.0
PREFER_REFINED_FACTOR = 0.3


# --------------------------------------------------------------------- 8-point
def essential_ransac(pts1, pts2, iters=200, thresh=3.0 / 460.0, seed=0):
    """Normalized 8-point essential matrix with RANSAC; returns (R, t, inliers)
    with x2 ≈ R x1 + t up to scale (`MotionEstimator::solveRelativeRT`).
    All hypotheses are built, solved (one batched SVD) and scored at once."""
    rng = np.random.default_rng(seed)
    n = len(pts1)
    if n < 8:
        return None
    x1 = np.concatenate([pts1, np.ones((n, 1))], axis=1)
    x2 = np.concatenate([pts2, np.ones((n, 1))], axis=1)

    def build_A(a1, a2):
        return np.stack(
            [a2[..., 0] * a1[..., 0], a2[..., 0] * a1[..., 1], a2[..., 0],
             a2[..., 1] * a1[..., 0], a2[..., 1] * a1[..., 1], a2[..., 1],
             a1[..., 0], a1[..., 1], np.ones(a1.shape[:-1])], axis=-1)

    def rank2(E):
        U, _, Vt = np.linalg.svd(E)
        S = np.zeros_like(E)
        S[..., 0, 0] = 1.0
        S[..., 1, 1] = 1.0
        return U @ S @ Vt

    def sampson(E):
        Ex1 = np.einsum("...ij,nj->...ni", E, x1)
        Etx2 = np.einsum("...ji,nj->...ni", E, x2)
        num = np.einsum("ni,...ni->...n", x2, Ex1) ** 2
        den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
        return num / np.maximum(den, 1e-12)

    idx = np.stack([rng.choice(n, 8, replace=False) for _ in range(iters)])
    with np.errstate(all="ignore"):
        A = build_A(x1[idx], x2[idx])
        _, _, Vt = np.linalg.svd(A)
        E = rank2(Vt[:, -1, :].reshape(-1, 3, 3))
        d = sampson(E)
    inl = (d < thresh * thresh) & np.isfinite(d)
    best_in = inl[int(np.argmax(inl.sum(axis=1)))]
    if best_in.sum() < 12:
        return None
    sel = np.nonzero(best_in)[0]
    _, _, Vt = np.linalg.svd(build_A(x1[sel], x2[sel]))
    best_E = rank2(Vt[-1].reshape(3, 3))
    best_in = sampson(best_E) < thresh * thresh

    # decompose + cheirality (`recoverPose`)
    U, _, Vt = np.linalg.svd(best_E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    cands = [(U @ W @ Vt, U[:, 2]), (U @ W @ Vt, -U[:, 2]),
             (U @ W.T @ Vt, U[:, 2]), (U @ W.T @ Vt, -U[:, 2])]
    a = x1[best_in]
    b = x2[best_in]
    rows13 = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0]])
    row3 = np.array([0.0, 0, 1.0, 0])

    def depth_count(R, t):
        P2 = np.concatenate([R, t[:, None]], axis=1)
        M = np.stack([
            a[:, 0, None] * row3[None] - rows13[0][None],
            a[:, 1, None] * row3[None] - rows13[1][None],
            b[:, 0, None] * P2[2][None] - P2[0][None],
            b[:, 1, None] * P2[2][None] - P2[1][None],
        ], axis=1)
        with np.errstate(all="ignore"):
            _, _, Vt3 = np.linalg.svd(M)
        X = Vt3[:, -1, :]
        w = X[:, 3]
        X3 = X[:, :3] / np.where(np.abs(w) > 1e-12, w, 1e-12)[:, None]
        return int(np.sum((X3[:, 2] > 0) & (X3 @ R[2] + t[2] > 0)))

    R, t = max(cands, key=lambda c: depth_count(*c))
    return R, t, best_in


# ------------------------------------------------------------------------- SFM
def _relative_pose(est):
    """Find reference frame ℓ with enough parallax to the newest frame and
    solve its relative pose (`Estimator::relativePose`)."""
    nw = est.cfg.window_size
    tbl = est.pt_table
    for l in range(nw):
        both = tbl.active & tbl.mask[:, l] & tbl.mask[:, nw]
        if both.sum() < MIN_CORRESPONDENCES:
            continue
        d = tbl.obs[both, nw] - tbl.obs[both, l]
        if np.mean(np.linalg.norm(d, axis=1)) < MIN_PARALLAX_INIT:
            continue
        out = essential_ransac(tbl.obs[both, l], tbl.obs[both, nw])
        if out is None:
            continue
        R, t, _ = out  # x_new = R x_l + t (camera frames)
        return l, R, t
    return None


def _slerp(q0, q1, a):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -np.asarray(q1), -d
    d = min(d, 1.0)
    th = np.arccos(d)
    if th < 1e-8:
        return q0
    return (np.sin((1 - a) * th) * np.asarray(q0) + np.sin(a * th) * np.asarray(q1)) / np.sin(th)


def _sfm(est, l, R_nl, t_nl):
    """Vision-only window BA (`GlobalSFM::construct`) with frames ℓ and newest
    pinned, then a refinement pass with only ℓ pinned. Runs in float64 on
    the estimator's device. Returns both candidates (camera poses in the
    ℓ-camera frame + solved inverse depths) and the SFM mean cost."""
    nw = est.cfg.window_size
    lay, cfg = est.lay, est.cfg
    dtype, dev = torch.float64, est.device
    tbl = est.pt_table

    # initial camera poses: interpolate between identity (ℓ) and (R,t) (newest)
    p_c = np.zeros((nw + 1, 3))
    q_c = np.tile([1.0, 0, 0, 0], (nw + 1, 1))
    q_ln = qnp.rot_to_quat(R_nl.T)
    t_ln = -R_nl.T @ t_nl
    for k in range(nw + 1):
        a = np.clip((k - l) / max(nw - l, 1), 0.0, 1.0) if k >= l else 0.0
        p_c[k] = a * t_ln
        q_c[k] = np.asarray(_slerp(np.array([1.0, 0, 0, 0]), q_ln, a))

    t = lambda x, dt=dtype: astensor(x, dt, dev)  # noqa: E731
    st = zero_state(cfg, dtype, dev)._replace(p=t(p_c), q=t(q_c))
    used = tbl.active & (np.sum(tbl.mask, axis=1) >= 2)
    f = res.empty_factors(cfg, lay, dtype, dev)._replace(
        pt_obs=t(tbl.obs), pt_mask=t(tbl.mask.astype(np.float64)),
        pt_start=t(tbl.start, torch.int64), pt_valid=t(used.astype(np.float64)),
    )
    inv_d, ok = triangulate.triangulate_points(st.p, st.q, f.pt_obs, f.pt_mask, f.pt_start)
    st = st._replace(inv_depth=torch.where(ok, inv_d, torch.full_like(inv_d, 0.2)))
    f = f._replace(pt_valid=f.pt_valid * ok.to(dtype))

    st_out, stats = solver_mod.optimize_window(st, f, lay, cfg, num_iters=15, freeze_frames=(l, nw))
    inv_d, ok2 = triangulate.triangulate_points(st_out.p, st_out.q, f.pt_obs, f.pt_mask, f.pt_start)
    st_boot = st_out._replace(inv_depth=torch.where(ok2, inv_d, st_out.inv_depth))
    used_t = t(used, torch.bool)
    ok_boot = ok2 & used_t

    # refinement pass with a cleaner gauge: only frame ℓ pinned
    st_ref, _ = solver_mod.optimize_window(st_boot, f, lay, cfg, num_iters=10, freeze_frames=(l,))
    inv_d, ok3 = triangulate.triangulate_points(st_ref.p, st_ref.q, f.pt_obs, f.pt_mask, f.pt_start)
    st_ref = st_ref._replace(inv_depth=torch.where(ok3, inv_d, st_ref.inv_depth))
    ok_ref = ok3 & used_t

    h = lambda x: x.cpu().numpy()  # noqa: E731
    timers.count("host_wait", 9)  # the cost and the eight arrays below
    mean_err = float(stats.cost) / max(1.0, float(np.sum(tbl.mask)))
    cands = [(h(st_ref.p), h(st_ref.q), h(st_ref.inv_depth), h(ok_ref)),
             (h(st_boot.p), h(st_boot.q), h(st_boot.inv_depth), h(ok_boot))]
    return cands, mean_err


def _pres_host(est):
    """All interval preintegrations as host dicts (index k = 1..nw like
    `est.pres`; None for empty intervals), in one stacked readback."""
    stk, valid = est.window_pres()
    timers.count("host_wait", len(stk))
    stk_h = {k: v.cpu().numpy().astype(np.float64) for k, v in stk.items()}
    return [None] + [{k: stk_h[k][i] for k in stk_h} if ok else None
                     for i, ok in enumerate(valid)]


# -------------------------------------------------------------- VI alignment
def _solve_gyro_bias(est, q_bl, pres_h):
    """`solveGyroscopeBias`: LS on preintegrated vs visual rotation deltas."""
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for k in range(est.cfg.window_size):
        pre = pres_h[k + 1]
        if pre is None:
            continue
        q_ij = qnp.quat_mul(qnp.quat_conj(q_bl[k]), q_bl[k + 1])
        dq = qnp.quat_mul(qnp.quat_conj(pre["gamma"]), q_ij)
        if dq[0] < 0:
            dq = -dq
        J = pre["jac"][3:6, 12:15]
        A += J.T @ J
        b += J.T @ (2.0 * dq[1:4])
    if np.linalg.det(A) < 1e-12:
        return np.zeros(3)
    return np.linalg.solve(A, b)


def _linear_alignment(est, p_cl, q_bl, pres_h):
    """`LinearAlignment`: velocities (body frames), gravity in the ℓ-camera
    frame, and metric scale from the preintegrated deltas."""
    nw = est.cfg.window_size
    n_state = (nw + 1) * 3 + 3 + 1
    A = np.zeros((n_state, n_state))
    b = np.zeros(n_state)
    p_bc = est.p_bc
    R_bl = qnp.quat_to_rot(q_bl)
    for k in range(nw):
        pre = pres_h[k + 1]
        if pre is None:
            return None
        dt = float(pre["dt_sum"])
        Ri, Rj = R_bl[k], R_bl[k + 1]
        tmp_A = np.zeros((6, 10))
        tmp_b = np.zeros(6)
        tmp_A[0:3, 0:3] = -dt * np.eye(3)
        tmp_A[0:3, 6:9] = 0.5 * Ri.T @ np.eye(3) * dt * dt
        tmp_A[0:3, 9] = Ri.T @ (p_cl[k + 1] - p_cl[k]) / 100.0
        tmp_b[0:3] = pre["alpha"] + Ri.T @ Rj @ p_bc - p_bc
        tmp_A[3:6, 0:3] = -np.eye(3)
        tmp_A[3:6, 3:6] = Ri.T @ Rj
        tmp_A[3:6, 6:9] = Ri.T * dt
        tmp_b[3:6] = pre["beta"]
        idx = np.concatenate([np.arange(k * 3, k * 3 + 6), np.arange((nw + 1) * 3, n_state)])
        A[np.ix_(idx, idx)] += tmp_A.T @ tmp_A
        b[idx] += tmp_A.T @ tmp_b
    A *= 1000.0
    b *= 1000.0
    x = np.linalg.solve(A, b)
    s = x[-1] / 100.0
    g = x[(nw + 1) * 3: (nw + 1) * 3 + 3]
    if s < 1e-4 or abs(np.linalg.norm(g) - est.config.imu.g_norm) > 1.5:
        return None
    g, s, vels = _refine_gravity(est, p_cl, q_bl, g, pres_h)
    if s is None:
        return None
    return g, s, vels


def _refine_gravity(est, p_cl, q_bl, g0, pres_h):
    """`RefineGravity`: 2-DoF tangent refinement with ‖g‖ fixed to G."""
    nw = est.cfg.window_size
    gn = est.config.imu.g_norm
    p_bc = est.p_bc
    R_bl = qnp.quat_to_rot(q_bl)
    g = g0 / np.linalg.norm(g0) * gn
    vels = None
    s = None
    for _ in range(4):
        a = g / np.linalg.norm(g)
        tmp = np.array([0.0, 0.0, 1.0]) if abs(a[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
        b1 = np.cross(a, tmp)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(a, b1)
        basis = np.stack([b1, b2], axis=1)
        n_state = (nw + 1) * 3 + 2 + 1
        A = np.zeros((n_state, n_state))
        bb = np.zeros(n_state)
        for k in range(nw):
            pre = pres_h[k + 1]
            dt = float(pre["dt_sum"])
            Ri, Rj = R_bl[k], R_bl[k + 1]
            tmp_A = np.zeros((6, 9))
            tmp_b = np.zeros(6)
            tmp_A[0:3, 0:3] = -dt * np.eye(3)
            tmp_A[0:3, 6:8] = 0.5 * Ri.T @ basis * dt * dt
            tmp_A[0:3, 8] = Ri.T @ (p_cl[k + 1] - p_cl[k]) / 100.0
            tmp_b[0:3] = pre["alpha"] + Ri.T @ Rj @ p_bc - p_bc - 0.5 * Ri.T @ g * dt * dt
            tmp_A[3:6, 0:3] = -np.eye(3)
            tmp_A[3:6, 3:6] = Ri.T @ Rj
            tmp_A[3:6, 6:8] = Ri.T @ basis * dt
            tmp_b[3:6] = pre["beta"] - Ri.T @ g * dt
            idx = np.concatenate([np.arange(k * 3, k * 3 + 6), np.arange((nw + 1) * 3, n_state)])
            A[np.ix_(idx, idx)] += tmp_A.T @ tmp_A
            bb[idx] += tmp_A.T @ tmp_b
        A *= 1000.0
        bb *= 1000.0
        x = np.linalg.solve(A, bb)
        dg = basis @ x[(nw + 1) * 3: (nw + 1) * 3 + 2]
        g = (g + dg) / np.linalg.norm(g + dg) * gn
        s = x[-1] / 100.0
        vels = x[: (nw + 1) * 3].reshape(nw + 1, 3)
    if s is None or s < 1e-4:
        return None, None, None
    return g, s, vels


# ----------------------------------------------------- extrinsic calibration
def calibrate_extrinsic_rotation(q_cam_deltas, q_imu_deltas):
    """`InitialEXRotation::CalibrationExRotation`: hand-eye quaternion least
    squares for R_bc; returns (q_bc [wxyz], ok) — ok when the second-smallest
    singular value is well separated (enough rotational excitation)."""
    rows = []
    for qi, qc in zip(q_imu_deltas, q_cam_deltas):
        w, x, y, z = [float(v) for v in qi]
        L = np.array([[w, -x, -y, -z], [x, w, -z, y], [y, z, w, -x], [z, -y, x, w]])
        w, x, y, z = [float(v) for v in qc]
        R = np.array([[w, -x, -y, -z], [x, w, z, -y], [y, -z, w, x], [z, y, -x, w]])
        rows.append(L - R)
    _, S, Vt = np.linalg.svd(np.concatenate(rows, axis=0))
    q = Vt[-1]
    if q[0] < 0:
        q = -q
    ok = len(q_imu_deltas) >= 8 and S[-2] > 0.25
    return q / np.linalg.norm(q), bool(ok)


def _alignment_residual(est, p_cl, q_bl, g, s, vels, pres_h):
    """Mean squared residual of the linear-alignment equations at the solved
    (g, s, velocities) — the SFM↔IMU consistency score of a candidate."""
    nw = est.cfg.window_size
    p_bc = est.p_bc
    R_bl = qnp.quat_to_rot(q_bl)
    total = 0.0
    n = 0
    for k in range(nw):
        pre = pres_h[k + 1]
        if pre is None:
            return np.inf
        dt = float(pre["dt_sum"])
        Ri, Rj = R_bl[k], R_bl[k + 1]
        r_p = (pre["alpha"] + Ri.T @ Rj @ p_bc - p_bc
               - Ri.T @ (s * (p_cl[k + 1] - p_cl[k])) + vels[k] * dt - 0.5 * Ri.T @ g * dt * dt)
        r_v = pre["beta"] - Ri.T @ Rj @ vels[k + 1] + vels[k] - Ri.T @ g * dt
        total += float(r_p @ r_p + r_v @ r_v)
        n += 6
    return total / max(n, 1)


def _repropagate(est, bg):
    for k in range(1, est.cfg.window_size + 1):
        buf = est.imu_bufs[k]
        if buf.seeded and len(buf.dt) > 0:
            est.pres[k] = est.preintegrate_buffer(buf, np.zeros(3), bg)


# ----------------------------------------------------------------- top level
def try_initialize(est) -> bool:
    """`initialStructure()` + `visualInitialAlign()`."""
    nw = est.cfg.window_size
    rel = _relative_pose(est)
    if rel is None:
        return False
    l, R_nl, t_nl = rel
    cands, mean_err = _sfm(est, l, R_nl, t_nl)
    if mean_err > 10.0:
        return False

    p_bc = np.asarray(est.p_bc, np.float64)
    q_cb = qnp.quat_conj(est.q_bc)
    # Score each SFM candidate (refined gauge first, double-pinned bootstrap
    # second) by how consistently the IMU alignment explains it; the refined
    # gauge only wins with a decisively better score.
    pres0 = list(est.pres)  # zero-bias preintegrations (gyro solve is relative)
    pres0_h = _pres_host(est)
    best = None
    for ci, (p_c, q_c, inv_depth, pt_ok) in enumerate(cands):
        est.pres = list(pres0)
        q_bl = qnp.quat_mul(q_c, q_cb[None, :])
        p_bl = p_c + qnp.quat_rotate(q_bl, np.broadcast_to(-p_bc, (nw + 1, 3)))
        bg = _solve_gyro_bias(est, q_bl, pres0_h)
        if np.linalg.norm(bg) > 1.0:
            continue
        _repropagate(est, bg)
        pres_h = _pres_host(est)
        out = _linear_alignment(est, p_c, q_bl, pres_h)
        if out is None:
            continue
        g_cl_c, s_c, vels_c = out
        if np.median(np.linalg.norm(vels_c, axis=1)) > MAX_INIT_VELOCITY:
            continue
        score = _alignment_residual(est, p_c, q_bl, g_cl_c, s_c, vels_c, pres_h)
        if ci == 0:
            score = score / PREFER_REFINED_FACTOR
        if best is None or score < best[0]:
            best = (score, p_c, q_c, inv_depth, pt_ok, q_bl, p_bl, bg, g_cl_c, s_c, vels_c)

    if best is None:
        return False
    _, p_c, q_c, inv_depth, pt_ok, q_bl, p_bl, bg, g_cl, s, vels_body = best
    est.bg[:] = bg
    _repropagate(est, bg)  # leave preintegrations repropagated with the winning bg

    # ---- visualInitialAlign: rescale + rotate world to gravity-aligned frame
    p_m = s * p_bl
    p_m = p_m - p_m[0]
    R0 = gravity_to_rot(torch.as_tensor(g_cl, dtype=torch.float64)).numpy()
    yaw0 = float(qnp.rot_to_ypr(R0 @ qnp.quat_to_rot(q_bl[0]))[0])
    R0 = qnp.ypr_to_rot(np.array([-yaw0, 0.0, 0.0])) @ R0
    for k in range(nw + 1):
        R_bk = qnp.quat_to_rot(q_bl[k])
        est.p[k] = R0 @ p_m[k]
        est.q[k] = qnp.rot_to_quat(R0 @ R_bk)
        est.v[k] = R0 @ (R_bk @ vels_body[k])
        est.ba[k] = 0.0
        est.bg[k] = bg

    tbl = est.pt_table
    tbl.inv_depth[:] = -1.0
    solved = pt_ok & (inv_depth > 0)
    tbl.inv_depth[solved] = inv_depth[solved] / s
    est.ln_table.solved[:] = False  # lines re-triangulate in the metric frame
    return True
