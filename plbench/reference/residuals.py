"""Stacked whitened residuals for the sliding-window visual-inertial BA.

Counterpart of `plslam/models/residuals.py` (the reference's Ceres cost
functions: IMU, point projection with td + rolling shutter, the three line
parameterizations, relocalization and marginalization prior). Every
(feature × frame) slot evaluates unconditionally and a 0/1 mask zeroes the
inactive ones, so shapes never change. Jacobians come from one
`torch.func.jacfwd` of this stack through the manifold retraction.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from plbench.reference.state import TangentLayout, WindowState, box_minus_cam, cam_poses
from plbench.reference import imu as imu_ops
from plbench.reference.lines import line_projection_residual, plucker_transform
from plbench.reference.geometry import pose_inverse, quat_conj, quat_mul, quat_rotate, quat_to_rot


class WindowFactors(NamedTuple):
    """All measurements bound to the current window (fixed shapes)."""

    imu_alpha: torch.Tensor  # [W,3]
    imu_beta: torch.Tensor  # [W,3]
    imu_gamma: torch.Tensor  # [W,4]
    imu_jac: torch.Tensor  # [W,15,15]
    imu_sqrt_info: torch.Tensor  # [W,15,15]
    imu_dt: torch.Tensor  # [W]
    imu_ba: torch.Tensor  # [W,3] linearization biases
    imu_bg: torch.Tensor  # [W,3]
    imu_valid: torch.Tensor  # [W] float 0/1
    g: torch.Tensor  # [3] gravity (+z·9.81)
    pt_obs: torch.Tensor  # [MAX_F,NW,2] normalized coords
    pt_vel: torch.Tensor  # [MAX_F,NW,2] normalized-coord velocity (for td)
    pt_td_ref: torch.Tensor  # [NW] td used by the IMU pairing of each frame
    pt_rowf: torch.Tensor  # [MAX_F,NW] image-row fraction (rolling shutter)
    rs_tr: torch.Tensor  # [] rolling-shutter line-delay total (s)
    pt_mask: torch.Tensor  # [MAX_F,NW] float 0/1 observed
    pt_start: torch.Tensor  # [MAX_F] int first observing frame
    pt_valid: torch.Tensor  # [MAX_F] float 0/1 active+triangulated
    ln_obs: torch.Tensor  # [MAX_L,NW,4] normalized (sx,sy,ex,ey)
    ln_mask: torch.Tensor  # [MAX_L,NW] float 0/1
    ln_valid: torch.Tensor  # [MAX_L] float 0/1
    ln_start: torch.Tensor  # [MAX_L] int first observing frame
    relo_obs: torch.Tensor  # [MAX_F,2] normalized obs of window features in the old kf
    relo_mask: torch.Tensor  # [MAX_F] float 0/1 matched
    relo_valid: torch.Tensor  # [] float 0/1
    prior_J: torch.Tensor  # [DC,DC]
    prior_r0: torch.Tensor  # [DC]
    prior_valid: torch.Tensor  # [] float 0/1
    prior_p: torch.Tensor  # [NW,3] FEJ snapshot (camera-side state only)
    prior_q: torch.Tensor  # [NW,4]
    prior_v: torch.Tensor  # [NW,3]
    prior_ba: torch.Tensor  # [NW,3]
    prior_bg: torch.Tensor  # [NW,3]
    prior_p_bc: torch.Tensor  # [3]
    prior_q_bc: torch.Tensor  # [4]
    prior_td: torch.Tensor  # []


def empty_factors(cfg, lay: TangentLayout, dtype=torch.float32, device=None) -> WindowFactors:
    W, NW, MF, ML, DC = lay.nw - 1, lay.nw, lay.max_f, lay.max_l, lay.dim_cam
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    zi = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)  # noqa: E731
    unit = lambda n: torch.cat([torch.ones((n, 1), dtype=dtype, device=device),  # noqa: E731
                                torch.zeros((n, 3), dtype=dtype, device=device)], dim=1)
    eye = torch.eye(15, dtype=dtype, device=device).expand(W, 15, 15).clone()
    # made by fills on the device: a host list copied there waits for its queue
    g = torch.cat([z(2), torch.full((1,), 9.81007, dtype=dtype, device=device)])
    return WindowFactors(
        imu_alpha=z(W, 3), imu_beta=z(W, 3), imu_gamma=unit(W), imu_jac=eye,
        imu_sqrt_info=eye.clone(), imu_dt=z(W), imu_ba=z(W, 3), imu_bg=z(W, 3),
        imu_valid=z(W), g=g,
        pt_obs=z(MF, NW, 2), pt_vel=z(MF, NW, 2), pt_td_ref=z(NW), pt_rowf=z(MF, NW),
        rs_tr=z(), pt_mask=z(MF, NW), pt_start=zi(MF), pt_valid=z(MF),
        ln_obs=z(ML, NW, 4), ln_mask=z(ML, NW), ln_valid=z(ML), ln_start=zi(ML),
        relo_obs=z(MF, 2), relo_mask=z(MF), relo_valid=z(),
        prior_J=z(DC, DC), prior_r0=z(DC), prior_valid=z(),
        prior_p=z(NW, 3), prior_q=unit(NW), prior_v=z(NW, 3), prior_ba=z(NW, 3),
        prior_bg=z(NW, 3), prior_p_bc=z(3), prior_q_bc=unit(1)[0], prior_td=z(),
    )


def _prior_state(f: WindowFactors, state: WindowState) -> WindowState:
    return state._replace(
        p=f.prior_p, q=f.prior_q, v=f.prior_v, ba=f.prior_ba, bg=f.prior_bg,
        p_bc=f.prior_p_bc, q_bc=f.prior_q_bc, td=f.prior_td,
    )


def imu_residuals(state: WindowState, f: WindowFactors) -> torch.Tensor:
    """[W,15] whitened IMU residuals (`IMUFactor::Evaluate`), all intervals at once."""
    pre = imu_ops.Preintegration(
        alpha=f.imu_alpha, beta=f.imu_beta, gamma=f.imu_gamma, jac=f.imu_jac,
        cov=f.imu_jac, dt_sum=f.imu_dt, ba=f.imu_ba, bg=f.imu_bg,
    )
    r = imu_ops.imu_residual(
        state.p[:-1], state.q[:-1], state.v[:-1], state.ba[:-1], state.bg[:-1],
        state.p[1:], state.q[1:], state.v[1:], state.ba[1:], state.bg[1:], pre, f.g,
    )
    return torch.einsum("kij,kj->ki", f.imu_sqrt_info, r) * f.imu_valid[:, None]


def _z_safe(z):
    return torch.where(torch.abs(z) < 1e-5, torch.sign(z) * 1e-5 + (z == 0) * 1e-5, z)


def _world_points(state: WindowState, f: WindowFactors) -> torch.Tensor:
    """[MF,3] world positions of all point features (anchor frame + inverse depth)."""
    start = f.pt_start.long()
    rows = torch.arange(start.shape[0], device=start.device)
    u_i = f.pt_obs[rows, start]  # [MF,2]
    v_i = f.pt_vel[rows, start]
    rowf_i = f.pt_rowf[rows, start]
    # td + rolling-shutter row-delay shift of the anchor observation
    td_ref_i = f.pt_td_ref[start]
    u_i = u_i - (state.td - td_ref_i + f.rs_tr * rowf_i)[:, None] * v_i
    inv = state.inv_depth
    depth = 1.0 / torch.where(torch.abs(inv) > 1e-6, inv, torch.full_like(inv, 1e-6))
    p_ci = torch.cat([u_i, torch.ones_like(u_i[:, :1])], dim=-1) * depth[:, None]
    q_i = state.q[start]
    p_i = state.p[start]
    p_b = quat_rotate(state.q_bc.expand_as(q_i), p_ci) + state.p_bc
    return quat_rotate(q_i, p_b) + p_i


def point_residuals(state: WindowState, f: WindowFactors, focal: float) -> torch.Tensor:
    """[MAX_F,NW,2] whitened point reprojection residuals
    (`ProjectionFactor` / `ProjectionTdFactor`), all slots in one batch."""
    NW = state.p.shape[0]
    dtype = state.p.dtype
    start = f.pt_start.long()
    p_w = _world_points(state, f)  # [MF,3]
    p_cb, q_cb = pose_inverse(state.p_bc, state.q_bc)
    # x_cj = R_bc^T (R_wb_j^T (x_w − p_j) − p_bc)
    x_bj = quat_rotate(quat_conj(state.q)[None], p_w[:, None, :] - state.p[None])
    p_cj = quat_rotate(q_cb.expand(1, 1, 4), x_bj) + p_cb  # [MF,NW,3]
    pred = p_cj[..., 0:2] / _z_safe(p_cj[..., 2:3])
    u_j = f.pt_obs - (state.td - f.pt_td_ref[None, :] + f.rs_tr * f.pt_rowf)[..., None] * f.pt_vel
    r = pred - u_j
    not_anchor = (torch.arange(NW, device=start.device)[None, :] != start[:, None]).to(dtype)
    m = f.pt_mask * not_anchor * f.pt_valid[:, None]
    m = m * (p_cj[..., 2] > 1e-3).to(dtype)  # behind-camera guard
    return r * m[..., None] * (focal / 1.5)


def _anchor_pose(state: WindowState, ln_start, line_param: str):
    start = ln_start.long()
    q_a = state.q[start]
    p_a = state.p[start]
    if line_param == "incamera":
        q_a = quat_mul(q_a, state.q_bc.expand_as(q_a))
        p_a = p_a + quat_rotate(state.q[start], state.p_bc.expand_as(p_a))
    elif line_param != "instartframe":
        raise ValueError(f"unknown line_param {line_param!r}")
    return p_a, q_a


def lines_to_world(state: WindowState, ln_start, line_param: str) -> torch.Tensor:
    """[ML,6] world Plücker lines from the chart `line_param` stores
    ("world", "incamera" or "instartframe")."""
    if line_param == "world":
        return state.line
    p_a, q_a = _anchor_pose(state, ln_start, line_param)
    return plucker_transform(state.line, quat_to_rot(q_a), p_a)


def lines_from_world(state: WindowState, line_w, ln_start, line_param: str) -> torch.Tensor:
    """Inverse of `lines_to_world`."""
    if line_param == "world":
        return line_w
    p_a, q_a = _anchor_pose(state, ln_start, line_param)
    p_aw, q_aw = pose_inverse(p_a, q_a)
    return plucker_transform(line_w, quat_to_rot(q_aw), p_aw)


def line_residuals(state: WindowState, f: WindowFactors, focal: float,
                   line_param: str = "world") -> torch.Tensor:
    """[MAX_L,NW,2] whitened line residuals (`lineProjectionFactor::Evaluate`)."""
    p_wc, q_wc = cam_poses(state)
    p_cw, q_cw = pose_inverse(p_wc, q_wc)
    R_cw = quat_to_rot(q_cw)  # [NW,3,3]
    L_w = lines_to_world(state, f.ln_start, line_param)
    L_c = plucker_transform(L_w[:, None, :], R_cw[None], p_cw[None])  # [ML,NW,6]
    r = line_projection_residual(L_c, f.ln_obs[..., 0:2], f.ln_obs[..., 2:4])
    m = f.ln_mask * f.ln_valid[:, None]
    return r * m[..., None] * (focal / 1.5)


def relo_residuals(state: WindowState, f: WindowFactors, focal: float) -> torch.Tensor:
    """[MAX_F,2] whitened relocalization residuals against an old keyframe."""
    dtype = state.p.dtype
    p_w = _world_points(state, f)
    q_wc = quat_mul(state.relo_q, state.q_bc)
    p_wc = state.relo_p + quat_rotate(state.relo_q, state.p_bc)
    p_cw, q_cw = pose_inverse(p_wc, q_wc)
    x_c = quat_rotate(q_cw.expand(p_w.shape[0], 4), p_w) + p_cw
    pred = x_c[:, 0:2] / _z_safe(x_c[:, 2:3])
    r = pred - f.relo_obs
    m = f.relo_mask * f.pt_valid * f.relo_valid * (x_c[:, 2] > 1e-3).to(dtype)
    return r * m[:, None] * (focal / 1.5)


def prior_residual(state: WindowState, f: WindowFactors, lay: TangentLayout) -> torch.Tensor:
    """[DC] marginalization prior residual r₀ + J₀·(x ⊟ x₀)."""
    dx = box_minus_cam(state, _prior_state(f, state), lay)
    return (f.prior_r0 + f.prior_J @ dx) * f.prior_valid


def residual_stack(state, f, lay, focal, pt_w=None, ln_w=None, relo_w=None,
                   line_param: str = "world") -> torch.Tensor:
    """Full whitened residual vector; `pt_w`/`ln_w`/`relo_w` are IRLS √Cauchy
    weights held constant during linearization."""
    return stack_of_groups(residual_groups(state, f, lay, focal, line_param), pt_w, ln_w, relo_w)


def cauchy_weights(r2, c: float):
    """√(ρ'(s)) for Cauchy loss ρ(s)=c²·log(1+s/c²) (Ceres `CauchyLoss(c)`)."""
    return 1.0 / torch.sqrt(1.0 + r2 / (c * c))


def residual_groups(state, f, lay, focal, line_param: str = "world"):
    """All residual groups at `state`, vision parts UNWEIGHTED:
    (r_prior [DC], r_imu [W·15], r_pt [MF,NW,2], r_ln [ML,NW,2], r_relo [MF,2])."""
    return (
        prior_residual(state, f, lay),
        imu_residuals(state, f).reshape(-1),
        point_residuals(state, f, focal),
        line_residuals(state, f, focal, line_param),
        relo_residuals(state, f, focal),
    )


def weights_of_groups(groups, cauchy_c: float):
    """IRLS √Cauchy weights from unweighted residual groups."""
    _, _, r_pt, r_ln, r_relo = groups
    return (cauchy_weights(torch.sum(r_pt * r_pt, dim=-1), cauchy_c),
            cauchy_weights(torch.sum(r_ln * r_ln, dim=-1), cauchy_c),
            cauchy_weights(torch.sum(r_relo * r_relo, dim=-1), cauchy_c))


def robust_cost_of_groups(groups, cauchy_c: float):
    """The true robust objective (Ceres' total cost): ½‖r_prior‖² + ½‖r_imu‖²
    + ½Σ ρ(‖r‖²) with Cauchy ρ on the vision terms."""
    r_pr, r_imu, r_pt, r_ln, r_relo = groups
    c2 = cauchy_c * cauchy_c
    rho = lambda r2: c2 * torch.log1p(r2 / c2)  # noqa: E731
    return 0.5 * (
        torch.sum(r_pr * r_pr) + torch.sum(r_imu * r_imu)
        + torch.sum(rho(torch.sum(r_pt * r_pt, dim=-1)))
        + torch.sum(rho(torch.sum(r_ln * r_ln, dim=-1)))
        + torch.sum(rho(torch.sum(r_relo * r_relo, dim=-1)))
    )


def stack_of_groups(groups, pt_w=None, ln_w=None, relo_w=None):
    """Weighted residual stack from unweighted groups:
    [prior DC | imu W·15 | pt MF·NW·2 | ln ML·NW·2 | relo MF·2]."""
    r_pr, r_imu, r_pt, r_ln, r_relo = groups
    if pt_w is not None:
        r_pt = r_pt * pt_w[..., None]
    if ln_w is not None:
        r_ln = r_ln * ln_w[..., None]
    if relo_w is not None:
        r_relo = r_relo * relo_w[:, None]
    return torch.cat([r_pr, r_imu, r_pt.reshape(-1), r_ln.reshape(-1), r_relo.reshape(-1)])


def robust_weights(state, f, focal, cauchy_c: float, line_param: str = "world"):
    """Per-observation IRLS weights from the current (unweighted) residuals."""
    groups = (None, None, point_residuals(state, f, focal),
              line_residuals(state, f, focal, line_param), relo_residuals(state, f, focal))
    return weights_of_groups(groups, cauchy_c)
