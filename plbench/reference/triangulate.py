"""Batched masked triangulation for points (DLT) and lines (two-plane).

Counterpart of `plslam/models/triangulate.py` (`FeatureManager::triangulate`
and `triangulateLine`): every slot triangulates in one batched SVD / einsum
over the fixed table; masks decide which results are committed.
"""
from __future__ import annotations

import math

import torch

from plbench.reference.lines import plane_from_cam_segment, plucker_from_planes
from plbench.reference.geometry import pose_inverse, quat_to_rot


def triangulate_points(p_wc, q_wc, obs, mask, start):
    """DLT triangulation of every feature slot.

    p_wc, q_wc: [NW,3]/[NW,4] world_T_cam; obs [MF,NW,2] normalized;
    mask [MF,NW] 0/1; start [MF]. Returns inv_depth [MF] in the anchor camera
    and ok [MF] bool (anchor z > 0.1 and ≥ 2 observations)."""
    p_cw, q_cw = pose_inverse(p_wc, q_wc)
    R_cw = quat_to_rot(q_cw)  # [NW,3,3]
    P = torch.cat([R_cw, p_cw[:, :, None]], dim=-1)  # [NW,3,4]
    u = obs[..., 0][..., None]
    v = obs[..., 1][..., None]
    row_u = u * P[None, :, 2, :] - P[None, :, 0, :]  # [MF,NW,4]
    row_v = v * P[None, :, 2, :] - P[None, :, 1, :]
    A = torch.cat([row_u, row_v], dim=1) * torch.cat([mask, mask], dim=1)[..., None]
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    X = Vh[:, -1, :]  # [MF,4] homogeneous world point
    w = X[:, 3]
    w_safe = torch.where(torch.abs(w) > 1e-10, w, torch.full_like(w, 1e-10))
    xw = X[:, 0:3] / w_safe[:, None]

    start = start.long()
    z = torch.einsum("mi,mi->m", R_cw[start][:, 2, :], xw) + p_cw[start][:, 2]
    ok = (z > 0.1) & (torch.sum(mask, dim=1) >= 2)
    inv_depth = torch.where(ok, 1.0 / torch.clamp(z, min=0.1), torch.full_like(z, 1.0 / 5.0))
    return inv_depth, ok


def triangulate_lines(p_wc, q_wc, obs, mask, start):
    """Two-plane triangulation of every line slot. Partner frame = the
    observing frame whose camera center is farthest from the anchor's.
    Gates: ≥ 2 cm baseline, plane angle > 2°, well-defined direction.
    Returns line_w [ML,6] world Plücker (‖v‖ = 1), ok [ML] bool."""
    R_wc = quat_to_rot(q_wc)
    start = start.long()
    rows = torch.arange(obs.shape[0], device=obs.device)
    Ra, pa = R_wc[start], p_wc[start]
    sa = obs[rows, start]  # [ML,4]

    base = torch.linalg.norm(p_wc[None, :, :] - pa[:, None, :], dim=-1)  # [ML,NW]
    is_anchor = torch.arange(p_wc.shape[0], device=obs.device)[None, :] == start[:, None]
    score = torch.where((mask > 0) & ~is_anchor, base, torch.full_like(base, -1.0))
    partner = torch.argmax(score, dim=1)
    has_partner = torch.max(score, dim=1).values > 0.02

    Rp, pp = R_wc[partner], p_wc[partner]
    sp = obs[rows, partner]
    pi1 = plane_from_cam_segment(Ra, pa, sa[:, 0:2], sa[:, 2:4])
    pi2 = plane_from_cam_segment(Rp, pp, sp[:, 0:2], sp[:, 2:4])
    L = plucker_from_planes(pi1, pi2)

    n1 = pi1[:, 0:3] / torch.clamp(torch.linalg.norm(pi1[:, 0:3], dim=-1, keepdim=True), min=1e-12)
    n2 = pi2[:, 0:3] / torch.clamp(torch.linalg.norm(pi2[:, 0:3], dim=-1, keepdim=True), min=1e-12)
    angle_ok = torch.abs(torch.sum(n1 * n2, dim=-1)) < math.cos(math.radians(2.0))
    v_norm = torch.linalg.norm(L[:, 3:6], dim=-1)
    ok = has_partner & angle_ok & (v_norm > 1e-6)
    return L / torch.clamp(v_norm[:, None], min=1e-9), ok
