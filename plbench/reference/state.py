"""Sliding-window state as a NamedTuple of tensors + its manifold structure.

Counterpart of `plslam/models/state.py`. One global tangent vector δ ∈ R^D
with the layout
  [ pose δ(p,θ) NW×6 | speed/bias NW×9 | extrinsic 6 | td 1 | relo 6 |
    inverse depths MAX_F | line-orth MAX_L×4 ]
and `retract` applying the reference's local parameterisations.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from plbench.reference.config import SolverConfig
from plbench.reference.lines import orth_retract
from plbench.reference.geometry import quat_box_minus, quat_box_plus, quat_mul, quat_rotate


class WindowState(NamedTuple):
    p: torch.Tensor  # [NW,3] body position in world
    q: torch.Tensor  # [NW,4] body orientation (wxyz), R_wb
    v: torch.Tensor  # [NW,3] velocity in world
    ba: torch.Tensor  # [NW,3] accel bias
    bg: torch.Tensor  # [NW,3] gyro bias
    p_bc: torch.Tensor  # [3] extrinsic: body_T_cam translation
    q_bc: torch.Tensor  # [4] extrinsic rotation
    td: torch.Tensor  # [] camera-IMU time offset
    relo_p: torch.Tensor  # [3] relocalization pose (old keyframe body in world)
    relo_q: torch.Tensor  # [4]
    inv_depth: torch.Tensor  # [MAX_F] inverse depth in first observing frame
    line: torch.Tensor  # [MAX_L,6] world-frame Plücker lines


class TangentLayout(NamedTuple):
    nw: int
    max_f: int
    max_l: int
    off_pose: int
    off_sb: int
    off_ext: int
    off_td: int
    off_relo: int
    off_depth: int
    off_line: int
    dim: int
    dim_cam: int  # pose-side dim (poses+sb+ext+td+relo) — the Schur "camera" block


def layout(cfg: SolverConfig) -> TangentLayout:
    nw = cfg.window_size + 1
    off_pose = 0
    off_sb = off_pose + nw * 6
    off_ext = off_sb + nw * 9
    off_td = off_ext + 6
    off_relo = off_td + 1
    off_depth = off_relo + 6
    off_line = off_depth + cfg.max_features
    dim = off_line + cfg.max_line_feats * 4
    return TangentLayout(nw, cfg.max_features, cfg.max_line_feats,
                         off_pose, off_sb, off_ext, off_td, off_relo, off_depth, off_line,
                         dim, off_depth)


def _unit_quats(n, dtype, device):
    q = torch.zeros((n, 4), dtype=dtype, device=device)
    q[:, 0] = 1.0
    return q


def zero_state(cfg: SolverConfig, dtype=torch.float32, device=None) -> WindowState:
    nw = cfg.window_size + 1
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return WindowState(
        p=z(nw, 3), q=_unit_quats(nw, dtype, device), v=z(nw, 3), ba=z(nw, 3), bg=z(nw, 3),
        p_bc=z(3), q_bc=_unit_quats(1, dtype, device)[0], td=z(),
        relo_p=z(3), relo_q=_unit_quats(1, dtype, device)[0],
        inv_depth=torch.full((cfg.max_features,), 0.2, dtype=dtype, device=device),
        line=default_lines(cfg.max_line_feats, dtype, device),
    )


def default_lines(max_l, dtype, device=None):
    """Benign, well-conditioned placeholder lines: n = (0,5,0), v = (0,0,1)."""
    L = torch.zeros((max_l, 6), dtype=dtype, device=device)
    L[:, 1] = 5.0
    L[:, 5] = 1.0
    return L


def retract(state: WindowState, delta: torch.Tensor, lay: TangentLayout) -> WindowState:
    """x ⊞ δ with the reference's local parameterisations."""
    nw = lay.nw
    dp = delta[lay.off_pose: lay.off_sb].reshape(nw, 6)
    dsb = delta[lay.off_sb: lay.off_ext].reshape(nw, 9)
    dext = delta[lay.off_ext: lay.off_td]
    dtd = delta[lay.off_td]
    drelo = delta[lay.off_relo: lay.off_depth]
    ddep = delta[lay.off_depth: lay.off_line]
    dline = delta[lay.off_line:].reshape(lay.max_l, 4)
    return WindowState(
        p=state.p + dp[:, 0:3],
        q=quat_box_plus(state.q, dp[:, 3:6]),
        v=state.v + dsb[:, 0:3],
        ba=state.ba + dsb[:, 3:6],
        bg=state.bg + dsb[:, 6:9],
        p_bc=state.p_bc + dext[0:3],
        q_bc=quat_box_plus(state.q_bc, dext[3:6]),
        td=state.td + dtd,
        relo_p=state.relo_p + drelo[0:3],
        relo_q=quat_box_plus(state.relo_q, drelo[3:6]),
        inv_depth=state.inv_depth + ddep,
        line=orth_retract(state.line, dline),
    )


def box_minus_cam(state: WindowState, state0: WindowState, lay: TangentLayout) -> torch.Tensor:
    """(x ⊟ x0) restricted to the camera-side dims — the prior residual's argument."""
    pose = torch.cat([state.p - state0.p, quat_box_minus(state.q, state0.q)], dim=-1).reshape(-1)
    sb = torch.cat([state.v - state0.v, state.ba - state0.ba, state.bg - state0.bg],
                   dim=-1).reshape(-1)
    ext = torch.cat([state.p_bc - state0.p_bc, quat_box_minus(state.q_bc, state0.q_bc)])
    td = (state.td - state0.td).reshape(1)
    relo = torch.cat([state.relo_p - state0.relo_p, quat_box_minus(state.relo_q, state0.relo_q)])
    return torch.cat([pose, sb, ext, td, relo])


def cam_poses(state: WindowState):
    """World_T_cam for each window frame: R_wc = R_wb R_bc, p_wc = p + R_wb p_bc."""
    q_wc = quat_mul(state.q, state.q_bc[None, :])
    p_wc = state.p + quat_rotate(state.q, state.p_bc.expand_as(state.p))
    return p_wc, q_wc


def where_state(cond, a: WindowState, b: WindowState) -> WindowState:
    """Field-wise select (the LM accept / reject)."""
    return WindowState(*[torch.where(cond, x, y) for x, y in zip(a, b)])
