"""Batched damped Gauss-Newton / LM solver with landmark Schur elimination.

A frozen copy of the port's `models/solver.py` (its `linearize_blocks` path
only), the counterpart of `plslam/models/solver.py` (the reference's
`Estimator::optimization()` DENSE_SCHUR solve, ≤8 iterations):

  * one `torch.func.jacfwd` through the manifold retraction linearises every
    factor at once, over the camera dims plus 5 structured landmark
    directions (`linearize_blocks`);
  * the normal-equation blocks are assembled by einsum in Schur layout;
  * landmarks (scalar inverse depths, 4×4 line blocks) are eliminated in
    closed form, leaving a DC×DC reduced camera system solved by Cholesky;
  * the LM loop is a Python loop whose accept / reject is a `torch.where`,
    so nothing is read back to the host inside it;
  * the solution is re-anchored post-solve (frame-0 position and yaw).

A failed Cholesky gives NaN here, as in JAX: the step's cost is then NaN and
the step is rejected (`cholesky_ex`, never the raising variant, which would
also synchronise with the host on a GPU).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from plbench.reference.config import SolverConfig
from plbench.reference import residuals as res
from plbench.reference.state import TangentLayout, WindowState, retract, where_state
from plbench.reference.imu import cholesky
from plbench.reference.lines import plucker_transform
from plbench.reference.geometry import quat_mul, quat_to_rot, rot_to_quat, rot_to_ypr, ypr_to_rot


class SolveStats(NamedTuple):
    cost0: torch.Tensor
    cost: torch.Tensor
    lam: torch.Tensor
    accepted: torch.Tensor  # number of accepted steps
    cost_robust0: torch.Tensor
    cost_robust: torch.Tensor
    # unweighted residual groups at the FINAL state (reused by marginalize_old)
    groups: tuple


def free_mask(f: res.WindowFactors, lay: TangentLayout, cfg: SolverConfig,
              estimate_extrinsic: bool, estimate_td: bool,
              freeze_frames: tuple = (), extra_pinned: tuple = ()) -> torch.Tensor:
    """0/1 mask over tangent dims: which deltas the solver may move."""
    dtype, device = f.g.dtype, f.g.device
    one = lambda n: torch.ones(n, dtype=dtype, device=device)  # noqa: E731
    pose = one((lay.nw, 6))
    for k in freeze_frames:
        pose[k] = 0.0
    parts = [
        pose.reshape(-1),
        one(lay.nw * 9),
        one(6) * float(bool(estimate_extrinsic)),
        one(1) * float(bool(estimate_td)),
        f.relo_valid.reshape(1).expand(6).to(dtype),
        f.pt_valid.to(dtype),
        f.ln_valid.to(dtype)[:, None].expand(-1, 4).reshape(-1),
    ]
    m = torch.cat(parts)
    if extra_pinned:
        keep = one(lay.dim)
        keep[list(extra_pinned)] = 0.0
        m = m * keep
    return m


def linearize_blocks(state, f, lay: TangentLayout, focal, pt_w, ln_w, mask,
                     relo_w=None, line_param="world"):
    """Structured linearization — the production path.

    Residual slot (feature f, frame j) depends only on λ_f among the
    landmark dims (and a line slot only on its own 4 orth dims), so the
    tangent space compresses to DC+5 directions: the DC camera dims, the
    all-depths direction and one direction per line-orth component. ONE
    jacfwd yields J_cam and both landmark jacobians as columns.

    Returns (r0, J_cam [N,DC], blocks) with blocks =
    (B_d [DC,MF], d [MF], b_d [MF], B_l [DC,ML,4], Cb [ML,4,4], b_l [ML,4])."""
    DC, MF, ML, NW = lay.dim_cam, lay.max_f, lay.max_l, lay.nw
    W = NW - 1
    mask_c = mask[:DC]
    mask_d = mask[DC: DC + MF]
    mask_l = mask[DC + MF:].reshape(ML, 4)

    def r_ext(de):
        delta = torch.cat([
            de[:DC] * mask_c,
            de[DC] * mask_d,
            (de[DC + 1:][None, :] * mask_l).reshape(-1),
        ])
        return res.residual_stack(retract(state, delta, lay), f, lay, focal,
                                  pt_w, ln_w, relo_w, line_param)

    zero_e = torch.zeros((DC + 5,), dtype=state.p.dtype, device=state.p.device)
    r0 = r_ext(zero_e)
    J_ext = torch.func.jacfwd(r_ext)(zero_e)  # [N,DC+5]
    J_cam = J_ext[:, :DC]

    o_pt = DC + W * 15
    o_ln = o_pt + MF * NW * 2
    o_re = o_ln + ML * NW * 2
    Jd_pt = J_ext[o_pt:o_ln, DC].reshape(MF, NW, 2)
    Jd_re = J_ext[o_re:, DC].reshape(MF, 2)
    J_ln = J_ext[o_ln:o_re, DC + 1:].reshape(ML, NW, 2, 4)
    Jc_pt = J_cam[o_pt:o_ln].reshape(MF, NW, 2, DC)
    Jc_ln = J_cam[o_ln:o_re].reshape(ML, NW, 2, DC)
    Jc_re = J_cam[o_re:].reshape(MF, 2, DC)
    r_pt = r0[o_pt:o_ln].reshape(MF, NW, 2)
    r_ln = r0[o_ln:o_re].reshape(ML, NW, 2)
    r_re = r0[o_re:].reshape(MF, 2)

    B_d = (torch.einsum("fjrd,fjr->df", Jc_pt, Jd_pt)
           + torch.einsum("frd,fr->df", Jc_re, Jd_re))
    d = torch.sum(Jd_pt * Jd_pt, dim=(1, 2)) + torch.sum(Jd_re * Jd_re, dim=1)
    b_d = torch.sum(Jd_pt * r_pt, dim=(1, 2)) + torch.sum(Jd_re * r_re, dim=1)
    B_l = torch.einsum("ljrd,ljrk->dlk", Jc_ln, J_ln)
    Cb = torch.einsum("ljrk,ljrm->lkm", J_ln, J_ln)
    b_l = torch.einsum("ljrk,ljr->lk", J_ln, r_ln)
    return r0, J_cam, (B_d, d, b_d, B_l, Cb, b_l)


def _inv_spd(M):
    """Inverse of a batch of SPD matrices by Cholesky (NaN where it fails)."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand_as(M)
    return torch.cholesky_solve(eye, cholesky(M))


def _cho_solve(S, rhs):
    return torch.cholesky_solve(rhs[:, None], cholesky(S))[:, 0]


def _eliminate(A, Bd, Bl, b_c, b_d, b_l, d, Cb):
    """Closed-form landmark elimination + Cholesky on the reduced system.
    Returns the scaled steps (dc, dd, dl)."""
    Cb_inv = _inv_spd(Cb)
    BCd = Bd / d[None, :]
    BCl = torch.einsum("dma,mab->dmb", Bl, Cb_inv)
    S = A - BCd @ Bd.T - torch.einsum("dmb,emb->de", BCl, Bl)
    rhs = -b_c + BCd @ b_d + torch.einsum("dmb,mb->d", BCl, b_l)
    dc = _cho_solve(S, rhs)
    dd = (-b_d - Bd.T @ dc) / d
    dl = torch.einsum("mab,mb->ma", Cb_inv, -b_l - torch.einsum("dma,d->ma", Bl, dc))
    return dc, dd, dl


def schur_solve_blocks(r0, J_cam, blocks, lay: TangentLayout, lam, mask, eps=1e-8):
    """Solve the damped system from the pre-assembled Schur blocks: Jacobi
    column scaling, +λI damping in scaled variables, closed-form landmark
    elimination, Cholesky on the DC×DC reduced system."""
    DC, MF, ML = lay.dim_cam, lay.max_f, lay.max_l
    B_d, d_raw, b_d_raw, B_l, Cb_raw, b_l_raw = blocks
    H_cc = J_cam.T @ J_cam
    b_c_raw = J_cam.T @ r0

    diag = torch.cat([torch.diagonal(H_cc), d_raw,
                      torch.diagonal(Cb_raw, dim1=-2, dim2=-1).reshape(-1)])
    pin = 1.0 - mask
    scale = (1.0 / torch.sqrt(torch.clamp(diag, min=eps))) * mask
    sc_c = scale[:DC]
    sc_d = scale[DC: DC + MF]
    sc_l = scale[DC + MF:].reshape(ML, 4)
    damp = lam + eps

    A = H_cc * sc_c[:, None] * sc_c[None, :] + torch.diag(pin[:DC] + damp * mask[:DC])
    Bd = B_d * sc_c[:, None] * sc_d[None, :]
    Bl = B_l * sc_c[:, None, None] * sc_l[None, :, :]
    d = d_raw * sc_d * sc_d + pin[DC: DC + MF] + damp * mask[DC: DC + MF]
    Cb = Cb_raw * sc_l[:, :, None] * sc_l[:, None, :]
    Cb = Cb + torch.diag_embed(pin[DC + MF:].reshape(ML, 4) + damp * mask[DC + MF:].reshape(ML, 4))

    dc, dd, dl = _eliminate(A, Bd, Bl, b_c_raw * sc_c, b_d_raw * sc_d, b_l_raw * sc_l, d, Cb)
    delta = torch.cat([dc * sc_c, dd * sc_d, (dl * sc_l).reshape(-1)])
    return delta * mask


def cost_of(r):
    return 0.5 * torch.sum(r * r)


def lm_step(st, groups, lam, f, lay: TangentLayout, cfg: SolverConfig, mask):
    """One LM iteration of `optimize_window`: linearize at `st` with the
    IRLS weights of the carried groups (the UNWEIGHTED residuals at `st`,
    no re-evaluation), solve with damping `lam`, try the step and keep it if
    the cost falls. Returns (state, groups, λ after the step, accepted, the
    cost at the step's start, the trial cost)."""
    focal, lp = cfg.focal_length, cfg.line_param
    pt_w, ln_w, relo_w = res.weights_of_groups(groups, cfg.cauchy_c)
    r, J_cam, blocks = linearize_blocks(st, f, lay, focal, pt_w, ln_w, mask, relo_w, lp)
    delta = schur_solve_blocks(r, J_cam, blocks, lay, lam, mask)
    cost_here = cost_of(r)
    st_try = retract(st, delta, lay)
    groups_try = res.residual_groups(st_try, f, lay, focal, lp)
    cost_try = cost_of(res.stack_of_groups(groups_try, pt_w, ln_w, relo_w))
    accept = cost_try < cost_here
    st = where_state(accept, st_try, st)
    groups = tuple(torch.where(accept, a, c) for a, c in zip(groups_try, groups))
    lam_next = torch.where(accept, torch.clamp(lam * 0.4, min=cfg.lm_lambda_min),
                           torch.clamp(lam * 5.0, max=cfg.lm_lambda_max))
    return st, groups, lam_next, accept, cost_here, cost_try


def optimize_window(
    state: WindowState,
    f: res.WindowFactors,
    lay: TangentLayout,
    cfg: SolverConfig,
    estimate_extrinsic: bool = False,
    estimate_td: bool = False,
    num_iters: int = 8,
):
    """Run the windowed LM solve; returns (state', stats)
    (`Estimator::optimization()` equivalent), linearized by
    `linearize_blocks`."""
    focal = cfg.focal_length
    lp = cfg.line_param
    mask = free_mask(f, lay, cfg, estimate_extrinsic, estimate_td)

    groups0 = res.residual_groups(state, f, lay, focal, lp)
    pt_w0, ln_w0, relo_w0 = res.weights_of_groups(groups0, cfg.cauchy_c)
    cost0 = cost_of(res.stack_of_groups(groups0, pt_w0, ln_w0, relo_w0))

    st, groups = state, groups0
    lam = torch.full((), cfg.lm_lambda_init, dtype=state.p.dtype, device=state.p.device)
    cost = cost0
    naccept = torch.zeros((), dtype=torch.int32, device=state.p.device)
    for _ in range(num_iters):
        st, groups, lam, accept, cost_here, cost_try = lm_step(st, groups, lam, f, lay, cfg, mask)
        cost = torch.where(accept, cost_try, cost_here)
        naccept = naccept + accept.to(torch.int32)

    st = reanchor(st, state, line_param=lp)
    return st, SolveStats(
        cost0=cost0, cost=cost, lam=lam, accepted=naccept,
        cost_robust0=res.robust_cost_of_groups(groups0, cfg.cauchy_c),
        cost_robust=res.robust_cost_of_groups(groups, cfg.cauchy_c),
        groups=groups)


def reanchor(state_new: WindowState, state_ref: WindowState,
             line_param: str = "world") -> WindowState:
    """Gauge repair (`double2vector()`): rotate/translate the solution so
    frame-0 position and yaw match `state_ref`. World lines transform along;
    inverse depths and anchored-chart lines are invariant."""
    ypr_ref = rot_to_ypr(quat_to_rot(state_ref.q[0]))
    ypr_new = rot_to_ypr(quat_to_rot(state_new.q[0]))
    dyaw = ypr_ref[0] - ypr_new[0]
    z = torch.zeros_like(dyaw)
    Rz = ypr_to_rot(torch.stack([dyaw, z, z]))
    q_z = rot_to_quat(Rz)
    t = state_ref.p[0] - Rz @ state_new.p[0]
    line = plucker_transform(state_new.line, Rz, t) if line_param == "world" else state_new.line
    return state_new._replace(
        p=state_new.p @ Rz.T + t,
        q=quat_mul(q_z.expand_as(state_new.q), state_new.q),
        v=state_new.v @ Rz.T,
        line=line,
        relo_p=Rz @ state_new.relo_p + t,
        relo_q=quat_mul(q_z, state_new.relo_q),
    )

