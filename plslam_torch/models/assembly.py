"""Structured normal-equation assembly: per-factor local jacobians + one
block scatter-add per factor type.

Counterpart of `plslam/models/assembly.py`. The solver's dense path
(`solver.linearize`) takes one `jacfwd` over the whole tangent, although
each residual touches at most 22 tangent dims. This module assembles
H = ΣJᵀJ, b = ΣJᵀr the way the reference's Ceres + 4-pthread
marginalization assembly did:

  * per factor type, one `torch.func.vmap(torch.func.jacfwd(...))` over the
    LOCAL parameter slice (IMU 30 dims, point 20, line 16 in the world chart
    or 22 in the anchored ones, relo 20), every slot's inputs gathered
    before the vmapped function so that it indexes nothing by slot;
  * per slot the global column indices, built on the device from
    `f.pt_start` / `f.ln_start` and the layout-only pieces (made once per
    layout and device);
  * one `index_add_` per factor type into the flat H and one into b
    (`scatter`). On a
    GPU `index_add_` is one kernel of float atomics; `index_put_(...,
    accumulate=True)` would sort the indices first, to sum in a fixed order.
    So the normal equations agree with the dense ones to a scale-relative
    tolerance, not bit for bit;
  * the marginalization prior, linear in x ⊟ x₀, contributes J₀'ᵀJ₀' and
    J₀'ᵀr with J₀' = J₀·∂(x ⊟ x₀)/∂δ over the camera dims.

Two terms differ from the JAX module, which this one matches where they
coincide: the point and relo residuals subtract each frame's pairing-time td
(`f.pt_td_ref`), as both packages' `residuals.py` do, and the prior's
jacobian carries ∂(x ⊟ x₀)/∂δ, which the JAX module takes as the identity:
exact at the prior's own linearization point, but never for the relo pose,
which the prior's snapshot does not hold (its columns of x ⊟ x₀ stay 0).
Nothing in the assembly reads a value back to the host.
"""
from __future__ import annotations

import functools

import torch

from plslam_torch.models import residuals as res
from plslam_torch.models.state import TangentLayout, WindowState, retract
from plslam_torch.ops import imu as imu_ops
from plslam_torch.ops.lines import line_projection_residual, orth_retract, plucker_transform
from plslam_torch.utils.geometry import (
    pose_inverse,
    quat_box_plus,
    quat_conj,
    quat_mul,
    quat_rotate,
    quat_to_rot,
)

_jac = functools.partial(torch.func.jacfwd, has_aux=True)


def _value_and_jacobian(fn, n, slots, dtype, device):
    """(r [S,m], J [S,m,n]) of `fn(d, slot)` at d = 0 for every slot."""
    zero = torch.zeros((n,), dtype=dtype, device=device)
    J, r = torch.func.vmap(_jac(lambda d, s: (fn(d, s),) * 2), in_dims=(None, 0))(zero, slots)
    return r, J


@functools.lru_cache(maxsize=None)
def _index_tensors(lay: TangentLayout, device):
    """The global column indices that depend only on the layout, made once
    per (layout, device): a host array copied to the card in every call
    would wait for the device's queue. Returns (IMU [W,30], point tail
    [MF,NW,14], line tail [ML,NW,16], relo tail [MF,14])."""
    NW, MF, ML = lay.nw, lay.max_f, lay.max_l
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    pose = lay.off_pose + 6 * ar(NW)[:, None] + ar(6)  # [NW,6]
    sb = lay.off_sb + 9 * ar(NW)[:, None] + ar(9)  # [NW,9]
    ext = lay.off_ext + ar(6)
    td = torch.full((1,), lay.off_td, device=device)
    depth = lay.off_depth + ar(MF)  # [MF]
    imu = torch.cat([pose[:-1], sb[:-1], pose[1:], sb[1:]], dim=-1)
    pt = torch.cat([pose.expand(MF, NW, 6), ext.expand(MF, NW, 6), td.expand(MF, NW, 1),
                    depth[:, None, None].expand(MF, NW, 1)], dim=-1)
    line = lay.off_line + 4 * ar(ML)[:, None] + ar(4)  # [ML,4]
    ln = torch.cat([pose.expand(ML, NW, 6), ext.expand(ML, NW, 6),
                    line[:, None, :].expand(ML, NW, 4)], dim=-1)
    relo = torch.cat([(lay.off_relo + ar(6)).expand(MF, 6), ext.expand(MF, 6),
                      td.expand(MF, 1), depth[:, None]], dim=-1)
    return imu, pt, ln, relo


def scatter(blocks, D):
    """(H [D,D], b [D]) = Σ over every slot of every factor type of
    H[idx, idx] += JᵀJ and b[idx] += Jᵀr: one `index_add_` a factor type
    into the flat H and one into b. `blocks` holds a factor type's
    (idx [S,n], J [S,m,n], r [S,m])."""
    J0 = blocks[0][1]
    H = torch.zeros((D * D,), dtype=J0.dtype, device=J0.device)
    b = torch.zeros((D,), dtype=J0.dtype, device=J0.device)
    for idx, J, r in blocks:
        flat = (idx[:, :, None] * D + idx[:, None, :]).reshape(-1)
        H.index_add_(0, flat, torch.einsum("sra,srb->sab", J, J).reshape(-1))
        b.index_add_(0, idx.reshape(-1), torch.einsum("sra,sr->sa", J, r).reshape(-1))
    return H.view(D, D), b


def _by_row(a, NW):
    """[R, ...] → [R·NW, ...]: each row's value in every frame slot of its row."""
    return a[:, None].expand(a.shape[0], NW, *a.shape[1:]).reshape(-1, *a.shape[1:])


def _by_frame(a, R):
    """[NW, ...] → [R·NW, ...]: each frame's value in that frame's slot of every row."""
    return a[None].expand(R, *a.shape).reshape(-1, *a.shape[1:])


def _pose_dims(lay: TangentLayout, k):
    """[..., 6] pose columns of the frames `k` (a tensor)."""
    return lay.off_pose + 6 * k[..., None] + torch.arange(6, device=k.device)


def _project(x_c):
    """Normalized projection with the solver's near-zero depth guard, and the
    behind-camera mask."""
    z = x_c[2]
    return x_c[0:2] / res._z_safe(z), (z > 1e-3).to(x_c.dtype)


def _point_in_world(d_pose_i, d_ext, d_td, d_lam, state, s):
    """World position of a point from its anchor observation, the anchor pose,
    the extrinsic, td and inverse depth each moved by its local delta."""
    p_i = s["p_i"] + d_pose_i[0:3]
    q_i = quat_box_plus(s["q_i"], d_pose_i[3:6])
    p_bc = state.p_bc + d_ext[0:3]
    q_bc = quat_box_plus(state.q_bc, d_ext[3:6])
    td = state.td + d_td
    lam = s["lam"] + d_lam
    u_i = s["u_i"] - (td - s["td_ref_i"] + s["rs_i"]) * s["vel_i"]
    depth = 1.0 / torch.where(torch.abs(lam) > 1e-6, lam, torch.full_like(lam, 1e-6))
    p_ci = torch.cat([u_i, torch.ones_like(u_i[:1])]) * depth
    return quat_rotate(q_i, quat_rotate(q_bc, p_ci) + p_bc) + p_i, p_bc, q_bc, td


def assemble(state: WindowState, f: res.WindowFactors, lay: TangentLayout,
             focal: float, pt_w, ln_w, relo_w, line_param: str = "world"):
    """Returns (H [D,D], b [D], cost) of the full weighted problem, the
    normal equations of `solver.linearize`'s (r, J): H = JᵀJ, b = Jᵀr,
    cost = ½‖r‖²."""
    DC = lay.dim_cam
    Jp, r_pr, blocks = factor_blocks(state, f, lay, focal, pt_w, ln_w, relo_w, line_param)
    H, b = scatter(blocks, lay.dim)
    H[:DC, :DC] += Jp.T @ Jp
    b[:DC] += Jp.T @ r_pr
    cost = 0.5 * torch.sum(r_pr * r_pr)
    for _, _, r in blocks:
        cost = cost + 0.5 * torch.sum(r * r)
    return H, b, cost


def factor_blocks(state: WindowState, f: res.WindowFactors, lay: TangentLayout,
                  focal: float, pt_w, ln_w, relo_w, line_param: str = "world"):
    """Every factor's residual and jacobian over its local slice, with the
    global columns of that slice. Returns (J₀' [DC,DC], r_prior [DC],
    blocks): the prior over the camera dims, and per factor type (IMU,
    point, line, relo) (idx [S,n], J [S,m,n], r [S,m]) over its S slots."""
    D, DC, NW, MF, ML = lay.dim, lay.dim_cam, lay.nw, lay.max_f, lay.max_l
    dtype, device = state.p.dtype, state.p.device
    idx_imu, pt_tail, ln_tail, relo_tail = _index_tensors(lay, device)
    sc = focal / 1.5

    # ---------------- prior: linear in x ⊟ x₀ over the camera dims ----------------
    tail = torch.zeros((D - DC,), dtype=dtype, device=device)

    def prior(dc):
        r = res.prior_residual(retract(state, torch.cat([dc, tail]), lay), f, lay)
        return r, r

    Jp, r_pr = torch.func.jacfwd(prior, has_aux=True)(torch.zeros((DC,), dtype=dtype,
                                                                  device=device))

    # ---------------- IMU factors (local dim 30) ----------------
    def imu_local(d, s):
        # d = [pose_k(6), sb_k(9), pose_{k+1}(6), sb_{k+1}(9)]
        def upd(e, o):
            return (s["p" + e] + d[o:o + 3], quat_box_plus(s["q" + e], d[o + 3:o + 6]),
                    s["v" + e] + d[o + 6:o + 9], s["ba" + e] + d[o + 9:o + 12],
                    s["bg" + e] + d[o + 12:o + 15])

        pre = imu_ops.Preintegration(
            alpha=s["alpha"], beta=s["beta"], gamma=s["gamma"], jac=s["jac"],
            cov=torch.zeros_like(s["jac"]),
            dt_sum=s["dt"], ba=s["lba"], bg=s["lbg"])
        r = imu_ops.imu_residual(*upd("_i", 0), *upd("_j", 15), pre, f.g)
        return (s["sqrt_info"] @ r) * s["valid"]

    imu_slots = dict(
        alpha=f.imu_alpha, beta=f.imu_beta, gamma=f.imu_gamma, jac=f.imu_jac, dt=f.imu_dt,
        lba=f.imu_ba, lbg=f.imu_bg, sqrt_info=f.imu_sqrt_info, valid=f.imu_valid)
    for k in ("p", "q", "v", "ba", "bg"):
        a = getattr(state, k)
        imu_slots.update({k + "_i": a[:-1], k + "_j": a[1:]})
    r_imu, J_imu = _value_and_jacobian(imu_local, 30, imu_slots, dtype, device)
    blocks = [(idx_imu, J_imu, r_imu)]

    # ---------------- point factors (local dim 20 per slot) ----------------
    start = f.pt_start.long()
    rows = torch.arange(MF, device=device)
    not_anchor = (torch.arange(NW, device=device)[None, :] != start[:, None]).to(dtype)
    anchor = dict(  # [MF,...] the anchor frame's values of each feature
        p_i=state.p[start], q_i=state.q[start], lam=state.inv_depth, u_i=f.pt_obs[rows, start],
        vel_i=f.pt_vel[rows, start], rs_i=f.rs_tr * f.pt_rowf[rows, start],
        td_ref_i=f.pt_td_ref[start])

    def pt_local(d, s):
        # d = [pose_i(6), pose_j(6), ext(6), td(1), depth(1)]
        p_w, p_bc, q_bc, td = _point_in_world(d[0:6], d[12:18], d[18], d[19], state, s)
        p_j = s["p_j"] + d[6:9]
        q_j = quat_box_plus(s["q_j"], d[9:12])
        p_cb, q_cb = pose_inverse(p_bc, q_bc)
        x_c = quat_rotate(q_cb, quat_rotate(quat_conj(q_j), p_w - p_j)) + p_cb
        pred, front = _project(x_c)
        u_j = s["u_j"] - (td - s["td_ref_j"] + s["rs_j"]) * s["vel_j"]
        return (pred - u_j) * (s["m"] * front * sc * s["w"])

    pt_slots = {k: _by_row(v, NW) for k, v in anchor.items()}
    pt_slots.update(
        p_j=_by_frame(state.p, MF), q_j=_by_frame(state.q, MF),
        td_ref_j=_by_frame(f.pt_td_ref, MF),
        u_j=f.pt_obs.reshape(-1, 2), vel_j=f.pt_vel.reshape(-1, 2),
        rs_j=(f.rs_tr * f.pt_rowf).reshape(-1),
        m=(f.pt_mask * not_anchor * f.pt_valid[:, None]).reshape(-1), w=pt_w.reshape(-1))
    r_pt, J_pt = _value_and_jacobian(pt_local, 20, pt_slots, dtype, device)
    idx_pt = torch.cat([_pose_dims(lay, start)[:, None].expand(MF, NW, 6), pt_tail], dim=-1)
    blocks.append((idx_pt.reshape(MF * NW, 20), J_pt, r_pt))

    # ---------------- line factors (local dim 16 / 22 per slot) ----------------
    # world chart: d = [pose_j(6), ext(6), line-orth(4)]; the anchored charts
    # ride the line's first-observing frame, whose pose joins the block:
    # d = [pose_a(6), pose_j(6), ext(6), line-orth(4)]
    anchored = line_param != "world"
    if anchored and line_param not in ("incamera", "instartframe"):
        raise ValueError(f"unknown line_param {line_param!r}")
    n_ln = 22 if anchored else 16
    ln_start = f.ln_start.long()

    def ln_local(d, s):
        if anchored:
            p_a = s["p_a"] + d[0:3]
            q_a = quat_box_plus(s["q_a"], d[3:6])
            d = d[6:]
        p_j = s["p_j"] + d[0:3]
        q_j = quat_box_plus(s["q_j"], d[3:6])
        p_bc = state.p_bc + d[6:9]
        q_bc = quat_box_plus(state.q_bc, d[9:12])
        L = orth_retract(s["line"], d[12:16])
        if anchored:
            if line_param == "incamera":
                p_a, q_a = p_a + quat_rotate(q_a, p_bc), quat_mul(q_a, q_bc)
            L = plucker_transform(L, quat_to_rot(q_a), p_a)
        p_cw, q_cw = pose_inverse(p_j + quat_rotate(q_j, p_bc), quat_mul(q_j, q_bc))
        L_c = plucker_transform(L, quat_to_rot(q_cw), p_cw)
        r = line_projection_residual(L_c, s["obs"][0:2], s["obs"][2:4])
        return r * (s["m"] * sc * s["w"])

    ln_slots = dict(
        p_j=_by_frame(state.p, ML), q_j=_by_frame(state.q, ML), line=_by_row(state.line, NW),
        obs=f.ln_obs.reshape(-1, 4), m=(f.ln_mask * f.ln_valid[:, None]).reshape(-1),
        w=ln_w.reshape(-1))
    idx_ln = ln_tail
    if anchored:
        ln_slots.update(p_a=_by_row(state.p[ln_start], NW), q_a=_by_row(state.q[ln_start], NW))
        idx_ln = torch.cat([_pose_dims(lay, ln_start)[:, None].expand(ML, NW, 6), ln_tail],
                           dim=-1)
    r_ln, J_ln = _value_and_jacobian(ln_local, n_ln, ln_slots, dtype, device)
    blocks.append((idx_ln.reshape(ML * NW, n_ln), J_ln, r_ln))

    # ---------------- relocalization factors (local dim 20) ----------------
    def relo_local(d, s):
        # d = [pose_i(6), relo(6), ext(6), td(1), depth(1)]
        p_w, p_bc, q_bc, _ = _point_in_world(d[0:6], d[12:18], d[18], d[19], state, s)
        rp = state.relo_p + d[6:9]
        rq = quat_box_plus(state.relo_q, d[9:12])
        p_cw, q_cw = pose_inverse(rp + quat_rotate(rq, p_bc), quat_mul(rq, q_bc))
        pred, front = _project(quat_rotate(q_cw, p_w) + p_cw)
        return (pred - s["obs"]) * (s["m"] * front * sc * s["w"])

    relo_slots = dict(anchor, obs=f.relo_obs, w=relo_w,
                      m=f.relo_mask * f.pt_valid * f.relo_valid)
    r_re, J_re = _value_and_jacobian(relo_local, 20, relo_slots, dtype, device)
    idx_re = torch.cat([_pose_dims(lay, start), relo_tail], dim=-1)
    blocks.append((idx_re, J_re, r_re))
    return Jp, r_pr, blocks

