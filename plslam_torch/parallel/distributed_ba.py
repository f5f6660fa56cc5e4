"""Distributed bundle adjustment: landmark-sharded Schur reduction.

Counterpart of `plslam/parallel/distributed_ba.py`. The reduced camera
system of an 11-pose window is tiny (DC×DC ≈ 178²), so poses are
REPLICATED; landmarks (inverse-depth scalars, 4-dof lines) and their
observations are SHARDED into L landmark shards. Per LM iteration:
  1. each shard linearises its own visual factors (jacfwd over
     [camera dims | local landmark dims]),
  2. eliminates its landmark blocks locally (block-diagonal Schur — blocks
     never mix shards),
  3. its reduced camera contribution (S_shard [DC,DC], rhs [DC]) is
     REDUCED over the shards — the only communication,
  4. the replicated DC×DC system is solved (by every holder of shards) and
     each shard back-substitutes its local landmark deltas.

IMU + prior factors are replicated; global shard 0 contributes them (the
others add 0) so the reduction yields the exact global normal equations.

JAX runs the shards on a device mesh and reduces with `psum`. Here one LM
body (`make_lm_iter`) receives the reduction and serves two layouts:
  (a) one process: the L shards are stacked on a leading axis on one
      device, each linearised under `torch.func.vmap`, and the reduction is
      `.sum(0)` — the layout one card runs;
  (b) several processes: each rank of a process group holds L/world of the
      shards (stacked as in (a)), and the reduction adds
      `torch.distributed.all_reduce(SUM)` over the group.
`make_mesh(n_shards, group)` names the layout.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from plslam_torch.config import SolverConfig
from plslam_torch.models import residuals as res
from plslam_torch.models.solver import reanchor
from plslam_torch.models.state import TangentLayout, WindowState, default_lines, where_state
from plslam_torch.ops.imu import cholesky
from plslam_torch.ops.lines import orth_retract
from plslam_torch.utils.geometry import quat_box_plus


class LmkMesh(NamedTuple):
    """The landmark-shard layout: `n_shards` shards, held by one process
    (`group=None`) or split evenly over the ranks of a process group."""

    n_shards: int
    group: object = None

    def local_shards(self) -> range:
        """The global indices of the shards this process holds."""
        if self.group is None:
            return range(self.n_shards)
        per = self.n_shards // dist.get_world_size(self.group)
        r = dist.get_rank(self.group)
        return range(r * per, (r + 1) * per)


def make_mesh(n_shards: int = 1, group=None) -> LmkMesh:
    if group is not None and n_shards % dist.get_world_size(group):
        raise ValueError(f"{n_shards} landmark shards do not split evenly over "
                         f"{dist.get_world_size(group)} ranks")
    return LmkMesh(n_shards, group)


def reducer(group=None):
    """The reduction over landmark shards: the local stack's `.sum(0)`, then
    an all_reduce over `group` when there is one."""
    def reduce(x):
        y = x.sum(0)
        if group is not None:
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    return reduce


def all_gather_cat(x, group):
    """`x` [S,...] of every rank of `group`, concatenated in rank order."""
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.cat(out)


def _split(a, n, fill=None):
    """[N,...] → [n, ⌈N/n⌉, ...], padded with zeros (or rows of `fill`)."""
    pad = (-a.shape[0]) % n
    if pad:
        rows = torch.zeros((pad, *a.shape[1:]), dtype=a.dtype, device=a.device) \
            if fill is None else fill[:pad]
        a = torch.cat([a, rows])
    return a.reshape(n, a.shape[0] // n, *a.shape[1:])


def _visual_residual(state, pt, ln, focal):
    """Point+line residuals of a local factor shard (shapes from the arrays —
    the single-device residual functions are capacity-agnostic)."""
    pt_obs, pt_vel, pt_mask, pt_start, pt_valid = pt
    ln_obs, ln_mask, ln_valid = ln
    dtype, device = state.p.dtype, state.p.device
    f_local = res.WindowFactors(
        imu_alpha=None, imu_beta=None, imu_gamma=None, imu_jac=None,
        imu_sqrt_info=None, imu_dt=None, imu_ba=None, imu_bg=None,
        imu_valid=None, g=torch.zeros(3, dtype=dtype, device=device),
        pt_obs=pt_obs, pt_vel=pt_vel,
        pt_td_ref=torch.zeros((pt_mask.shape[1],), dtype=dtype, device=device),
        pt_rowf=torch.zeros_like(pt_mask), rs_tr=torch.zeros((), dtype=dtype, device=device),
        pt_mask=pt_mask, pt_start=pt_start, pt_valid=pt_valid,
        ln_obs=ln_obs, ln_mask=ln_mask, ln_valid=ln_valid,
        ln_start=torch.zeros_like(ln_valid, dtype=torch.int64),  # world-param lines only
        relo_obs=None, relo_mask=None, relo_valid=None,
        prior_J=None, prior_r0=None, prior_valid=None,
        prior_p=None, prior_q=None, prior_v=None, prior_ba=None, prior_bg=None,
        prior_p_bc=None, prior_q_bc=None, prior_td=None,
    )
    return res.point_residuals(state, f_local, focal), res.line_residuals(state, f_local, focal)


def _retract_local(state: WindowState, dc, dd, dl) -> WindowState:
    """Camera-dim delta dc [DC] + local landmark deltas (dd [mf_s], dl [ml_s,4])."""
    nw = state.p.shape[0]
    dp = dc[0: nw * 6].reshape(nw, 6)
    dsb = dc[nw * 6: nw * 15].reshape(nw, 9)
    dext = dc[nw * 15: nw * 15 + 6]
    dtd = dc[nw * 15 + 6]
    return WindowState(
        p=state.p + dp[:, 0:3],
        q=quat_box_plus(state.q, dp[:, 3:6]),
        v=state.v + dsb[:, 0:3],
        ba=state.ba + dsb[:, 3:6],
        bg=state.bg + dsb[:, 6:9],
        p_bc=state.p_bc + dext[0:3],
        q_bc=quat_box_plus(state.q_bc, dext[3:6]),
        td=state.td + dtd,
        relo_p=state.relo_p,
        relo_q=state.relo_q,
        inv_depth=state.inv_depth + dd,
        line=orth_retract(state.line, dl),
    )


def _strip(st: WindowState) -> WindowState:
    return st._replace(inv_depth=st.p.new_zeros((0,)), line=st.p.new_zeros((0, 6)))


def make_lm_iter(reduce, lay, cfg, focal, mf_s, ml_s, pt, ln, is0, cam_residual):
    """One landmark-sharded LM iteration over the local shards, parameterised
    by the reduction over all shards (`reducer`). Shared by the 1-D solve
    below and the 2-D (kf_part, lmk) layout of `parallel.mesh2d`.

    pt, ln: the local shards' factor slices, stacked [S, ...]; is0 [S]: 1
    for global shard 0. carry = (state_cam, inv_depth [S,mf_s],
    line [S,ml_s,6], lam, cost)."""
    DC = lay.dim_cam
    nw = lay.nw
    pt_valid = pt[4]
    ln_valid = ln[2]
    S = pt_valid.shape[0]
    dtype, device = pt_valid.dtype, pt_valid.device
    dim_local = DC + mf_s + ml_s * 4
    # frozen camera dims (extrinsic + td + relo, as the single-device free_mask)
    cam_free = torch.ones((DC,), dtype=dtype, device=device)
    cam_free[nw * 15:] = 0.0
    lmk_mask = torch.cat([pt_valid, ln_valid.repeat_interleave(4, dim=-1)], dim=-1)

    def linearize_shard(st_cam, inv_d, line, pt_s, ln_s, is0_s):
        st = st_cam._replace(inv_depth=inv_d, line=line)
        r_pt0, r_ln0 = _visual_residual(st, pt_s, ln_s, focal)
        pt_w = res.cauchy_weights(torch.sum(r_pt0 * r_pt0, -1), cfg.cauchy_c)
        ln_w = res.cauchy_weights(torch.sum(r_ln0 * r_ln0, -1), cfg.cauchy_c)

        def r_local(delta):
            st_d = _retract_local(st, delta[:DC], delta[DC: DC + mf_s],
                                  delta[DC + mf_s:].reshape(ml_s, 4))
            r_pt, r_ln = _visual_residual(st_d, pt_s, ln_s, focal)
            return torch.cat([cam_residual(st_d) * is0_s,
                              (r_pt * pt_w[..., None]).reshape(-1),
                              (r_ln * ln_w[..., None]).reshape(-1)])

        zero = torch.zeros((dim_local,), dtype=dtype, device=device)
        r0 = r_local(zero)
        J = torch.func.jacfwd(r_local)(zero)
        return J.T @ J, J.T @ r0, 0.5 * torch.sum(r0 * r0), pt_w, ln_w

    def visual_cost(st_cam, inv_d, line, pt_s, ln_s, pt_w, ln_w):
        r_pt, r_ln = _visual_residual(st_cam._replace(inv_depth=inv_d, line=line), pt_s, ln_s,
                                      focal)
        return torch.sum((r_pt * pt_w[..., None]) ** 2) + torch.sum((r_ln * ln_w[..., None]) ** 2)

    lin = torch.func.vmap(linearize_shard, in_dims=(None, 0, 0, 0, 0, 0))
    vis = torch.func.vmap(visual_cost, in_dims=(None, 0, 0, 0, 0, 0, 0))

    def lm_iter(carry):
        st_cam, inv_d, line, lam, _ = carry
        H, b, cost_s, pt_w, ln_w = lin(st_cam, inv_d, line, pt, ln, is0)
        cost = reduce(cost_s)

        # Jacobi scaling; the camera diagonal is global
        dH = torch.diagonal(H, dim1=-2, dim2=-1)
        dH_cam = reduce(dH[:, :DC])
        sc_cam = cam_free / torch.sqrt(torch.clamp(dH_cam, min=1e-8))
        sc_lmk = lmk_mask / torch.sqrt(torch.clamp(dH[:, DC:], min=1e-8))
        sc = torch.cat([sc_cam.expand(S, DC), sc_lmk], dim=-1)
        Hs = H * sc[:, :, None] * sc[:, None, :]
        bs = b * sc
        damp = lam + 1e-8

        Bd = Hs[:, :DC, DC: DC + mf_s]
        Bl = Hs[:, :DC, DC + mf_s:].reshape(S, DC, ml_s, 4)
        b_d = bs[:, DC: DC + mf_s]
        b_l = bs[:, DC + mf_s:].reshape(S, ml_s, 4)
        d = torch.diagonal(Hs, dim1=-2, dim2=-1)[:, DC: DC + mf_s] + damp * pt_valid \
            + (1.0 - pt_valid)
        Cb = torch.diagonal(Hs[:, DC + mf_s:, DC + mf_s:].reshape(S, ml_s, 4, ml_s, 4),
                            dim1=1, dim2=3).permute(0, 3, 1, 2)  # [S,ml_s,4,4] diagonal blocks
        Cb = Cb + torch.diag_embed((damp * ln_valid + (1.0 - ln_valid))[..., None].expand(S, ml_s, 4))
        Cb_inv = torch.linalg.inv_ex(Cb)[0]

        BCd = Bd / d[:, None, :]
        BCl = torch.einsum("sdma,smab->sdmb", Bl, Cb_inv)
        S_local = (Hs[:, :DC, :DC] - BCd @ Bd.transpose(-1, -2)
                   - torch.einsum("sdmb,semb->sde", BCl, Bl))
        rhs_local = (-bs[:, :DC] + torch.einsum("sdm,sm->sd", BCd, b_d)
                     + torch.einsum("sdmb,smb->sd", BCl, b_l))

        # ---- the reduction of the camera system over all shards ----
        S_cam = reduce(S_local) + torch.diag(damp * cam_free + (1.0 - cam_free))
        rhs = reduce(rhs_local) * cam_free

        dc_s = torch.cholesky_solve(rhs[:, None], cholesky(S_cam))[:, 0]
        dd_s = (-b_d - torch.einsum("sdm,d->sm", Bd, dc_s)) / d
        dl_s = torch.einsum("smab,smb->sma", Cb_inv,
                            -b_l - torch.einsum("sdma,d->sma", Bl, dc_s))

        dc = dc_s * sc_cam
        dd = dd_s * sc_lmk[:, :mf_s]
        dl = (dl_s.reshape(S, -1) * sc_lmk[:, mf_s:]).reshape(S, ml_s, 4)

        st_try = _retract_local(st_cam, dc, dc[:0], dc.new_zeros((0, 4)))
        inv_try = inv_d + dd
        line_try = orth_retract(line, dl)
        cam_r = cam_residual(st_try)
        cost_try = reduce(0.5 * (vis(st_try, inv_try, line_try, pt, ln, pt_w, ln_w)
                                 + is0 * torch.sum(cam_r * cam_r)))

        # a failed inner solve (Cholesky on a near-indefinite f32 system at
        # low damping) yields NaN deltas → NaN cost_try: treat as a
        # rejected step (lam grows, next iteration retries) and keep the
        # cost finite
        good = torch.isfinite(cost_try)
        accept = good & (cost_try < cost)
        lam_new = torch.where(accept, torch.clamp(lam * 0.4, min=cfg.lm_lambda_min),
                              torch.clamp(lam * 5.0, max=cfg.lm_lambda_max))
        return (where_state(accept, st_try, st_cam),
                torch.where(accept, inv_try, inv_d),
                torch.where(accept, line_try, line),
                lam_new,
                torch.where(good, torch.minimum(cost_try, cost), cost))

    return lm_iter


def solve_local_shards(state: WindowState, f: res.WindowFactors, lay: TangentLayout,
                       cfg: SolverConfig, n_shards: int, shards, reduce, num_iters: int):
    """`num_iters` landmark-sharded LM iterations over the shards `shards`
    (global indices, contiguous) of `n_shards`. Returns (state_cam,
    inv_depth [S,mf_s], line [S,ml_s,6], final cost), the landmarks of the
    local shards only."""
    dtype, device = state.p.dtype, state.p.device
    lo, hi = shards[0], shards[-1] + 1
    take = lambda a, fill=None: _split(a, n_shards, fill)[lo:hi]  # noqa: E731
    pt = (take(f.pt_obs), take(f.pt_vel), take(f.pt_mask), take(f.pt_start), take(f.pt_valid))
    ln = (take(f.ln_obs), take(f.ln_mask), take(f.ln_valid))
    inv_d = take(state.inv_depth)
    # padded line slots get benign lines (a zero Plücker line has no chart)
    line = take(state.line, default_lines(state.line.shape[0], dtype, device))
    mf_s, ml_s = inv_d.shape[1], line.shape[1]
    is0 = (torch.arange(lo, hi, device=device) == 0).to(dtype)

    def cam_residual(st):
        return torch.cat([res.prior_residual(st, f, lay), res.imu_residuals(st, f).reshape(-1)])

    lm_iter = make_lm_iter(reduce, lay, cfg, cfg.focal_length, mf_s, ml_s, pt, ln, is0,
                           cam_residual)
    carry = (_strip(state), inv_d, line,
             torch.full((), cfg.lm_lambda_init, dtype=dtype, device=device),
             torch.zeros((), dtype=dtype, device=device))
    for _ in range(num_iters):
        carry = lm_iter(carry)
    st_cam, inv_out, line_out, _, cost = carry
    return st_cam, inv_out, line_out, cost


def distributed_optimize_window(
    state: WindowState,
    f: res.WindowFactors,
    lay: TangentLayout,
    cfg: SolverConfig,
    mesh: LmkMesh,
    num_iters: int = 8,
):
    """Landmark-sharded LM solve. Returns (state', final cost). Across
    processes every rank passes the whole window, solves its shards, and
    returns the whole solution (the landmarks gathered over the group)."""
    st_cam, inv_out, line_out, cost = solve_local_shards(
        state, f, lay, cfg, mesh.n_shards, mesh.local_shards(), reducer(mesh.group), num_iters)
    if mesh.group is not None:
        inv_out = all_gather_cat(inv_out, mesh.group)
        line_out = all_gather_cat(line_out, mesh.group)
    state_out = st_cam._replace(inv_depth=inv_out.reshape(-1)[: lay.max_f],
                                line=line_out.reshape(-1, 6)[: lay.max_l])
    return reanchor(state_out, state), cost
