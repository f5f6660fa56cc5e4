"""The estimator's per-frame backend tick in plain torch: triangulation at
the pre-solve poses, the window's LM solve, the marginalization that the
host picked, and the outlier gates' reprojection errors. A frozen copy of
the port's `backend_tick` without CUDA graphs."""
from __future__ import annotations

import torch

from plbench.reference import marginalization as marg
from plbench.reference import residuals as res
from plbench.reference import solver as solver_mod
from plbench.reference import triangulate
from plbench.reference.state import cam_poses


def backend_tick(st, f, solvable, tri_need, fb4, lneed, ln_active2, lay, cfg, ee: bool,
                 etd: bool, iters: int, marg_mode: str):
    """Returns (st_out, stats, prior or None, aux), as the port's tick."""
    lp = cfg.line_param
    p_wc, q_wc = cam_poses(st)
    inv_tri, ok = triangulate.triangulate_points(p_wc, q_wc, f.pt_obs, f.pt_mask, f.pt_start)
    okf = ok.to(st.p.dtype)
    commit = tri_need * okf
    fallback = tri_need * (1.0 - okf) * fb4
    inv0 = torch.where(commit > 0, inv_tri, st.inv_depth)
    inv0 = torch.where(fallback > 0, torch.full_like(inv0, 1.0 / 5.0), inv0)
    L_tri, okl = triangulate.triangulate_lines(p_wc, q_wc, f.ln_obs, f.ln_mask, f.ln_start)
    lcommit = lneed * okl.to(st.p.dtype)
    line0 = torch.where(lcommit[:, None] > 0, L_tri, st.line)
    pt_valid = solvable * torch.maximum(f.pt_valid, torch.maximum(commit, fallback))
    ln_solved = ln_active2 * torch.maximum(f.ln_valid, lcommit)
    st = st._replace(inv_depth=inv0, line=line0)
    f = f._replace(pt_valid=pt_valid, ln_valid=ln_solved)
    if lp != "world":
        st = st._replace(line=res.lines_from_world(st, st.line, f.ln_start, lp))
    st_out, stats = solver_mod.optimize_window(st, f, lay, cfg, estimate_extrinsic=ee,
                                               estimate_td=etd, num_iters=iters)
    if lp != "world":
        st_out = st_out._replace(line=res.lines_to_world(st_out, f.ln_start, lp))
    if marg_mode == "old":
        prior = marg.marginalize_old(st_out, f, lay, cfg, groups=stats.groups)
    elif marg_mode == "new":
        prior = marg.marginalize_second_new(st_out, f, lay, cfg)
    else:
        prior = None
    _, _, r_pt, r_ln, _ = stats.groups
    err_px = torch.linalg.norm(r_pt, dim=-1) * 1.5
    pt_err = torch.amax(torch.where(f.pt_mask > 0, err_px, torch.zeros_like(err_px)), dim=1)
    aux = dict(commit=commit, lcommit=lcommit, pt_valid=pt_valid, ln_solved=ln_solved,
               pt_err=pt_err, f=f, st_in=st)
    return st_out, stats, prior, aux
