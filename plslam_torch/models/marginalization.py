"""Schur-complement marginalization with First-Estimate-Jacobian prior.

Counterpart of `plslam/models/marginalization.py` (the reference's
`MarginalizationInfo` / `MarginalizationFactor`): linearize the factors
touching the dropped frame, eliminate landmarks blockwise and the frame's 15
pose+speedbias dims with an eigh pseudo-inverse, re-factor the kept system
H' = J₀ᵀJ₀ and re-index it by the window shift. Every eigendecomposition runs
on the Jacobi-scaled (unit-diagonal) system so the eigenvalue floor is
relative and float32 survives.

On the card the eigendecompositions are queued without a host wait
(`ops/kernels/eigh.py`): each one's `info` stays on the device, in the list
`infos` that the caller passes, and `eigh_failed` folds them into one flag
for the caller's own readback (`estimator.backend_tick` puts it in the
solve's bundle). A caller that passes no list gets each checked on the host
at once, which waits and raises as `torch.linalg.eigh` does. On the CPU
`torch.linalg.eigh` runs and raises itself.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from plslam_torch.config import SolverConfig
from plslam_torch.models import residuals as res
from plslam_torch.models.state import TangentLayout, WindowState
from plslam_torch.ops.kernels import eigh as eigh_kernel
from plslam_torch.utils import timers

EIGH_FAILED = "linalg.eigh: the marginalization's eigendecomposition failed to converge"


class Prior(NamedTuple):
    J: torch.Tensor  # [DC,DC]
    r0: torch.Tensor  # [DC]
    valid: torch.Tensor  # [] 0/1
    # snapshot (camera-side FEJ point)
    p: torch.Tensor
    q: torch.Tensor
    v: torch.Tensor
    ba: torch.Tensor
    bg: torch.Tensor
    p_bc: torch.Tensor
    q_bc: torch.Tensor
    td: torch.Tensor


def _drop0_indices(lay: TangentLayout):
    drop = np.concatenate([np.arange(0, 6), np.arange(lay.off_sb, lay.off_sb + 9)])
    keep = np.setdiff1d(np.arange(lay.dim_cam), drop)
    return drop, keep


def _shift_perm(lay: TangentLayout):
    """new-dim -> old-dim gather map implementing the window shift
    (frames 1..NW-1 → 0..NW-2; the new last frame maps to the old frame-0 slots)."""
    nw = lay.nw
    perm = np.arange(lay.dim_cam)
    pose = perm[lay.off_pose: lay.off_sb].reshape(nw, 6)
    perm[lay.off_pose: lay.off_sb] = np.concatenate([pose[1:], pose[:1]]).reshape(-1)
    sb = np.arange(lay.off_sb, lay.off_ext).reshape(nw, 9)
    perm[lay.off_sb: lay.off_ext] = np.concatenate([sb[1:], sb[:1]]).reshape(-1)
    return perm


@functools.lru_cache(maxsize=None)
def _index_tensors(lay: TangentLayout, device):
    """(drop, keep, shift perm) of MARGIN_OLD and (drop, keep) of
    MARGIN_SECOND_NEW as index tensors on `device`, made once: a host array
    copied to the card in every call would wait for the device's queue."""
    drop, keep = _drop0_indices(lay)
    nw = lay.nw
    drop_new = np.arange((nw - 2) * 6, (nw - 1) * 6)  # pose slot NW-2
    keep_new = np.setdiff1d(np.arange(lay.dim_cam), drop_new)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (drop, keep, _shift_perm(lay), drop_new, keep_new))


def _eigh_sym(M, infos=None):
    """eigh of the symmetric part of M, decomposed in float64 and cast back.
    MKL's float32 `ssyevd` fails to converge on some Jacobi-scaled,
    rank-deficient marginalization matrices (zero rows of unobserved slots)
    where the JAX package's float32 `eigh` returns; these matrices are at
    most a few hundred wide, so one code path in float64 costs little.
    On the card the decomposition is queued and its `info` appended to
    `infos` (a list), or checked on the host at once without one; on the CPU
    `infos` is not touched."""
    S = (0.5 * (M + M.transpose(-1, -2))).to(torch.float64)
    if S.is_cuda:
        w, V, info = eigh_kernel.eigh_queued(S)
        timers.count("backend.eigh_queued")
        if infos is None:  # read back at once (waits)
            if int(info.max()) != 0:
                raise torch.linalg.LinAlgError(EIGH_FAILED)
        else:
            infos.append(info)
    else:
        w, V = torch.linalg.eigh(S)
    return w.to(M.dtype), V.to(M.dtype)


def eigh_failed(infos, like: torch.Tensor) -> torch.Tensor:
    """[] 0/1 in `like`'s dtype and device: 1 where any decomposition's
    `info` in `infos` is not 0. Queued; nothing is read back."""
    if not infos:
        return torch.zeros((), dtype=like.dtype, device=like.device)
    return torch.any(torch.cat(infos) != 0).to(like.dtype)


def _pinv_psd(M, eps, infos=None):
    w, V = _eigh_sym(M, infos)
    w_inv = torch.where(w > eps, 1.0 / torch.clamp(w, min=eps), torch.zeros_like(w))
    return (V * w_inv[..., None, :]) @ V.transpose(-1, -2)


def _sqrt_refactor(H, b, eps, infos=None):
    w, V = _eigh_sym(H, infos)
    ok = w > eps
    s = torch.where(ok, torch.sqrt(torch.clamp(w, min=eps)), torch.zeros_like(w))
    s_inv = torch.where(ok, 1.0 / torch.clamp(s, min=float(np.sqrt(eps))), torch.zeros_like(w))
    return s[:, None] * V.T, s_inv * (V.T @ b)


def _scatter_kept(J0k, r0k, kt, DC):
    J0 = torch.zeros((DC, DC), dtype=J0k.dtype, device=J0k.device)
    J0[kt[:, None], kt[None, :]] = J0k
    r0 = torch.zeros((DC,), dtype=J0k.dtype, device=J0k.device)
    r0[kt] = r0k
    return J0, r0


def _marg_factor_subset(f: res.WindowFactors) -> res.WindowFactors:
    """Only the factors entering MARGIN_OLD: previous prior + IMU(0→1) + all
    factors of features/lines seen in frame 0 (relo factors never marginalize)."""
    first = torch.arange(f.imu_valid.shape[0], device=f.imu_valid.device) == 0
    return f._replace(
        imu_valid=f.imu_valid * first.to(f.imu_valid.dtype),
        pt_valid=f.pt_valid * (f.pt_start == 0).to(f.pt_valid.dtype),
        ln_valid=f.ln_valid * f.ln_mask[:, 0],
        relo_valid=torch.zeros_like(f.relo_valid),
    )


def _eps(cfg: SolverConfig, dtype):
    return cfg.eig_eps if dtype == torch.float64 else max(cfg.eig_eps, 1e-5)


def _linearize_marginal(state: WindowState, f: res.WindowFactors, lay: TangentLayout,
                        cfg: SolverConfig, groups: Optional[tuple]):
    """Linearize the marginal factor subset into Schur blocks: (H_cc, b_c,
    B_d, d, b_d, B_l, Cb, b_l). Fixed shapes, no host readback."""
    from plslam_torch.models.solver import linearize_blocks

    if groups is not None:
        pt_w, ln_w, _ = res.weights_of_groups(groups, cfg.cauchy_c)
    else:
        pt_w, ln_w, _ = res.robust_weights(state, f, cfg.focal_length, cfg.cauchy_c,
                                           cfg.line_param)
    ones = torch.ones((lay.dim,), dtype=state.p.dtype, device=state.p.device)
    r0, J_cam, blocks = linearize_blocks(state, _marg_factor_subset(f), lay, cfg.focal_length,
                                         pt_w, ln_w, ones, None, cfg.line_param)
    return (J_cam.T @ J_cam, J_cam.T @ r0, *blocks)


def marginalize_old(state: WindowState, f: res.WindowFactors, lay: TangentLayout,
                    cfg: SolverConfig, groups: Optional[tuple] = None,
                    graphs: Optional[dict] = None, infos: Optional[list] = None) -> Prior:
    """MARGIN_OLD: absorb frame 0 (pose+speedbias) and its landmarks into a
    new linear prior, already re-indexed for the subsequent window shift.
    `groups`: unweighted residual groups at `state` (`SolveStats.groups`),
    reused for the IRLS weights instead of re-running the residual stack.
    `graphs`: a dict of CUDA graphs to run the linearization through.
    `infos`: a list that collects the decompositions' device `info` on the
    card (module docstring); None checks each on the host."""
    from plslam_torch.utils import cuda_graph

    lp = cfg.line_param
    eps = _eps(cfg, state.p.dtype)
    if lp != "world":
        state = state._replace(line=res.lines_from_world(state, state.line, f.ln_start, lp))
    Hcc, b_cr, B_d, d_raw, b_d_raw, B_l, Cb_raw, b_l_raw = cuda_graph.run(
        graphs, ("marginalize_old", lay, cfg),
        lambda s, f_, g: _linearize_marginal(s, f_, lay, cfg, g), state, f, groups)
    DC, MF, ML = lay.dim_cam, lay.max_f, lay.max_l

    # 0) Jacobi scaling: IMU-bias whitening puts ~14 decades on diag(H); every
    #    eigendecomposition below operates in scaled (unit-diagonal) space so
    #    the eigenvalue floor is relative and float32 survives.
    diag = torch.cat([torch.diagonal(Hcc), d_raw,
                      torch.diagonal(Cb_raw, dim1=-2, dim2=-1).reshape(-1)])
    sc = torch.where(diag > 1e-12, 1.0 / torch.sqrt(torch.clamp(diag, min=1e-12)),
                     torch.ones_like(diag))
    sc_c = sc[:DC]
    sc_d = sc[DC: DC + MF]
    sc_l = sc[DC + MF:].reshape(ML, 4)

    # 1) eliminate all landmark dims in scaled space (uninvolved blocks are
    #    zero → the pseudo-inverses drop them)
    Hcc_s = Hcc * sc_c[:, None] * sc_c[None, :]
    Bd = B_d * sc_c[:, None] * sc_d[None, :]
    Bl = B_l * sc_c[:, None, None] * sc_l[None, :, :]
    d_s = d_raw * sc_d * sc_d
    Cb = Cb_raw * sc_l[:, :, None] * sc_l[:, None, :]
    d_inv = torch.where(d_s > eps, 1.0 / torch.clamp(d_s, min=eps), torch.zeros_like(d_s))
    Cb_inv = _pinv_psd(Cb, eps, infos)
    BCd = Bd * d_inv[None, :]
    BCl = torch.einsum("dma,mab->dmb", Bl, Cb_inv)
    H_c = Hcc_s - BCd @ Bd.T - torch.einsum("dmb,emb->de", BCl, Bl)
    b_c = (b_cr * sc_c - BCd @ (b_d_raw * sc_d)
           - torch.einsum("dmb,mb->d", BCl, b_l_raw * sc_l))

    # 2) eliminate frame-0 pose+speedbias (15 dims) with an eigh pseudo-inverse
    dt_, kt, perm = _index_tensors(lay, H_c.device)[:3]
    H_dd = H_c[dt_][:, dt_]
    H_dk = H_c[dt_][:, kt]
    H_kk = H_c[kt][:, kt]
    H_dd_inv = _pinv_psd(H_dd, eps, infos)
    H_new_k = H_kk - H_dk.T @ H_dd_inv @ H_dk
    b_new_k = b_c[kt] - H_dk.T @ H_dd_inv @ b_c[dt_]

    # 3) √-refactor the KEPT block, scatter into DC dims, apply the shift
    #    perm to the columns ((J0[:,perm])ᵀ(J0[:,perm]) = H[perm][:,perm])
    J0k, r0k = _sqrt_refactor(H_new_k, b_new_k, eps, infos)
    J0, r0p = _scatter_kept(J0k, r0k, kt, DC)
    # 4) un-scale J0's columns back to tangent units
    J0 = J0[:, perm] * (1.0 / sc[:DC][perm])[None, :]

    # 5) snapshot = current state shifted like the window will be
    roll = lambda a: torch.cat([a[1:], a[:1]], dim=0)  # noqa: E731
    return Prior(
        J=J0, r0=r0p, valid=torch.ones((), dtype=H_c.dtype, device=H_c.device),
        p=roll(state.p), q=roll(state.q), v=roll(state.v),
        ba=roll(state.ba), bg=roll(state.bg),
        p_bc=state.p_bc, q_bc=state.q_bc, td=state.td,
    )


def marginalize_second_new(state: WindowState, f: res.WindowFactors, lay: TangentLayout,
                           cfg: SolverConfig, infos: Optional[list] = None) -> Prior:
    """MARGIN_SECOND_NEW: drop the second-newest pose from the existing prior
    (its visual terms are discarded; its preintegration is merged by the
    caller — the reference's `slideWindowNew` path). `infos` as in
    `marginalize_old`."""
    eps = _eps(cfg, f.prior_J.dtype)
    H = f.prior_J.T @ f.prior_J
    b = f.prior_J.T @ f.prior_r0
    dH = torch.diagonal(H)
    sc = torch.where(dH > 1e-12, 1.0 / torch.sqrt(torch.clamp(dH, min=1e-12)), torch.ones_like(dH))
    H = H * sc[:, None] * sc[None, :]
    b = b * sc

    dt_, kt = _index_tensors(lay, H.device)[3:]  # pose slot NW-2 and the rest
    H_dd_inv = _pinv_psd(H[dt_][:, dt_], eps, infos)
    H_dk = H[dt_][:, kt]
    H_kk = H[kt][:, kt] - H_dk.T @ H_dd_inv @ H_dk
    b_kk = b[kt] - H_dk.T @ H_dd_inv @ b[dt_]

    J0k, r0k = _sqrt_refactor(H_kk, b_kk, eps, infos)
    J0, r0p = _scatter_kept(J0k, r0k, kt, lay.dim_cam)
    J0 = J0 * (1.0 / sc)[None, :]
    return Prior(
        J=J0, r0=r0p, valid=f.prior_valid,
        p=f.prior_p, q=f.prior_q, v=f.prior_v, ba=f.prior_ba, bg=f.prior_bg,
        p_bc=f.prior_p_bc, q_bc=f.prior_q_bc, td=f.prior_td,
    )


def install_prior(f: res.WindowFactors, prior: Prior) -> res.WindowFactors:
    return f._replace(
        prior_J=prior.J, prior_r0=prior.r0, prior_valid=prior.valid,
        prior_p=prior.p, prior_q=prior.q, prior_v=prior.v,
        prior_ba=prior.ba, prior_bg=prior.bg,
        prior_p_bc=prior.p_bc, prior_q_bc=prior.q_bc, prior_td=prior.td,
    )
