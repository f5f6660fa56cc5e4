"""Builders that pack measurements into the fixed-shape `WindowFactors`.

Counterpart of `plslam/models/packing.py`. Two producers exist: the live
estimator (from its feature tables) and this module's packers — the
synthetic one (ground-truth-exact windows for tests and the parallel
solvers) and `factors_from_tracks` (windows from recorded frontend tracks,
for the large-window refinement).

Every function takes the `dtype` and `device` of its output; `dtype`
defaults to float64 (JAX's packer picks float64 when its runtime has x64,
and the port always has it), and `device=None` is the card, as for the
port's other entry points (`utils.device.resolve_device`: it raises
without one; the CPU is `device="cpu"`). Integer fields are int64, as
`convert._INT_FIELDS` makes them; the host-side selection of landmarks runs
in numpy and float64 whatever the output dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from plslam_torch.config import SolverConfig
from plslam_torch.io.synthetic import SyntheticSequence, imu_between
from plslam_torch.models.residuals import WindowFactors, empty_factors
from plslam_torch.models.state import TangentLayout, WindowState, zero_state
from plslam_torch.ops import imu as imu_ops
from plslam_torch.ops.lines import plucker_from_points
from plslam_torch.utils.device import astensor, resolve_device
from plslam_torch.utils.geometry import quat_conj, quat_mul, quat_rotate


def gt_window_state(seq: SyntheticSequence, frames, cfg: SolverConfig, dtype=torch.float64,
                    device=None) -> WindowState:
    device = resolve_device(device)
    idx = torch.as_tensor(np.asarray(frames), dtype=torch.int64)
    to = lambda x: x.to(dtype=dtype, device=device)  # noqa: E731
    return zero_state(cfg, dtype, device)._replace(
        p=to(seq.gt_p[idx]), q=to(seq.gt_q[idx]), v=to(seq.gt_v[idx]),
        p_bc=to(seq.p_bc), q_bc=to(seq.q_bc))


def cam_pose_at(seq: SyntheticSequence, k):
    """World_T_cam of frame(s) `k` (an index or an index array), float64."""
    q_b = seq.gt_q[k]
    q_wc = quat_mul(q_b, seq.q_bc.expand_as(q_b))
    p_wc = seq.gt_p[k] + quat_rotate(q_b, seq.p_bc.expand_as(seq.gt_p[k]))
    return p_wc, q_wc


def _imu_factors(f: WindowFactors, pres, ba, bg, dtype, device) -> WindowFactors:
    """The IMU fields of `f` from nw-1 preintegrations at biases (ba, bg)."""
    stack = lambda xs: torch.stack(xs).to(dtype)  # noqa: E731
    w = len(pres)
    return f._replace(
        imu_alpha=stack([p.alpha for p in pres]),
        imu_beta=stack([p.beta for p in pres]),
        imu_gamma=stack([p.gamma for p in pres]),
        imu_jac=stack([p.jac for p in pres]),
        imu_sqrt_info=stack([imu_ops.sqrt_info_from_cov(p.cov) for p in pres]),
        imu_dt=stack([p.dt_sum for p in pres]),
        imu_ba=torch.as_tensor(np.tile(ba, (w, 1)), dtype=dtype, device=device),
        imu_bg=torch.as_tensor(np.tile(bg, (w, 1)), dtype=dtype, device=device),
        imu_valid=torch.ones((w,), dtype=dtype, device=device),
    )


def _gravity(g_norm, dtype, device):
    return torch.as_tensor([0.0, 0.0, g_norm], dtype=dtype, device=device)


def factors_from_synthetic(
    seq: SyntheticSequence,
    frames,
    cfg: SolverConfig,
    lay: TangentLayout,
    dtype=torch.float64,
    with_lines: bool = True,
    noise: imu_ops.ImuNoise | None = None,
    device=None,
):
    """Pack a ground-truth window over the given frame indices.

    Returns (gt_state, factors) where gt_state holds true poses, true inverse
    depths (anchored in each feature's first observing frame) and true world
    Plücker lines — the solver should reproduce it from perturbations. The
    IMU is preintegrated in `dtype` on `device`, as JAX does in its dtype."""
    nw = lay.nw
    assert len(frames) == nw
    device = resolve_device(device)
    noise = noise or imu_ops.ImuNoise.euroc(dtype, device)
    f = empty_factors(cfg, lay, dtype, device)
    state = gt_window_state(seq, frames, cfg, dtype, device)
    fr = np.asarray(frames)
    to = lambda x: x.to(dtype=dtype, device=device)  # noqa: E731

    # --- IMU preintegrations ---
    pres = []
    for k in range(nw - 1):
        acc, gyr, dt = imu_between(seq, float(seq.frame_t[fr[k]]), float(seq.frame_t[fr[k + 1]]))
        zero = torch.zeros(3, dtype=dtype, device=device)
        pres.append(imu_ops.preintegrate(to(acc), to(gyr), to(dt), zero, zero, noise))
    f = _imu_factors(f, pres, np.zeros(3), np.zeros(3), dtype, device)

    # --- points: choose landmarks observed in ≥2 window frames ---
    vis = seq.obs_valid[fr].numpy()  # [nw, L]
    cand = np.nonzero(vis.sum(axis=0) >= 2)[0][: lay.max_f]
    n = len(cand)
    pt_obs = np.zeros((lay.max_f, nw, 2))
    pt_mask = np.zeros((lay.max_f, nw))
    pt_start = np.zeros(lay.max_f, np.int64)
    pt_valid = np.zeros(lay.max_f)
    inv_depth = np.full(lay.max_f, 0.2)
    if n:
        pt_obs[:n] = seq.obs[fr][:, cand].numpy().transpose(1, 0, 2)
        pt_mask[:n] = vis[:, cand].T
        pt_start[:n] = np.argmax(vis[:, cand], axis=0)  # first observing frame
        pt_valid[:n] = 1.0
        # true inverse depth in the anchor camera
        p_wc, q_wc = cam_pose_at(seq, torch.as_tensor(fr[pt_start[:n]]))
        pc = quat_rotate(quat_conj(q_wc), seq.landmarks[cand] - p_wc)
        inv_depth[:n] = 1.0 / pc[:, 2].numpy()
    f = f._replace(
        pt_obs=torch.as_tensor(pt_obs, dtype=dtype, device=device),
        pt_mask=torch.as_tensor(pt_mask, dtype=dtype, device=device),
        pt_start=torch.as_tensor(pt_start, device=device),
        pt_valid=torch.as_tensor(pt_valid, dtype=dtype, device=device),
    )
    state = state._replace(inv_depth=torch.as_tensor(inv_depth, dtype=dtype, device=device))

    # --- lines ---
    if with_lines:
        lvis = seq.line_obs_valid[fr].numpy()  # [nw, S]
        lcand = np.nonzero(lvis.sum(axis=0) >= 2)[0][: lay.max_l]
        m = len(lcand)
        ln_obs = np.zeros((lay.max_l, nw, 4))
        ln_mask = np.zeros((lay.max_l, nw))
        ln_valid = np.zeros(lay.max_l)
        ln_start = np.zeros(lay.max_l, np.int64)
        line_w = state.line.to(dtype=torch.float64, device="cpu").numpy().copy()
        if m:
            ln_obs[:m] = seq.line_obs[fr][:, lcand].numpy().transpose(1, 0, 2)
            ln_mask[:m] = lvis[:, lcand].T
            ln_valid[:m] = 1.0
            ln_start[:m] = np.argmax(lvis[:, lcand], axis=0)
            line_w[:m] = plucker_from_points(seq.line_sp[lcand], seq.line_ep[lcand]).numpy()
        f = f._replace(
            ln_obs=torch.as_tensor(ln_obs, dtype=dtype, device=device),
            ln_mask=torch.as_tensor(ln_mask, dtype=dtype, device=device),
            ln_valid=torch.as_tensor(ln_valid, dtype=dtype, device=device),
            ln_start=torch.as_tensor(ln_start, device=device),
        )
        state = state._replace(line=torch.as_tensor(line_w, dtype=dtype, device=device))

    f = f._replace(g=_gravity(9.81007, dtype, device))
    return state, f


def _imu_slice_interp(imu_t, acc, gyr, t0: float, t1: float):
    """Samples covering [t0, t1] with linear interpolation AT both
    boundaries — the off-grid analog of `imu_between` (real camera stamps
    do not coincide with IMU ticks; `getMeasurements` pairing semantics)."""
    imu_t = np.asarray(imu_t, np.float64)
    acc = np.asarray(acc, np.float64)
    gyr = np.asarray(gyr, np.float64)

    def at(t):
        i = int(np.clip(np.searchsorted(imu_t, t), 1, len(imu_t) - 1))
        w = (t - imu_t[i - 1]) / max(imu_t[i] - imu_t[i - 1], 1e-12)
        w = float(np.clip(w, 0.0, 1.0))
        return (1 - w) * acc[i - 1] + w * acc[i], (1 - w) * gyr[i - 1] + w * gyr[i]

    lo = int(np.searchsorted(imu_t, t0 + 1e-9))
    hi = int(np.searchsorted(imu_t, t1 - 1e-9))
    a0, g0 = at(t0)
    a1, g1 = at(t1)
    ts = np.concatenate([[t0], imu_t[lo:hi], [t1]])
    accs = np.concatenate([[a0], acc[lo:hi], [a1]])
    gyrs = np.concatenate([[g0], gyr[lo:hi], [g1]])
    return accs, gyrs, np.diff(ts)


def factors_from_tracks(
    kf_t,          # [nw] keyframe timestamps
    kf_ids,        # list of nw int arrays: frontend feature ids per keyframe
    kf_obs,        # list of nw [n_k,2] arrays: normalized obs per keyframe
    imu_t, imu_acc, imu_gyr,   # raw IMU stream
    cfg: SolverConfig,
    lay: TangentLayout,
    ba, bg,        # bias linearization points (live estimates)
    dtype=torch.float64,
    noise: imu_ops.ImuNoise | None = None,
    g_norm: float = 9.81007,
    device=None,
) -> WindowFactors:
    """Pack a window from REAL frontend tracks — the live-pipeline analog of
    `factors_from_synthetic` (no ground truth anywhere): feature ids +
    normalized observations recorded from the image frontends, IMU
    preintegrated over the actual keyframe gaps at the live biases. Depths
    are NOT set here (triangulate from the live poses; `pt_valid` marks
    rows observed ≥2×)."""
    nw = lay.nw
    assert len(kf_t) == nw and len(kf_ids) == nw
    device = resolve_device(device)
    noise = noise or imu_ops.ImuNoise.euroc(dtype, device)
    f = empty_factors(cfg, lay, dtype, device)
    ba = np.asarray(ba, np.float64)
    bg = np.asarray(bg, np.float64)
    T = lambda x: astensor(x, dtype, device)  # noqa: E731

    pres = []
    for k in range(nw - 1):
        acc, gyr, dts = _imu_slice_interp(imu_t, imu_acc, imu_gyr, float(kf_t[k]),
                                          float(kf_t[k + 1]))
        pres.append(imu_ops.preintegrate(T(acc), T(gyr), T(dts), T(ba), T(bg), noise))
    f = _imu_factors(f, pres, ba, bg, dtype, device)

    # --- points: tracks observed in ≥2 of these keyframes, longest first
    # (the best-constrained tracks claim the fixed capacity) ---
    count: dict = {}
    for ids_k in kf_ids:
        for i in np.asarray(ids_k, np.int64):
            count[int(i)] = count.get(int(i), 0) + 1
    cand = sorted((i for i, c in count.items() if c >= 2), key=lambda i: -count[i])[: lay.max_f]
    slot_of = {i: s for s, i in enumerate(cand)}
    pt_obs = np.zeros((lay.max_f, nw, 2))
    pt_mask = np.zeros((lay.max_f, nw))
    for k in range(nw):
        obs_k = np.asarray(kf_obs[k], np.float64)
        for j, i in enumerate(np.asarray(kf_ids[k], np.int64)):
            s = slot_of.get(int(i))
            if s is not None:
                pt_obs[s, k] = obs_k[j]
                pt_mask[s, k] = 1.0
    pt_start = np.where(pt_mask.any(axis=1), np.argmax(pt_mask > 0, axis=1), 0)
    pt_valid = (pt_mask.sum(axis=1) >= 2).astype(np.float64)
    return f._replace(
        pt_obs=T(pt_obs),
        pt_mask=T(pt_mask),
        pt_start=astensor(pt_start, torch.int64, device),
        pt_valid=T(pt_valid),
        g=_gravity(g_norm, dtype, device),
    )
