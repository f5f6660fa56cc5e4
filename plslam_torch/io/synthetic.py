"""Synthetic visual-inertial sequence generator (ground-truth-exact).

Counterpart of `plslam/io/synthetic.py`: a C∞ trajectory whose derivatives
come from forward-mode autodiff (`torch.func.jvp`), from which IMU samples,
camera point observations and line-segment observations are synthesized
exactly. The numpy RNG is drawn in the same order as the JAX package, so the
same `seed` gives the same sequence. Arrays are float64 CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plslam_torch.ops.cameras import PinholeRadTan, cam_to, project
from plslam_torch.utils.geometry import quat_to_rot, rot_to_quat, ypr_to_rot

G_WORLD = np.array([0.0, 0.0, 9.81007])


class TrajectoryParams(NamedTuple):
    radius: float = 4.0
    omega: float = 0.6  # rad/s around the circle
    z_amp: float = 0.6
    z_omega: float = 1.1
    pitch_amp: float = 0.12
    roll_amp: float = 0.1
    # decaying multi-axis initialization-excitation preamble (EuRoC pilots
    # excite the IMU before flying)
    wiggle_amp: float = 0.0  # m (0 = off)
    wiggle_omega: float = 5.0  # rad/s
    wiggle_tau: float = 1.5  # decay time constant (s)
    # persistent non-decaying excitation (keeps scale/bias observable)
    excite_amp: float = 0.0  # m (0 = off)
    excite_omega: float = 3.1  # rad/s


def _pos_fn(params: TrajectoryParams):
    r, w, za, zw = params.radius, params.omega, params.z_amp, params.z_omega
    wa, wo, wt = params.wiggle_amp, params.wiggle_omega, params.wiggle_tau
    ea, eo = params.excite_amp, params.excite_omega

    def pos(t):  # t [M] -> [M,3]
        p = torch.stack([r * torch.cos(w * t), r * torch.sin(w * t),
                         za * torch.sin(zw * t) + 1.5], dim=-1)
        if wa != 0.0:
            env = (wa * torch.exp(-t / wt))[..., None]
            p = p + env * torch.stack([torch.sin(wo * t), torch.sin(1.31 * wo * t + 0.7),
                                       torch.sin(0.73 * wo * t + 1.4)], dim=-1)
        if ea != 0.0:
            p = p + ea * torch.stack([torch.sin(eo * t + 0.3), torch.sin(1.27 * eo * t + 2.1),
                                      torch.sin(0.81 * eo * t + 0.9)], dim=-1)
        return p

    return pos


def _rot_fn(params: TrajectoryParams):
    w, pa, ra = params.omega, params.pitch_amp, params.roll_amp

    def rot(t):  # t [M] -> [M,3,3]; yaw follows the tangent
        ypr = torch.stack([w * t + np.pi / 2.0, pa * torch.sin(0.9 * w * t),
                           ra * torch.cos(1.3 * w * t)], dim=-1)
        return ypr_to_rot(ypr)

    return rot


def _d_dt(fn, t):
    """Elementwise time derivative of a trajectory function over a batch of times."""
    return torch.func.jvp(fn, (t,), (torch.ones_like(t),))[1]


def gt_pose(params: TrajectoryParams, t):
    """Ground-truth poses at times t [M]: (p_w [M,3], q_wb [M,4])."""
    return _pos_fn(params)(t), rot_to_quat(_rot_fn(params)(t))


def gt_velocity(params: TrajectoryParams, t):
    return _d_dt(_pos_fn(params), t)


def imu_sample(params: TrajectoryParams, t):
    """Exact body-frame IMU at times t [M] (bias-free, noise-free):
    f_b = R_wbᵀ (p̈_w + G), ω_b = vee(R_wbᵀ Ṙ_wb)."""
    pos, rot = _pos_fn(params), _rot_fn(params)
    a = _d_dt(lambda s: _d_dt(pos, s), t)
    R = rot(t)
    Om = R.transpose(-1, -2) @ _d_dt(rot, t)
    omega = torch.stack([Om[..., 2, 1], Om[..., 0, 2], Om[..., 1, 0]], dim=-1)
    g = torch.as_tensor(G_WORLD, dtype=t.dtype)
    acc = torch.einsum("mji,mj->mi", R, a + g)
    return acc, omega


class SyntheticSequence(NamedTuple):
    """A fully-sampled synthetic VI sequence (float64 CPU tensors)."""

    imu_t: torch.Tensor  # [M]
    imu_acc: torch.Tensor  # [M,3]  (with noise/bias if requested)
    imu_gyr: torch.Tensor  # [M,3]
    frame_t: torch.Tensor  # [F]
    gt_p: torch.Tensor  # [F,3]
    gt_q: torch.Tensor  # [F,4]
    gt_v: torch.Tensor  # [F,3]
    landmarks: torch.Tensor  # [L,3]
    obs: torch.Tensor  # [F,L,2] normalized coords
    obs_valid: torch.Tensor  # [F,L] bool
    line_sp: torch.Tensor  # [S,3]
    line_ep: torch.Tensor  # [S,3]
    line_obs: torch.Tensor  # [F,S,4] normalized (sx,sy,ex,ey)
    line_obs_valid: torch.Tensor  # [F,S] bool
    p_bc: torch.Tensor  # [3] body_T_cam
    q_bc: torch.Tensor  # [4]
    ba: torch.Tensor  # [3] true biases of the IMU stream
    bg: torch.Tensor  # [3]


def make_sequence(duration: float = 20.0, imu_hz: float = 200.0, cam_hz: float = 20.0,
                  n_points: int = 160, n_lines: int = 64,
                  params: TrajectoryParams = TrajectoryParams(),
                  acc_noise: float = 0.0, gyr_noise: float = 0.0,
                  acc_bias: float = 0.0, gyr_bias: float = 0.0, pix_noise: float = 0.0,
                  cam: PinholeRadTan | None = None, seed: int = 0,
                  dtype=torch.float64) -> SyntheticSequence:
    rng = np.random.default_rng(seed)
    cam = PinholeRadTan.euroc_cam0(dtype) if cam is None else cam_to(cam, dtype, torch.device("cpu"))
    T = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype)  # noqa: E731

    # body_T_cam: camera looks along body +x (forward), standard z-forward cam
    R_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    p_bc = np.array([0.05, 0.02, 0.0])
    q_bc = rot_to_quat(T(R_bc))

    imu_t = np.arange(0.0, duration + 0.5 / imu_hz, 1.0 / imu_hz)
    frame_t = np.arange(0.0, duration, 1.0 / cam_hz)
    acc, gyr = imu_sample(params, T(imu_t))
    ba = acc_bias * rng.standard_normal(3)
    bg = gyr_bias * rng.standard_normal(3)
    acc = acc.numpy() + ba + acc_noise * rng.standard_normal((len(imu_t), 3))
    gyr = gyr.numpy() + bg + gyr_noise * rng.standard_normal((len(imu_t), 3))

    fts = T(frame_t)
    gt_p, gt_q = gt_pose(params, fts)
    gt_v = gt_velocity(params, fts)

    # landmarks on a cylinder shell around the trajectory
    theta = rng.uniform(0, 2 * np.pi, n_points)
    rad = params.radius + rng.uniform(2.0, 6.0, n_points)
    zs = rng.uniform(-1.5, 4.0, n_points)
    landmarks = np.stack([rad * np.cos(theta), rad * np.sin(theta), zs], axis=-1)

    # vertical-ish and horizontal-ish line segments on the same shell
    theta_l = rng.uniform(0, 2 * np.pi, n_lines)
    rad_l = params.radius + rng.uniform(2.0, 6.0, n_lines)
    z0 = rng.uniform(-1.0, 3.0, n_lines)
    vert = rng.uniform(size=n_lines) < 0.6
    dtheta = np.where(vert, 0.0, rng.uniform(0.05, 0.25, n_lines))
    dz = np.where(vert, rng.uniform(0.8, 2.5, n_lines), rng.uniform(-0.3, 0.3, n_lines))
    line_sp = np.stack([rad_l * np.cos(theta_l), rad_l * np.sin(theta_l), z0], axis=-1)
    line_ep = np.stack([rad_l * np.cos(theta_l + dtheta), rad_l * np.sin(theta_l + dtheta), z0 + dz],
                       axis=-1)

    R_wc = quat_to_rot(gt_q) @ T(R_bc)  # [F,3,3]
    p_wc = gt_p + torch.einsum("fij,j->fi", quat_to_rot(gt_q), T(p_bc))

    def cam_points(pts):  # [L,3] -> [F,L,3] == R_wcᵀ (pts − p_wc)
        return torch.einsum("flj,fji->fli", pts[None] - p_wc[:, None], R_wc)

    def in_img(uv):
        return (uv[..., 0] > 5) & (uv[..., 0] < 747) & (uv[..., 1] > 5) & (uv[..., 1] < 475)

    lm = T(landmarks)
    pc = cam_points(lm)
    obs = pc[..., 0:2] / torch.clamp(pc[..., 2:3], min=1e-6)
    obs_valid = (pc[..., 2] > 0.3) & in_img(project(cam, pc))

    sp3, ep3 = T(line_sp), T(line_ep)
    pcs, pce = cam_points(sp3), cam_points(ep3)
    mns = pcs[..., 0:2] / torch.clamp(pcs[..., 2:3], min=1e-6)
    mne = pce[..., 0:2] / torch.clamp(pce[..., 2:3], min=1e-6)
    line_obs = torch.cat([mns, mne], dim=-1)
    line_obs_valid = ((pcs[..., 2] > 0.3) & (pce[..., 2] > 0.3)
                      & in_img(project(cam, pcs)) & in_img(project(cam, pce)))

    if pix_noise > 0:
        f = float(cam.fx)
        obs = obs + T(rng.standard_normal(tuple(obs.shape)) * pix_noise / f)
        line_obs = line_obs + T(rng.standard_normal(tuple(line_obs.shape)) * pix_noise / f)

    return SyntheticSequence(
        imu_t=T(imu_t), imu_acc=T(acc), imu_gyr=T(gyr), frame_t=fts,
        gt_p=gt_p, gt_q=gt_q, gt_v=gt_v, landmarks=lm, obs=obs, obs_valid=obs_valid,
        line_sp=sp3, line_ep=ep3, line_obs=line_obs, line_obs_valid=line_obs_valid,
        p_bc=T(p_bc), q_bc=q_bc, ba=T(ba), bg=T(bg),
    )
