"""IMU midpoint preintegration + the 15-dim IMU factor residual.

Counterpart of `plslam/ops/imu.py` (the reference's `IntegrationBase` and
`IMUFactor`). Error-state ordering ``[δα(3), δθ(3), δβ(3), δba(3), δbg(3)]``;
the 18-dim noise is ``[n_a0, n_w0, n_a1, n_w1, n_ba, n_bg]``.

The midpoint recursion is associative, so `preintegrate` runs it in log₂N
rounds instead of N sequential steps:
  * γᵢ is the prefix quaternion product of the per-step increments
    exp(ω̄ᵢ δtᵢ) (a Hillis-Steele scan, normalized once);
  * with every γᵢ known, α/β are (nested) prefix sums;
  * the error-state pair composes as the monoid
    (F₂,Q₂)∘(F₁,Q₁) = (F₂F₁, F₂Q₁F₂ᵀ+Q₂); only its total is used, so a
    pairwise tree reduction of batched 15×15 matmuls is enough.
Padded steps (δt = 0) are exact identities of every operation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from plslam_torch.utils.geometry import (
    quat_box_minus,
    quat_conj,
    quat_exp,
    quat_identity,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_rot,
    skew,
)


class ImuNoise(NamedTuple):
    acc_n: torch.Tensor  # accelerometer white noise density
    gyr_n: torch.Tensor  # gyroscope white noise density
    acc_w: torch.Tensor  # accelerometer bias random walk
    gyr_w: torch.Tensor  # gyroscope bias random walk

    @staticmethod
    def create(acc_n, gyr_n, acc_w, gyr_w, dtype=torch.float32, device=None):
        return ImuNoise(*[torch.as_tensor(float(v), dtype=dtype, device=device)
                          for v in (acc_n, gyr_n, acc_w, gyr_w)])

    @staticmethod
    def euroc(dtype=torch.float32, device=None):
        return ImuNoise.create(0.08, 0.004, 4e-5, 2e-6, dtype=dtype, device=device)


class Preintegration(NamedTuple):
    """Preintegrated IMU delta between two frames (the `IntegrationBase` state)."""

    alpha: torch.Tensor  # [3]  Δp in frame i
    beta: torch.Tensor  # [3]  Δv in frame i
    gamma: torch.Tensor  # [4]  Δq (wxyz)
    jac: torch.Tensor  # [15,15] d(delta)/d(initial error state)
    cov: torch.Tensor  # [15,15] covariance of the error state
    dt_sum: torch.Tensor  # [] total integration time
    ba: torch.Tensor  # [3] linearisation accel bias
    bg: torch.Tensor  # [3] linearisation gyro bias


def _noise_diag(noise: ImuNoise, dtype, device):
    vals = [noise.acc_n ** 2, noise.gyr_n ** 2, noise.acc_n ** 2, noise.gyr_n ** 2,
            noise.acc_w ** 2, noise.gyr_w ** 2]
    return torch.cat([torch.as_tensor(v, dtype=dtype, device=device).reshape(1).expand(3)
                      for v in vals])


def _prefix_quat(dqs):
    """Inclusive prefix products dq₀ ⊗ dq₁ ⊗ … ⊗ dqᵢ (Hillis-Steele scan)."""
    n = dqs.shape[0]
    g = dqs
    d = 1
    while d < n:
        g = torch.cat([g[:d], quat_mul(g[:-d], g[d:])], dim=0)
        d *= 2
    return g


def _total_transition(F, Q):
    """Fold the monoid (F,Q) over all steps in order, as a pairwise tree."""
    while F.shape[0] > 1:
        if F.shape[0] % 2:
            eye = torch.eye(15, dtype=F.dtype, device=F.device)[None]
            F = torch.cat([F, eye], dim=0)
            Q = torch.cat([Q, torch.zeros_like(Q[:1])], dim=0)
        A1, A2 = F[0::2], F[1::2]
        Q1, Q2 = Q[0::2], Q[1::2]
        F = A2 @ A1
        Q = A2 @ Q1 @ A2.transpose(-1, -2) + Q2
    return F[0], Q[0]


def _midpoint(acc, gyr, dt, ba, bg):
    """The midpoint recursion's (α, β, γ_{1..n}, γ_{0..n-1}, ω̄, a₀ − ba,
    a₁ − ba) over n ≥ 1 steps."""
    dtype, device = acc.dtype, acc.device
    dtc = dt[:, None]
    w_mid = 0.5 * (gyr[:-1] + gyr[1:]) - bg  # [n,3]
    dqs = quat_exp(w_mid * dtc)  # [n,4] per-step increments
    gamma_new = quat_normalize(_prefix_quat(dqs))  # [n,4] γ_{i+1}
    gamma_prev = torch.cat([quat_identity(dtype, device)[None], gamma_new[:-1]], dim=0)

    a0 = acc[:-1] - ba
    a1 = acc[1:] - ba
    a_mid = 0.5 * (quat_rotate(gamma_prev, a0) + quat_rotate(gamma_new, a1))  # [n,3]
    db = a_mid * dtc  # per-step Δβ
    beta_prefix = torch.cat(
        [torch.zeros((1, 3), dtype=dtype, device=device), torch.cumsum(db, dim=0)[:-1]], dim=0)
    beta = beta_prefix[-1] + db[-1]
    alpha = torch.sum(beta_prefix * dtc + 0.5 * a_mid * dtc * dt[:, None], dim=0)
    return alpha, beta, gamma_new, gamma_prev, w_mid, a0, a1


def dead_reckon(p, v, q, acc, gyr, dt, ba, bg, g):
    """The host's per-sample midpoint dead-reckoning of a state (p, v, q)
    (`Estimator._deadreckon_step` over N ≥ 1 samples) at once: the
    orientation of each sample is q ⊗ γᵢ normalized, the first one q as
    given, and the world-frame midpoint accelerations are summed as the
    host sums them. Returns (p, v, q)."""
    _, _, gamma_new, _, _, a0, a1 = _midpoint(acc, gyr, dt, ba, bg)
    q_new = quat_normalize(quat_mul(q.expand_as(gamma_new), gamma_new))  # [n,4]
    q_prev = torch.cat([q[None], q_new[:-1]], dim=0)
    a_mid = 0.5 * ((quat_rotate(q_prev, a0) - g) + (quat_rotate(q_new, a1) - g))
    dtc = dt[:, None]
    dv = a_mid * dtc
    v_prev = v + torch.cat([torch.zeros_like(dv[:1]), torch.cumsum(dv, dim=0)[:-1]], dim=0)
    p_out = p + torch.sum(v_prev * dtc + 0.5 * a_mid * dtc * dtc, dim=0)
    return p_out, v + torch.sum(dv, dim=0), q_new[-1]


def _midpoint_step(carry, inp, noise_q):
    """One midpoint step (the body of `midPointIntegration`): the carry
    (α, β, γ, J, P, t) advanced by one sample pair
    (acc₀, gyr₀, acc₁, gyr₁, δt, ba, bg)."""
    alpha, beta, gamma, J, P, t = carry
    acc0, gyr0, acc1, gyr1, dt, ba, bg = inp
    dtype, device = alpha.dtype, alpha.device

    w_mid = 0.5 * (gyr0 + gyr1) - bg
    gamma_new = quat_normalize(quat_mul(gamma, quat_exp(w_mid * dt)))
    R0 = quat_to_rot(gamma)
    R1 = quat_to_rot(gamma_new)
    a0 = acc0 - ba
    a1 = acc1 - ba
    a_mid = 0.5 * (quat_rotate(gamma, a0) + quat_rotate(gamma_new, a1))
    alpha_new = alpha + beta * dt + 0.5 * a_mid * dt * dt
    beta_new = beta + a_mid * dt

    # error-state jacobians (the reference's midpoint F, V)
    I3 = torch.eye(3, dtype=dtype, device=device)
    sk_w = skew(w_mid)
    R1a1 = R1 @ skew(a1)
    x = R0 @ skew(a0) + R1a1 @ (I3 - sk_w * dt)
    F = torch.zeros((15, 15), dtype=dtype, device=device)
    F[0:3, 0:3] = I3
    F[0:3, 3:6] = -0.25 * dt * dt * x
    F[0:3, 6:9] = I3 * dt
    F[0:3, 9:12] = -0.25 * (R0 + R1) * dt * dt
    F[0:3, 12:15] = 0.25 * R1a1 * dt * dt * dt
    F[3:6, 3:6] = I3 - sk_w * dt
    F[3:6, 12:15] = -I3 * dt
    F[6:9, 3:6] = -0.5 * dt * x
    F[6:9, 6:9] = I3
    F[6:9, 9:12] = -0.5 * (R0 + R1) * dt
    F[6:9, 12:15] = 0.5 * R1a1 * dt * dt
    F[9:12, 9:12] = I3
    F[12:15, 12:15] = I3

    V = torch.zeros((15, 18), dtype=dtype, device=device)
    V[0:3, 0:3] = 0.25 * R0 * dt * dt
    v01 = -0.125 * R1a1 * dt * dt * dt
    V[0:3, 3:6] = v01
    V[0:3, 6:9] = 0.25 * R1 * dt * dt
    V[0:3, 9:12] = v01
    V[3:6, 3:6] = 0.5 * I3 * dt
    V[3:6, 9:12] = 0.5 * I3 * dt
    V[6:9, 0:3] = 0.5 * R0 * dt
    v61 = -0.25 * R1a1 * dt * dt
    V[6:9, 3:6] = v61
    V[6:9, 6:9] = 0.5 * R1 * dt
    V[6:9, 9:12] = v61
    V[9:12, 12:15] = I3 * dt
    V[12:15, 15:18] = I3 * dt

    P_new = F @ P @ F.T + (V * noise_q[None, :]) @ V.T
    return alpha_new, beta_new, gamma_new, F @ J, P_new, t + dt


def preintegrate_sequential(acc, gyr, dt, ba, bg, noise: ImuNoise) -> Preintegration:
    """The reference-shaped sequential recursion (`IntegrationBase::
    propagate` one step after another, each depending on the last): the
    ground truth `preintegrate` is held against. Not on the solver's path."""
    dtype, device = acc.dtype, acc.device
    ba = torch.as_tensor(ba, dtype=dtype, device=device)
    bg = torch.as_tensor(bg, dtype=dtype, device=device)
    noise_q = _noise_diag(noise, dtype, device)
    carry = (torch.zeros(3, dtype=dtype, device=device), torch.zeros(3, dtype=dtype, device=device),
             quat_identity(dtype, device), torch.eye(15, dtype=dtype, device=device),
             torch.zeros((15, 15), dtype=dtype, device=device),
             torch.zeros((), dtype=dtype, device=device))
    for i in range(dt.shape[0]):
        carry = _midpoint_step(carry, (acc[i], gyr[i], acc[i + 1], gyr[i + 1], dt[i], ba, bg),
                               noise_q)
    return Preintegration(*carry, ba, bg)


def preintegrate(acc, gyr, dt, ba, bg, noise: ImuNoise) -> Preintegration:
    """Integrate N steps from boundary samples acc/gyr [N+1,3], dt [N]
    (`IntegrationBase::propagate` over the whole buffer; `repropagate` is
    calling this again with new biases)."""
    dtype, device = acc.dtype, acc.device
    n = dt.shape[0]
    ba = torch.as_tensor(ba, dtype=dtype, device=device)
    bg = torch.as_tensor(bg, dtype=dtype, device=device)
    if n == 0:  # empty buffer → identity preintegration
        return Preintegration(
            torch.zeros(3, dtype=dtype, device=device), torch.zeros(3, dtype=dtype, device=device),
            quat_identity(dtype, device), torch.eye(15, dtype=dtype, device=device),
            torch.zeros((15, 15), dtype=dtype, device=device),
            torch.zeros((), dtype=dtype, device=device), ba, bg)
    noise_q = _noise_diag(noise, dtype, device)
    I3 = torch.eye(3, dtype=dtype, device=device)
    dtc = dt[:, None]
    alpha, beta, gamma_new, gamma_prev, w_mid, a0, a1 = _midpoint(acc, gyr, dt, ba, bg)

    # batched F [n,15,15], V-noise Q [n,15,15] (the midpoint step's algebra)
    R0 = quat_to_rot(gamma_prev)
    R1 = quat_to_rot(gamma_new)
    sk_w = skew(w_mid)
    R0a0 = R0 @ skew(a0)
    R1a1 = R1 @ skew(a1)
    d1 = dtc[..., None]  # [n,1,1]
    x = R0a0 + R1a1 @ (I3 - sk_w * d1)

    Z = torch.zeros((n, 3, 3), dtype=dtype, device=device)
    In = I3.expand(n, 3, 3)
    row = lambda *bs: torch.cat(bs, dim=-1)  # noqa: E731
    F = torch.cat([
        row(In, -0.25 * d1 * d1 * x, In * d1, -0.25 * (R0 + R1) * d1 * d1,
            0.25 * R1a1 * d1 * d1 * d1),
        row(Z, In - sk_w * d1, Z, Z, -In * d1),
        row(Z, -0.5 * d1 * x, In, -0.5 * (R0 + R1) * d1, 0.5 * R1a1 * d1 * d1),
        row(Z, Z, Z, In, Z),
        row(Z, Z, Z, Z, In),
    ], dim=-2)  # [n,15,15]
    v01 = -0.125 * R1a1 * d1 * d1 * d1
    v61 = -0.25 * R1a1 * d1 * d1
    V = torch.cat([
        row(0.25 * R0 * d1 * d1, v01, 0.25 * R1 * d1 * d1, v01, Z, Z),
        row(Z, 0.5 * In * d1, Z, 0.5 * In * d1, Z, Z),
        row(0.5 * R0 * d1, v61, 0.5 * R1 * d1, v61, Z, Z),
        row(Z, Z, Z, Z, In * d1, Z),
        row(Z, Z, Z, Z, Z, In * d1),
    ], dim=-2)  # [n,15,18]
    Q = (V * noise_q[None, None, :]) @ V.transpose(-1, -2)  # [n,15,15]

    A_tot, Q_tot = _total_transition(F, Q)
    return Preintegration(alpha, beta, gamma_new[-1], A_tot, Q_tot, torch.sum(dt), ba, bg)


def bias_corrected_delta(pre: Preintegration, ba, bg):
    """First-order bias correction of (α, β, γ) (`IntegrationBase::evaluate` preamble)."""
    dba = ba - pre.ba
    dbg = bg - pre.bg
    jac = pre.jac
    alpha = pre.alpha + _mv(jac[..., 0:3, 9:12], dba) + _mv(jac[..., 0:3, 12:15], dbg)
    beta = pre.beta + _mv(jac[..., 6:9, 9:12], dba) + _mv(jac[..., 6:9, 12:15], dbg)
    gamma = quat_normalize(quat_mul(pre.gamma, quat_exp(_mv(jac[..., 3:6, 12:15], dbg))))
    return alpha, beta, gamma


def _mv(M, x):
    return torch.einsum("...ij,...j->...i", M, x)


def nan_where_failed(L, info):
    """Give a failed factorization NaN entries, as JAX's Cholesky does; the
    LM step and the RANSAC scoring rely on that to reject degenerate cases."""
    bad = (info > 0).reshape(*info.shape, 1, 1)
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def cholesky(A):
    """Lower Cholesky factor with NaN on failure (no host synchronisation)."""
    L, info = torch.linalg.cholesky_ex(A)
    return nan_where_failed(L, info)


def sqrt_info_from_cov(P, jitter=None):
    """Whitening matrix S with SᵀS = P⁻¹, factored on the diagonally-SCALED
    covariance (unit diagonal keeps Cholesky well-conditioned in float32,
    where the raw diagonal spans ~11 decades):
        P = D P̃ D,  P̃ = L̃L̃ᵀ,  S = L̃⁻¹ D⁻¹."""
    dtype = P.dtype
    if jitter is None:
        jitter = 1e-10 if dtype == torch.float64 else 1e-6
    n = P.shape[-1]
    P = 0.5 * (P + P.transpose(-1, -2))
    d = torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1), min=1e-30)
    s = 1.0 / torch.sqrt(d)
    Pn = P * s[..., :, None] * s[..., None, :]
    Pn = Pn + jitter * torch.eye(n, dtype=dtype, device=P.device)
    Ln = cholesky(Pn)
    return torch.linalg.solve_triangular(Ln, torch.diag_embed(s), upper=False)


def imu_residual(p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, pre: Preintegration, g):
    """Unwhitened 15-dim IMU residual (`IMUFactor::Evaluate`), batched over
    leading axes of the states and of `pre`."""
    dt = pre.dt_sum[..., None]
    alpha, beta, gamma = bias_corrected_delta(pre, ba_i, bg_i)
    qi_inv = quat_conj(q_i)
    r_p = quat_rotate(qi_inv, p_j - p_i - v_i * dt + 0.5 * g * dt * dt) - alpha
    q_ij = quat_mul(qi_inv, q_j)
    r_th = quat_box_minus(q_ij, gamma)
    r_v = quat_rotate(qi_inv, v_j - v_i + g * dt) - beta
    r_ba = ba_j - ba_i
    r_bg = bg_j - bg_i
    return torch.cat([r_p, r_th, r_v, r_ba, r_bg], dim=-1)
