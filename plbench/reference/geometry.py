"""Rotation / quaternion utilities on torch tensors (batched over leading axes).

Counterpart of `plslam/utils/geometry.py`; same conventions:

* Quaternions are Hamilton, stored ``[w, x, y, z]``, unit norm.
* ``quat_to_rot(q) @ v`` rotates a vector from the frame the quaternion
  represents into the parent frame (``R_wb = quat_to_rot(q_wb)``).
* Small-angle box-plus: ``q ⊞ dθ = q ⊗ exp([0, dθ/2])`` (right perturbation).
* Angles in radians everywhere.

Every function is written so that `torch.func.jacfwd` can differentiate it:
no in-place updates, and square-root arguments are sanitised before the
square root (a `torch.where` whose unselected branch is NaN still poisons
forward-mode tangents).
"""
from __future__ import annotations

import torch

_EPS = 1e-9


def cross(a, b):
    """Cross product over the last axis (broadcasting)."""
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def skew(v):
    """3-vector -> 3x3 skew-symmetric matrix. Batched over leading axes."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def quat_identity(dtype=torch.float32, device=None):
    # made by fills on the device: a host list copied to the card, or an
    # element set from a Python number, waits for the card's queue
    return torch.cat([torch.ones(1, dtype=dtype, device=device),
                      torch.zeros(3, dtype=dtype, device=device)])


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_conj(q):
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_mul(q1, q2):
    """Hamilton product q1 ⊗ q2 ([w,x,y,z])."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion q: R(q) v."""
    qv = q[..., 1:4]
    w = q[..., 0:1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_to_rot(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R):
    """Rotation matrix -> unit quaternion [w,x,y,z], branchless (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t0 = 1.0 + m00 + m11 + m22
    t1 = 1.0 + m00 - m11 - m22
    t2 = 1.0 - m00 + m11 - m22
    t3 = 1.0 - m00 - m11 + m22
    q0 = torch.stack([t0, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    q1 = torch.stack([m21 - m12, t1, m01 + m10, m02 + m20], dim=-1)
    q2 = torch.stack([m02 - m20, m01 + m10, t2, m12 + m21], dim=-1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, t3], dim=-1)
    ts = torch.stack([t0, t1, t2, t3], dim=-1)
    idx = torch.argmax(ts, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = quat_normalize(q)
    # canonical sign: w >= 0
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def quat_exp(dtheta):
    """exp map R^3 -> quaternion: rotation of angle |dθ| about dθ/|dθ|.

    AD-safe at dθ=0: the norm is never sqrt'ed at zero (the argument is
    sanitised before the sqrt so forward-mode tangents stay finite — this
    function sits at the linearisation point of every jacfwd in the solver)."""
    half = 0.5 * dtheta
    a2 = torch.sum(half * half, dim=-1, keepdim=True)
    small = a2 < _EPS * _EPS
    a = torch.sqrt(torch.where(small, torch.ones_like(a2), a2))
    s = torch.where(small, 1.0 - a2 / 6.0, torch.sin(a) / a)
    w = torch.where(small, 1.0 - a2 / 2.0, torch.cos(a))
    return torch.cat([w, s * half], dim=-1)


def quat_log(q):
    """log map: quaternion -> R^3 rotation vector (angle*axis). AD-safe at
    identity (see quat_exp)."""
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    qv = q[..., 1:4]
    n2 = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = n2 < _EPS * _EPS
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), angle / n)
    return scale * qv


def quat_box_plus(q, dtheta):
    """q ⊞ dθ = q ⊗ exp(dθ) — right (body-frame) perturbation."""
    return quat_normalize(quat_mul(q, quat_exp(dtheta)))


def quat_box_minus(q2, q1):
    """q2 ⊟ q1 = 2·vec(q1⁻¹ ⊗ q2)."""
    dq = quat_mul(quat_conj(q1), q2)
    dq = dq * torch.where(dq[..., 0:1] < 0, -1.0, 1.0)
    return 2.0 * dq[..., 1:4]


def so3_exp(dtheta):
    return quat_to_rot(quat_exp(dtheta))


def so3_log(R):
    return quat_log(rot_to_quat(R))


def ypr_to_rot(ypr):
    """[yaw, pitch, roll] (radians) -> R = Rz(y) Ry(p) Rx(r)."""
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def rot_to_ypr(R):
    """R -> [yaw, pitch, roll] radians."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.atan2(-R[..., 2, 0], torch.hypot(R[..., 2, 1], R[..., 2, 2]))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def _any_orthogonal(a):
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    h = torch.where(torch.abs(a[..., 0:1]) < 0.9, ex * torch.ones_like(a), ey * torch.ones_like(a))
    o = cross(a, h)
    return o / torch.linalg.norm(o, dim=-1, keepdim=True)


def rot_from_two_vectors(a, b):
    """Rotation taking direction a to direction b (Eigen FromTwoVectors)."""
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    c = cross(a, b)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    s = torch.linalg.norm(c, dim=-1, keepdim=True)
    angle = torch.atan2(s, d)
    axis = torch.where(s > _EPS, c / torch.where(s > _EPS, s, torch.ones_like(s)),
                       _any_orthogonal(a))
    return so3_exp(axis * angle)


def gravity_to_rot(g):
    """`Utility::g2R`: rotation R0 s.t. R0 @ ĝ = [0,0,1] with yaw(R0)=0."""
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=g.dtype, device=g.device)
    R0 = rot_from_two_vectors(g, ez)
    yaw = rot_to_ypr(R0)[..., 0]
    z = torch.zeros_like(yaw)
    Ry = ypr_to_rot(torch.stack([-yaw, z, z], dim=-1))
    return Ry @ R0


def pose_inverse(p, q):
    """Invert transform x_b = R(q) x_a + p  ->  (p', q') with x_a = R(q') x_b + p'."""
    qi = quat_conj(q)
    return -quat_rotate(qi, p), qi
