"""Pure-numpy quaternion ops for host-side hot paths.

A copy of `plslam/utils/quat_np.py`: importing that module runs
`plslam/utils/__init__.py`, which imports JAX, so the port keeps its own.

The estimator's 200 Hz dead-reckoning (`Estimator::processIMU` prediction in
the reference) and the per-frame table bookkeeping run on the host; routing
them through device tensors would cost several launches per IMU sample.
These mirror `plslam_torch/utils/geometry.py` (wxyz Hamilton convention) in
numpy. All ops broadcast over leading batch dims.
"""
from __future__ import annotations

import numpy as np


def quat_mul(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def quat_conj(q):
    q = np.asarray(q, np.float64)
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_normalize(q):
    q = np.asarray(q, np.float64)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def quat_exp(v):
    """Exponential map: rotation vector → quaternion."""
    v = np.asarray(v, np.float64)
    th = np.linalg.norm(v, axis=-1, keepdims=True)
    half = 0.5 * th
    small = th < 1e-8
    k = np.where(small, 0.5, np.sin(half) / np.maximum(th, 1e-12))
    w = np.cos(half)
    return np.concatenate([w, k * v], axis=-1)


def quat_rotate(q, p):
    """Rotate vector(s) p by quaternion(s) q."""
    q = np.asarray(q, np.float64)
    p = np.asarray(p, np.float64)
    qv = q[..., 1:]
    qw = q[..., :1]
    t = 2.0 * np.cross(qv, p)
    return p + qw * t + np.cross(qv, t)


def quat_to_rot(q):
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(R):
    """Shepperd's method (single matrix)."""
    R = np.asarray(R, np.float64)
    m00, m11, m22 = R[0, 0], R[1, 1], R[2, 2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif m00 > m11 and m00 > m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif m11 > m22:
        s = np.sqrt(1.0 + m11 - m00 - m22) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m22 - m00 - m11) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return quat_normalize(np.array([w, x, y, z]))


def ypr_to_rot(ypr):
    """[..., 3] [yaw, pitch, roll] (radians) -> R = Rz(y) Ry(p) Rx(r)
    (numpy mirror of `geometry.ypr_to_rot` for host hot paths)."""
    ypr = np.asarray(ypr, np.float64)
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    return np.stack([
        np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
        np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
        np.stack([-sp, cp * sr, cp * cr], axis=-1),
    ], axis=-2)


def rot_to_ypr(R):
    """R -> [yaw, pitch, roll] radians (numpy mirror of geometry.rot_to_ypr)."""
    R = np.asarray(R, np.float64)
    yaw = np.arctan2(R[..., 1, 0], R[..., 0, 0])
    pitch = np.arctan2(-R[..., 2, 0], np.hypot(R[..., 2, 1], R[..., 2, 2]))
    roll = np.arctan2(R[..., 2, 1], R[..., 2, 2])
    return np.stack([yaw, pitch, roll], axis=-1)
