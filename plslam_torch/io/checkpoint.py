"""Whole-estimator checkpoint and resume, in the JAX package's format.

Counterpart of `plslam/io/checkpoint.py`, with its npz keys, shapes and
meanings: a checkpoint written by either package loads into the other. The
host state (window poses, velocities, biases, extrinsic, td, the feature
tables, the IMU interval buffers and the open interval's boundary sample)
is saved as it is; the device state (the marginalization prior and the
interval preintegrations) is read back with one wait on save and rebuilt on
`est.device` in `est.dtype` on load (`convert.prior_from_numpy` for the
prior). The preintegrations are saved, not recomputed on load: each was
linearized at the bias estimate of its time, and recomputing it at later
biases would change every IMU factor.

A solve that `process_frame(defer_solve=True)` left pending is neither run
nor saved, as in JAX: the checkpoint holds the window before that solve,
with the next interval's open buffer already appended.

Not in the format, and reset by `clear_state` on load in both packages: the
relocalization request and result (`relo`, `relo_result`), the keyframe
snapshot of the last solve (`_kf_snapshot`), `solves_since_init` and the
post-init health gate's count, a pending solve, the extrinsic calibration's
state (`ex_calibrated`, the hand-eye pairs `_ex_qcam` / `_ex_qimu`). The
metrics log is kept as it is.

The CUDA graphs of the estimator's LM solve and marginalization
(`est._graphs`) stay valid across a load: a graph call copies its inputs,
the prior among them, into the graph's own buffers, so the new tensors are
read at the next replay.
"""
from __future__ import annotations

import types

import numpy as np

from plslam_torch.convert import prior_from_numpy
from plslam_torch.models import marginalization as marg
from plslam_torch.models.estimator import _PRE_KEYS, Estimator, ImuBuffer
from plslam_torch.utils.device import HostCopy, astensor


def save_estimator(est: Estimator, path: str):
    d = dict(
        frame_count=est.frame_count, initialized=est.initialized,
        timestamps=est.timestamps, p=est.p, q=est.q, v=est.v, ba=est.ba, bg=est.bg,
        p_bc=est.p_bc, q_bc=est.q_bc, td=est.td, td_pair=est.td_pair,
        line_w=est.line_w,
        pt_ids=est.pt_table.ids, pt_start=est.pt_table.start, pt_obs=est.pt_table.obs,
        pt_vel=est.pt_table.vel, pt_mask=est.pt_table.mask,
        pt_inv_depth=est.pt_table.inv_depth, pt_track=est.pt_table.track_cnt,
        ln_ids=est.ln_table.ids, ln_start=est.ln_table.start, ln_obs=est.ln_table.obs,
        ln_mask=est.ln_table.mask, ln_solved=est.ln_table.solved,
        ln_track=est.ln_table.track_cnt,
        has_prior=est.prior is not None,
        # the open interval's boundary sample: without it the first IMU
        # sample after resume would seed a new session
        has_last=est.last_acc is not None,
        last_acc=est.last_acc if est.last_acc is not None else np.zeros(3),
        last_gyr=est.last_gyr if est.last_gyr is not None else np.zeros(3),
    )
    d["n_bufs"] = len(est.imu_bufs)
    for k, buf in enumerate(est.imu_bufs):
        d[f"buf{k}_acc"] = np.asarray(buf.acc) if buf.acc else np.zeros((0, 3))
        d[f"buf{k}_gyr"] = np.asarray(buf.gyr) if buf.gyr else np.zeros((0, 3))
        d[f"buf{k}_dt"] = np.asarray(buf.dt)
    # the device tensors, read back together
    keys, tensors = [], []
    if est.prior is not None:
        for name in marg.Prior._fields:
            keys.append(f"prior_{name}")
            tensors.append(getattr(est.prior, name))
    for k, pre in enumerate(est.pres):
        d[f"pre{k}_has"] = pre is not None
        if pre is not None:
            for name in _PRE_KEYS:
                keys.append(f"pre{k}_{name}")
                tensors.append(pre[name])
    if tensors:
        d.update(zip(keys, HostCopy(*tensors).get()))
    np.savez_compressed(path, **d)


def load_estimator(est: Estimator, path: str):
    """Restore into an Estimator of the same configuration (its state is
    cleared first). Returns `est`."""
    z = np.load(path, allow_pickle=False)
    est.clear_state()
    est.frame_count = int(z["frame_count"])
    est.initialized = bool(z["initialized"])
    est.timestamps = z["timestamps"]
    est.p, est.q, est.v, est.ba, est.bg = z["p"], z["q"], z["v"], z["ba"], z["bg"]
    est.p_bc, est.q_bc, est.td = z["p_bc"], z["q_bc"], float(z["td"])
    if "td_pair" in z.files:  # absent in the JAX package's early checkpoints
        est.td_pair = z["td_pair"]
    est.line_w = z["line_w"]
    t = est.pt_table
    t.ids, t.start, t.obs = z["pt_ids"], z["pt_start"], z["pt_obs"]
    t.vel, t.mask = z["pt_vel"], z["pt_mask"]
    t.inv_depth, t.track_cnt = z["pt_inv_depth"], z["pt_track"]
    lt = est.ln_table
    lt.ids, lt.start, lt.obs = z["ln_ids"], z["ln_start"], z["ln_obs"]
    lt.mask, lt.solved, lt.track_cnt = z["ln_mask"], z["ln_solved"], z["ln_track"]
    if bool(z["has_prior"]):
        fields = types.SimpleNamespace(**{n: z[f"prior_{n}"] for n in marg.Prior._fields})
        est.prior = prior_from_numpy(fields, dtype=est.dtype, device=est.device)
    est.imu_bufs = []
    est.pres = []
    for k in range(int(z["n_bufs"])):
        buf = ImuBuffer()
        acc = z[f"buf{k}_acc"]
        if len(acc):
            buf.acc = list(acc)
            buf.gyr = list(z[f"buf{k}_gyr"])
            buf.dt = list(z[f"buf{k}_dt"])
        est.imu_bufs.append(buf)
        est.pres.append(None)
    for k in range(len(est.imu_bufs)):
        if f"pre{k}_has" in z.files and bool(z[f"pre{k}_has"]):
            est.pres[k] = {n: astensor(z[f"pre{k}_{n}"], est.dtype, est.device) for n in _PRE_KEYS}
        elif f"pre{k}_has" not in z.files and 0 < k < len(est.imu_bufs) - 1:
            est._close_interval(k)  # a checkpoint without preintegrations: approximate resume
    if "has_last" in z.files and bool(z["has_last"]):
        est.last_acc = np.asarray(z["last_acc"], np.float64)
        est.last_gyr = np.asarray(z["last_gyr"], np.float64)
    elif len(est.imu_bufs) and len(est.imu_bufs[-1].dt) > 0:
        est.last_acc = est.imu_bufs[-1].acc[-1]
        est.last_gyr = est.imu_bufs[-1].gyr[-1]
    return est
