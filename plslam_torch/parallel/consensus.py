"""Keyframe-partitioned large-window BA with boundary-pose consensus.

Counterpart of `plslam/parallel/consensus.py`. The reference cannot grow
its window (the Ceres solve is O(window³) and single-threaded). This module
scales along the *keyframe* axis, complementing the landmark sharding of
`distributed_ba`:

  * a long trajectory of N keyframes splits into P overlapping partitions of
    window_size+1 frames (1-frame overlap at each boundary),
  * ALL partitions solve at once as one batched `vmap` of the standard
    LM/Schur window solver (`parallel.dp`),
  * between rounds, partitions are chain-aligned through their shared
    boundary frame (a cost-free gauge transform) and the two copies of each
    boundary state are consensus-averaged (overlapping-Schwarz / simplified
    ADMM without duals — exact agreement at convergence on consistent data),
  * a few outer rounds reach the joint optimum.

The boundary consensus is a loop over partitions (the chain alignment is
sequential) whose values stay tensors on the solve's device: nothing is
read back inside the rounds.
"""
from __future__ import annotations

import numpy as np
import torch

from plslam_torch.config import SolverConfig
from plslam_torch.models import residuals as res
from plslam_torch.models.state import TangentLayout, WindowState
from plslam_torch.ops.lines import plucker_transform
from plslam_torch.parallel import dp
from plslam_torch.utils.device import HostCopy
from plslam_torch.utils.geometry import (
    quat_mul,
    quat_normalize,
    quat_to_rot,
    rot_to_quat,
    rot_to_ypr,
    ypr_to_rot,
)


def partition_frames(n_frames: int, window: int):
    """Overlapping partitions: [0..W], [W..2W], … (shared boundary frame)."""
    parts = []
    start = 0
    while start + window < n_frames:
        parts.append(list(range(start, start + window + 1)))
        start += window
    if parts and parts[-1][-1] != n_frames - 1:
        parts.append(list(range(n_frames - window - 1, n_frames)))
    return parts


def _yaw_t_align(p_ref, q_ref, p_src, q_src):
    """Gauge transform (Rz, t) taking (p_src,q_src) onto (p_ref,q_ref)."""
    dyaw = rot_to_ypr(quat_to_rot(q_ref))[0] - rot_to_ypr(quat_to_rot(q_src))[0]
    z = torch.zeros_like(dyaw)
    Rz = ypr_to_rot(torch.stack([dyaw, z, z]))
    return Rz, p_ref - Rz @ p_src


def _apply_gauge(st: WindowState, Rz, t) -> WindowState:
    q_z = rot_to_quat(Rz)
    return st._replace(
        p=st.p @ Rz.T + t,
        q=quat_mul(q_z.expand_as(st.q), st.q),
        v=st.v @ Rz.T,
        line=plucker_transform(st.line, Rz, t),
    )


def _set_row(a, i, value):
    """`a` with row `i` replaced by `value` (a new tensor)."""
    out = a.clone()
    out[i] = value
    return out


def consensus_solve(
    part_states: WindowState,  # stacked over leading axis P
    part_factors: res.WindowFactors,  # stacked over P
    lay: TangentLayout,
    cfg: SolverConfig,
    rounds: int = 3,
    num_iters: int = 8,
    solve_fn=None,
):
    """Solve P partitioned windows to a consistent trajectory.

    `solve_fn(part_states, part_factors) -> part_states` replaces the default
    batched solve — `parallel.mesh2d` plugs in the landmark-sharded solve
    here to run both scaling axes.

    NOTE: the chain alignment assumes partition k's frame 0 IS partition
    k−1's frame nw−1 (one shared boundary frame) — i.e. n_frames must be
    P·window + 1. `partition_frames`' ragged tail partition (overlap > 1)
    violates this; trim the history to full partitions first (see
    `runner.run_synthetic_large_window`).

    Returns the stacked partition states after consensus; use
    `stitch_trajectory` to extract the global keyframe poses."""
    P = part_states.p.shape[0]
    e = lay.nw - 1
    if solve_fn is None:
        def solve_fn(st, f):
            return dp.batched_optimize_windows(st, f, lay, cfg, num_iters=num_iters)[0]

    st = part_states
    for _ in range(rounds):
        st = solve_fn(st, part_factors)
        # chain-align partitions through boundary frames, then average the
        # two copies of each boundary state
        parts = [WindowState(*[a[k] for a in st]) for k in range(P)]
        for k in range(1, P):
            prev, cur = parts[k - 1], parts[k]
            Rz, t = _yaw_t_align(prev.p[e], prev.q[e], cur.p[0], cur.q[0])
            cur = _apply_gauge(cur, Rz, t)
            # consensus on the shared frame (state average; quaternion renorm)
            avg = {name: 0.5 * (getattr(prev, name)[e] + getattr(cur, name)[0])
                   for name in ("p", "q", "v", "ba", "bg")}
            avg["q"] = quat_normalize(avg["q"])
            parts[k - 1] = prev._replace(**{n: _set_row(getattr(prev, n), e, v)
                                            for n, v in avg.items()})
            parts[k] = cur._replace(**{n: _set_row(getattr(cur, n), 0, v) for n, v in avg.items()})
        st = WindowState(*[torch.stack(xs) for xs in zip(*parts)])
    return st


def stitch_trajectory(part_states: WindowState, parts: list[list[int]], n_frames: int):
    """Global (p [N,3], q [N,4]) from partition states (boundaries averaged),
    as float64 numpy arrays; the states are read back once."""
    pk, qk = HostCopy(part_states.p, part_states.q).get()
    p_out = np.zeros((n_frames, 3))
    q_out = np.tile([1.0, 0, 0, 0], (n_frames, 1))
    for k, frames in enumerate(parts):
        p_out[frames] = pk[k]
        q_out[frames] = qk[k]
    return p_out, q_out
