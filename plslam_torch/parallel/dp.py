"""Data-parallel (DP) sequence batching: many independent window problems as
one batched solve, optionally split over a list of devices.

Counterpart of `plslam/parallel/dp.py`. The reference has no DP at all (one
rosbag, one estimator process); its multi-sequence EuRoC evaluation is 11
serial runs. Here independent sequences/windows are batched on the leading
axis:

  * `batched_optimize_windows` — one `torch.func.vmap` of the standard
    LM/Schur window solve: B problems in one call, the small linear algebra
    batched (11 EuRoC sequences = B=11).
  * `devices=`, in place of JAX's `mesh=`: the batch is split over the
    listed devices in contiguous chunks, each chunk solved where it lies,
    and the results concatenated back on the input's device. The problems
    are independent, so no device talks to another. One card is
    `devices=[cuda:0]`.
"""
from __future__ import annotations

import torch

from plslam_torch.config import SolverConfig
from plslam_torch.models import residuals as res
from plslam_torch.models import solver as solver_mod
from plslam_torch.models.state import TangentLayout, WindowState


def _vmapped_solve(states, factors, lay, cfg, num_iters):
    def one(s, f):
        st, stats = solver_mod.optimize_window(s, f, lay, cfg, num_iters=num_iters)
        return st, stats.cost

    return torch.func.vmap(one)(states, factors)


def _check_device(device) -> torch.device:
    """`device` as a `torch.device`; raises `ValueError` if this process has
    no such device."""
    d = torch.device(device)
    if d.type == "cpu":
        return d
    if d.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if (d.index or 0) < n:
            return d
    raise ValueError(f"no device {d} in this process")


def _take(tree, lo, hi, device):
    return type(tree)(*[a[lo:hi].to(device) for a in tree])


def batched_optimize_windows(
    states: WindowState,  # stacked over leading batch axis B
    factors: res.WindowFactors,  # stacked over B
    lay: TangentLayout,
    cfg: SolverConfig,
    num_iters: int = 8,
    devices=None,
):
    """Solve B independent windows at once; returns (states [B,...], costs [B]).

    `devices`: split the batch over these devices in contiguous chunks (the
    first B mod n devices take one problem more, as `torch.tensor_split`
    splits); a device named twice takes two chunks."""
    if devices is None:
        return _vmapped_solve(states, factors, lay, cfg, num_iters)
    devs = [_check_device(d) for d in devices]
    home = states.p.device
    B = states.p.shape[0]
    bounds = [0]
    for chunk in torch.tensor_split(torch.arange(B), len(devs)):
        bounds.append(bounds[-1] + len(chunk))
    outs = []
    for d, lo, hi in zip(devs, bounds[:-1], bounds[1:]):
        if hi > lo:
            st, cost = _vmapped_solve(_take(states, lo, hi, d), _take(factors, lo, hi, d),
                                      lay, cfg, num_iters)
            outs.append((_take(st, 0, hi - lo, home), cost.to(home)))
    return (WindowState(*[torch.cat(xs) for xs in zip(*[o[0] for o in outs])]),
            torch.cat([o[1] for o in outs]))


def stack_windows(pairs):
    """Stack [(state, factors), ...] along a new leading batch axis."""
    pairs = list(pairs)
    states = WindowState(*[torch.stack(xs) for xs in zip(*[p[0] for p in pairs])])
    factors = res.WindowFactors(*[torch.stack(xs) for xs in zip(*[p[1] for p in pairs])])
    return states, factors
