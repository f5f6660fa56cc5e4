"""Two-axis layout: keyframe partitions × landmark shards.

Counterpart of `plslam/parallel/mesh2d.py`. `consensus.py` scales the
keyframe axis (partition-parallel window solves + boundary consensus) and
`distributed_ba.py` the landmark axis (sharded Schur reduction of the
camera system); this module composes them on one (kf_part, lmk) grid, each
row a keyframe partition and each column a landmark shard of it:

  * within a row: the reduction over 'lmk' sums the DC×DC camera system and
    the landmark vector is rebuilt from the shards — the 1-D distributed-BA
    schedule (shared `distributed_ba.make_lm_iter`),
  * across rows: partitions are independent inside the solve; only the
    boundary consensus between rounds couples them.

Two layouts, as in `distributed_ba`:
  * one process (`make_mesh2d(P, L)`): the grid is a `torch.func.vmap`
    over partitions of the stacked L-shard solve, on one device;
  * several processes (`make_mesh2d(P, L, group)`, P·L ranks): each rank
    owns one cell, picked by its rank's coordinates in the grid; its row's
    process group carries the all_reduce and the all_gather of the
    landmark vector, and every rank gathers all rows' results, so each
    returns the stacked (part_states, costs) as JAX's replicated outputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from plslam_torch.config import SolverConfig
from plslam_torch.models import residuals as res
from plslam_torch.models.solver import reanchor
from plslam_torch.models.state import TangentLayout, WindowState
from plslam_torch.parallel import consensus
from plslam_torch.parallel import distributed_ba as dba


class Mesh2D(NamedTuple):
    """A (kf_part, lmk) grid; `group` is None when one process holds it."""

    n_part: int
    n_lmk: int
    group: object = None
    lmk_group: object = None  # this rank's row
    coords: tuple = (0, 0)  # this rank's (kf_part, lmk) cell


_ROW_GROUPS: dict = {}  # (group, n_part, n_lmk) -> this rank's row group


def make_mesh2d(n_part: int, n_lmk: int, group=None) -> Mesh2D:
    """The grid in this process (`group=None`), or over the ranks of `group`
    (rank r at cell divmod(r, n_lmk)). Every rank of `group` must make the
    first grid of a shape: that call creates one process group per row,
    which later grids of the same shape over `group` reuse."""
    if group is None:
        return Mesh2D(n_part, n_lmk)
    world = dist.get_world_size(group)
    if n_part * n_lmk != world:
        raise ValueError(f"mesh {n_part}x{n_lmk} != {world} ranks")
    row, col = divmod(dist.get_rank(group), n_lmk)
    key = (group, n_part, n_lmk)
    if key not in _ROW_GROUPS:
        rows = [dist.new_group([dist.get_global_rank(group, i * n_lmk + j)
                                for j in range(n_lmk)]) for i in range(n_part)]
        _ROW_GROUPS[key] = rows[row]
    return Mesh2D(n_part, n_lmk, group, _ROW_GROUPS[key], (row, col))


def _flat(st: WindowState, cost):
    return torch.cat([a.reshape(-1) for a in st] + [cost.reshape(-1)])


def _unflat(v, like: WindowState):
    fields, i = [], 0
    for a in like:
        fields.append(v[i: i + a.numel()].reshape(a.shape))
        i += a.numel()
    return WindowState(*fields), v[i]


def partitioned_distributed_solve(
    part_states: WindowState,  # stacked over leading P axis
    part_factors: res.WindowFactors,  # stacked over P
    lay: TangentLayout,
    cfg: SolverConfig,
    mesh: Mesh2D,
    num_iters: int = 8,
):
    """One round of P simultaneous landmark-sharded window solves on a
    (kf_part, lmk) grid. Returns (part_states', costs [P])."""
    L = mesh.n_lmk
    MF, ML = lay.max_f, lay.max_l
    assert MF % L == 0 and ML % L == 0, "capacities must divide the lmk axis"

    def solve(st, f, shards, reduce, lmk_group):
        st_cam, inv_out, line_out, cost = dba.solve_local_shards(st, f, lay, cfg, L, shards,
                                                                 reduce, num_iters)
        if lmk_group is not None:  # rebuild the full landmark vectors within the row
            inv_out = dba.all_gather_cat(inv_out, lmk_group)
            line_out = dba.all_gather_cat(line_out, lmk_group)
        st_out = st_cam._replace(inv_depth=inv_out.reshape(-1)[:MF],
                                 line=line_out.reshape(-1, 6)[:ML])
        # per-partition gauge repair against the pre-solve state
        return reanchor(st_out, st), cost

    if mesh.group is None:
        return torch.func.vmap(lambda st, f: solve(st, f, range(L), dba.reducer(), None))(
            part_states, part_factors)

    P = part_states.p.shape[0]
    assert P == mesh.n_part, "one partition per grid row"
    row, col = mesh.coords
    st_r, cost_r = solve(WindowState(*[a[row] for a in part_states]),
                         res.WindowFactors(*[a[row] for a in part_factors]),
                         range(col, col + 1), dba.reducer(mesh.lmk_group), mesh.lmk_group)
    # every rank of a row holds the same result: take each row's first rank
    rows = dba.all_gather_cat(_flat(st_r, cost_r)[None], mesh.group)[::L]
    outs = [_unflat(v, st_r) for v in rows]
    return (WindowState(*[torch.stack(xs) for xs in zip(*[o[0] for o in outs])]),
            torch.stack([o[1] for o in outs]))


def consensus_distributed_solve(part_states, part_factors, lay, cfg, mesh, rounds: int = 2,
                                num_iters: int = 4):
    """Both scaling axes end-to-end: landmark-sharded solves per partition
    + boundary-pose consensus between rounds."""
    return consensus.consensus_solve(
        part_states, part_factors, lay, cfg, rounds=rounds, num_iters=num_iters,
        solve_fn=lambda st, f: partitioned_distributed_solve(st, f, lay, cfg, mesh,
                                                             num_iters=num_iters)[0],
    )
