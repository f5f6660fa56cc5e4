"""Multi-process bring-up: `torch.distributed.init_process_group` + the
(kf_part, lmk) grid over all ranks.

Counterpart of `plslam/parallel/multihost.py` (`jax.distributed.initialize`
and a global JAX mesh). Call `init_distributed()` once per process before
building layouts, then `global_mesh_2d()` for the (kf_part, lmk) grid of
`parallel/mesh2d.py` — consensus partitions across hosts, landmark-shard
reductions within a host. Launched by `torchrun`, every argument comes from
its environment; with no cluster configuration the process stays alone.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from plslam_torch.parallel import mesh2d


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None) -> bool:
    """Join the process group (idempotent).

    With no arguments, reads torchrun's environment (MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK); without it there is no cluster and the
    call returns False. Returns True when more than one process is active.
    The backend is `nccl` when this process has a CUDA device and `gloo` on
    the CPU, unless `backend` names one; a backend that fails raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None:
        if not ("MASTER_ADDR" in env and "MASTER_PORT" in env and world_size is not None):
            return False
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and "LOCAL_RANK" in env:
        torch.cuda.set_device(int(env["LOCAL_RANK"]))  # one card a rank
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return dist.get_world_size() > 1


def world_size() -> int:
    """The number of ranks: 1 when no process group is active."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh_2d(n_part: int | None = None, n_lmk: int | None = None) -> mesh2d.Mesh2D:
    """The (kf_part, lmk) grid over ALL ranks, one cell a rank.

    Default shape: kf_part = number of hosts (consensus traffic is tiny and
    infrequent), lmk = ranks per host (the camera system's reduction every
    LM iteration). torchrun's LOCAL_WORLD_SIZE gives the ranks per host;
    without it all ranks count as one host. One process gives (1, 1)."""
    world = world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_part is None:
        n_part = max(world // per_host, 1)
    if n_lmk is None:
        n_lmk = world // n_part
    if n_part * n_lmk != world:
        raise ValueError(f"mesh {n_part}x{n_lmk} != {world} ranks")
    return mesh2d.make_mesh2d(n_part, n_lmk, dist.group.WORLD if world > 1 else None)
