"""The port's multi-process layer (`plslam_torch/parallel/multihost.py`, and
the process layouts of `distributed_ba.py` and `mesh2d.py`) on the CPU:
the single-process fallback, the grid shapes and the `ValueError` of a
shape that does not match the world, and one 2-rank gloo run in
subprocesses on `tests/test_multihost.py`'s two partitions (seed 3, 160
points, 48 features, window 10; float64 here, where the JAX test casts to
float32) held against the same solves stacked in one process:
  * the 1-D landmark-sharded solve, 4 shards, 2 a rank (all_reduce of the
    camera system, all_gather of the landmarks);
  * the (kf_part, lmk) grid as 2 × 1 (a partition a rank, rows gathered)
    and as 1 × 2 (one partition, its 2 shards a rank each).
Tolerance 1e-6 (float64; the reductions add in other orders).

Run as a script, this file is one rank of that run:
`python tests/test_torch_multihost.py <rank> <world> <store file> <out.npz>`.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from plslam_torch.config import SolverConfig
from plslam_torch.io import synthetic as tsyn
from plslam_torch.models import packing
from plslam_torch.models.state import WindowState, layout, retract
from plslam_torch.parallel import distributed_ba as dba
from plslam_torch.parallel import dp, mesh2d, multihost

CFG = SolverConfig(max_features=48, max_line_feats=8)
LAY = layout(CFG)
ITERS = 3
TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _partitions():
    seq = tsyn.make_sequence(duration=6.0, n_points=160, n_lines=16, seed=3)
    rng = np.random.default_rng(1)
    pairs = []
    for frames in (list(range(0, 31, 3)), list(range(30, 61, 3))):
        st_gt, f = packing.factors_from_synthetic(seq, frames, CFG, LAY, with_lines=False,
                                                  device="cpu")
        delta = np.zeros(LAY.dim)
        delta[6: LAY.nw * 6] = rng.standard_normal((LAY.nw - 1) * 6) * 0.01
        pairs.append((retract(st_gt, torch.as_tensor(delta), LAY), f))
    return dp.stack_windows(pairs)


def _take(tree, lo, hi):
    return type(tree)(*[a[lo:hi] for a in tree])


def _solves(st_p, f_p, mesh_1d, grid_rows, grid_cols):
    """(1-D solve of partition 0, the 2 × 1 grid's round, the 1 × 2 grid's
    round of partition 0), each as a dict of arrays."""
    st, cost = dba.distributed_optimize_window(WindowState(*[a[0] for a in st_p]),
                                               type(f_p)(*[a[0] for a in f_p]), LAY, CFG,
                                               mesh_1d, num_iters=ITERS)
    rows = mesh2d.partitioned_distributed_solve(st_p, f_p, LAY, CFG, grid_rows, num_iters=ITERS)
    cols = mesh2d.partitioned_distributed_solve(_take(st_p, 0, 1), _take(f_p, 0, 1), LAY, CFG,
                                                grid_cols, num_iters=ITERS)
    out = {}
    for tag, (s, c) in (("1d", (st, cost)), ("rows", rows), ("cols", cols)):
        out.update({f"{tag}_{n}": getattr(s, n).numpy() for n in ("p", "q", "v", "inv_depth")})
        out[f"{tag}_cost"] = c.numpy()
    return out


def _worker(rank, world, store, out_path):
    torch.set_num_threads(1)
    assert multihost.init_distributed(init_method=f"file://{store}", world_size=world, rank=rank,
                                      backend="gloo")
    assert multihost.init_distributed()  # idempotent
    default = multihost.global_mesh_2d()  # no LOCAL_WORLD_SIZE: one host, (1, world)
    assert (default.n_part, default.n_lmk) == (1, world) and default.coords == (0, rank)
    for bad in (lambda: multihost.global_mesh_2d(n_part=3, n_lmk=4),
                lambda: dba.make_mesh(3, dist.group.WORLD)):  # 3 shards over 2 ranks
        try:
            bad()
        except ValueError:
            continue
        raise AssertionError("a layout that does not fit 2 ranks did not raise")
    st_p, f_p = _partitions()
    rows = multihost.global_mesh_2d(n_part=2, n_lmk=1)
    out = _solves(st_p, f_p, dba.make_mesh(4, dist.group.WORLD), rows,
                  multihost.global_mesh_2d(n_part=1, n_lmk=2))
    # a second grid of a shape reuses the row groups of the first
    assert multihost.global_mesh_2d(n_part=2, n_lmk=1).lmk_group is rows.lmk_group
    np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK_OK {rank}")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_init_distributed_single_process_fallback(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.init_distributed() is False
    assert not dist.is_initialized() and multihost.world_size() == 1


def test_global_mesh_2d_shapes():
    m = multihost.global_mesh_2d()  # one process: (1, 1), as JAX on one device
    assert (m.n_part, m.n_lmk) == (1, 1)
    assert m.group is None
    with pytest.raises(ValueError):
        multihost.global_mesh_2d(n_part=2, n_lmk=4)
    m = mesh2d.make_mesh2d(2, 4)  # one process holds any grid
    assert (m.n_part, m.n_lmk) == (2, 4) and m.group is None


def test_two_rank_gloo_matches_stacked(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "1"
    store = tmp_path / "store"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), "2", str(store),
                               str(tmp_path / f"rank{r}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, f"rank {r}:\n{out[-4000:]}"

    st_p, f_p = _partitions()
    ref = _solves(st_p, f_p, dba.make_mesh(4), mesh2d.make_mesh2d(2, 1), mesh2d.make_mesh2d(1, 2))
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert sorted(got.files) == sorted(ref)
        for name, value in ref.items():
            assert got[name].shape == value.shape, name
            np.testing.assert_allclose(got[name], value, rtol=TOL, atol=TOL, err_msg=f"rank {r} {name}")


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
