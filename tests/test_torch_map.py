"""Port parity, the map across sessions: both packages' `run_euroc` with
loop closure from `config.loop` on the same 3.5-s 320×240 render. A
pipelined first session saves its map; a synchronous second session over
the same frames loads it and closes its revisits into it.

Tolerances: the pose graphs' keyframe counts, map boundary, loop count and
loop edges (i, j) are equal, the emitted timestamps are equal, and the
positions are within 0.05 m of JAX's (the slice's trajectory tolerance;
one run on a CPU: 1.8e-6 m in the first session, 0.0038 m in the second).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from plslam.config import LoopConfig as JLoopConfig
from plslam.runner import run_euroc as j_run_euroc
from plslam_torch.config import LoopConfig
from plslam_torch.convert import config_from_jax
from plslam_torch.runner import run_euroc
from test_torch_slice import small_config, small_dataset


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _two_sessions(run, loop_config, base, path, pg_file):
    first = run(path, dataclasses.replace(base, loop=loop_config(
        loop_closure=True, save_pose_graph=True, pose_graph_save_path=pg_file)),
        use_lines=False, pipeline=True)
    assert os.path.exists(pg_file)
    second = run(path, dataclasses.replace(base, loop=loop_config(
        loop_closure=True, load_previous_pose_graph=True, pose_graph_save_path=pg_file)),
        use_lines=False, pipeline=False)
    return first, second


def test_loop_closure_follows_the_config_and_carries_the_map(tmp_path):
    """`run_euroc` runs loop closure when `config.loop` says so and returns
    the pose graph; the second session's keyframes follow the map's, no
    sequential edge bridges the two, and its revisits close loops into the
    map, which start the relocalization round trip. The JAX package, run
    the same way, gives the same graph and trajectory."""
    path = tmp_path / "render"
    seq = small_dataset(path, 3.5)
    jbase = small_config(seq)
    base = config_from_jax(jbase)
    out_a, out_b = _two_sessions(lambda *a, **k: run_euroc(*a, device="cpu", **k), LoopConfig,
                                 base, str(path), str(tmp_path / "map.npz"))
    jout_a, jout_b = _two_sessions(j_run_euroc, JLoopConfig, jbase, str(path),
                                   str(tmp_path / "jax_map.npz"))
    pg_a, pg_b = out_a[4], out_b[4]
    assert pg_a.n > 3 and pg_a.n == pg_a.db.n and pg_a.loop_count == 0
    assert pg_b.base_n == pg_a.n and pg_b.n == 2 * pg_a.n and pg_b.db.n == pg_b.n
    assert all(e["i"] >= pg_a.n for e in pg_b.edges if e["j"] >= pg_a.n and not e["loop"])
    loops = [e for e in pg_b.edges if e["loop"]]
    assert pg_b.loop_count == len(loops) >= 1
    assert all(e["i"] < pg_b.base_n <= e["j"] for e in loops)
    assert any("t_pnp" in e for e in loops)  # the relo round trip closed
    assert np.isfinite(out_b[1]).all() and len(out_b[0]) == len(out_a[0])
    for (ts, ps, _, _, pg), (jts, jps, _, _, jpg) in ((out_a, jout_a), (out_b, jout_b)):
        assert (pg.n, pg.base_n, pg.loop_count) == (jpg.n, jpg.base_n, jpg.loop_count)
        assert [(e["i"], e["j"], "t_pnp" in e) for e in pg.edges if e["loop"]] == \
            [(e["i"], e["j"], "t_pnp" in e) for e in jpg.edges if e["loop"]]
        np.testing.assert_array_equal(np.asarray(ts), np.asarray(jts))
        np.testing.assert_allclose(np.asarray(ps), np.asarray(jps), rtol=0, atol=0.05)
    assert run_euroc(str(path), base, device="cpu", max_frames=2)[4] is None  # off in `base`
