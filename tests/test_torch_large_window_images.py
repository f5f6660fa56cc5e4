"""The port's large-window refinement from images,
`plslam_torch.runner.run_euroc_large_window`, on the CPU at a small size:
3.5 s of `tests/test_large_window.py::test_distributed_large_window_from_images`'s
sequence recipe (seed 31, its IMU noise and biases) rendered at 320×240
(`test_torch_slice.py`'s camera and tracker), window 4, 4 LM iterations a
live solve, a 2 × 2 (kf_part, lmk) grid held in this process, float64.
Held to the JAX test's inequalities (the refinement no worse than 1.02×
the live ATE, and 5 % better or under 3 cm) and to len(kf_t) = P·W + 1.
The JAX runner on this render: live 0.0733 m, refined 0.0562 m.

Also JAX's default grid rule with "devices" read as ranks.
"""
import dataclasses

import numpy as np
import pytest
import torch

from plslam_torch.convert import config_from_jax
from plslam_torch.eval.metrics import ate_rmse
from plslam_torch.io import render as trender
from plslam_torch.io import synthetic as tsyn
from plslam_torch.models.state import layout
from plslam_torch.ops.cameras import PinholeRadTan as TCam
from plslam_torch.runner import _grid_shape, run_euroc_large_window
from test_torch_slice import F, H, PARAMS, W, small_config

P, L = 2, 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_run_euroc_large_window_refines_the_live_trajectory(tmp_path):
    seq = tsyn.make_sequence(duration=3.5, n_points=500, n_lines=0, seed=31,
                             params=tsyn.TrajectoryParams(**PARAMS), acc_noise=0.18,
                             gyr_noise=0.009, acc_bias=0.1, gyr_bias=0.004)
    trender.write_euroc_dataset(seq, str(tmp_path), TCam.create(F, F, W / 2, H / 2), H, W,
                                blob_sigma=2.0, style="textured")
    cfg = config_from_jax(small_config(seq))
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, window_size=4,
                                                              max_num_iterations=4))
    kf_t, live_p, ref_p, ref_q, est = run_euroc_large_window(
        str(tmp_path), cfg, kf_stride=2, rounds=3, num_iters=8, mesh_shape=(P, L), device="cpu")
    assert est.initialized
    assert len(kf_t) == P * cfg.solver.window_size + 1
    assert ref_p.shape == (len(kf_t), 3) and ref_q.shape == (len(kf_t), 4)
    gt_t, gt_p = seq.frame_t.numpy(), seq.gt_p.numpy()
    ate_live = ate_rmse(kf_t, live_p, gt_t, gt_p, align="yaw")
    ate_ref = ate_rmse(kf_t, ref_p, gt_t, gt_p, align="yaw")
    assert np.isfinite(ate_ref)
    assert ate_ref <= ate_live * 1.02, (ate_live, ate_ref)
    assert ate_ref < ate_live * 0.95 or ate_ref < 0.03, (ate_live, ate_ref)


def test_default_mesh_shape_reads_ranks():
    lay = layout(config_from_jax(small_config(tsyn.make_sequence(duration=0.2, seed=0))).solver)
    assert _grid_shape(None, 1, lay, 30, 10) == (1, 1)  # one process, as JAX on one device
    assert _grid_shape(None, 8, lay, 30, 10) == (2, 4)  # 8 ranks, 64 / 8 capacities divide
    assert _grid_shape(None, 8, lay, 50, 10) == (2, 4)
    assert _grid_shape(None, 4, lay, 50, 10) == (4, 1)
    assert _grid_shape((5, 4), 1, lay, 5, 10) == (5, 4)  # one process holds any grid
    # the default leaves ranks without a cell (JAX leaves devices idle): raise
    with pytest.raises(ValueError, match="mesh_shape"):
        _grid_shape(None, 4, lay, 5, 10)
    with pytest.raises(ValueError, match="mesh_shape"):
        _grid_shape((2, 1), 4, lay, 50, 10)
