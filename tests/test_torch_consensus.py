"""Port parity, keyframe-partitioned consensus BA and the (kf_part, lmk)
layout: `plslam_torch/parallel/consensus.py` and `parallel/mesh2d.py`
(one process: partitions vmapped, shards stacked) against
`plslam/parallel/consensus.py` and `mesh2d.py` on JAX's forced CPU mesh,
on the stacked partitions of `tests/test_consensus.py` /
`tests/test_mesh2d.py` (31 keyframes of seed 7 in 3 partitions of window
10, 48 features, no lines, 1 cm pose perturbations from seed 4), packed by
the port and carried to JAX as numpy, in float64.

Tolerances: partition states and stitched positions within 1e-7 of JAX's
(float64, the same math in other reduction orders), costs 1e-7 relative;
`partition_frames` equal; and the JAX tests' bounds on the port: the 2-D
round within 2e-3 of the vmapped single-device solve, the stitched
trajectory within 5e-3 m (batched consensus) and 2e-2 m (2-D consensus) of
the ground truth, gauge-aligned at frame 0.
"""
import numpy as np
import pytest
import torch

from plslam.config import SolverConfig
from plslam.models import residuals as jres
from plslam.models import state as jstate
from plslam.parallel import consensus as jcons
from plslam.parallel import mesh2d as jmesh2d
from plslam_torch.io import synthetic as tsyn
from plslam_torch.models import packing as tpack
from plslam_torch.models.state import layout, retract
from plslam_torch.parallel import consensus, dp, mesh2d
from test_torch_packing import port_config, to_jax

CFG = SolverConfig(max_features=48, max_line_feats=8)
TCFG = port_config(CFG)
LAY = layout(TCFG)
N_FRAMES = 31
TOL = 1e-7


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def partitioned():
    torch.set_num_threads(1)
    seq = tsyn.make_sequence(duration=10.0, n_points=200, n_lines=24, seed=7)
    kf = list(range(0, N_FRAMES * 3, 3))
    parts = consensus.partition_frames(N_FRAMES, CFG.window_size)
    rng = np.random.default_rng(4)
    pairs = []
    for pr in parts:
        st_gt, f = tpack.factors_from_synthetic(seq, [kf[i] for i in pr], TCFG, LAY,
                                                with_lines=False, device="cpu")
        delta = np.zeros(LAY.dim)
        delta[6: LAY.nw * 6] = rng.standard_normal((LAY.nw - 1) * 6) * 0.01
        pairs.append((retract(st_gt, torch.as_tensor(delta), LAY), f))
    st_p, f_p = dp.stack_windows(pairs)
    gt_p = seq.gt_p.numpy()[kf]
    return parts, st_p, f_p, gt_p


def jax_inputs(st_p, f_p):
    return to_jax(st_p, jstate.WindowState), to_jax(f_p, jres.WindowFactors)


def assert_states_close(port, ref, names=("p", "q", "v", "ba", "bg", "inv_depth")):
    for name in names:
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=TOL, err_msg=name)


def gt_error(p, gt_p):
    return np.linalg.norm(p - (gt_p - gt_p[0] + p[0]), axis=1).max()


def test_partition_frames_matches_jax():
    for n in range(11, 61):
        assert consensus.partition_frames(n, 10) == jcons.partition_frames(n, 10), n
    parts = consensus.partition_frames(N_FRAMES, 10)
    assert parts[0] == list(range(0, 11)) and parts[1][0] == parts[0][-1]
    assert parts[-1][-1] == 30 and all(len(p) == 11 for p in parts)


def test_consensus_matches_jax(partitioned):
    parts, st_p, f_p, gt_p = partitioned
    st_t = consensus.consensus_solve(st_p, f_p, LAY, TCFG, rounds=3)  # test_consensus.py's
    st_j = jcons.consensus_solve(*jax_inputs(st_p, f_p), jstate.layout(CFG), CFG, rounds=3)
    assert_states_close(st_t, st_j)
    p_t, q_t = consensus.stitch_trajectory(st_t, parts, N_FRAMES)
    p_j, q_j = jcons.stitch_trajectory(st_j, parts, N_FRAMES)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=TOL)
    assert gt_error(p_t, gt_p) < 5e-3


def test_2d_solve_matches_jax(partitioned):
    """One round on the (3 partitions × 2 landmark shards) grid."""
    _, st_p, f_p, _ = partitioned
    st_t, cost_t = mesh2d.partitioned_distributed_solve(st_p, f_p, LAY, TCFG,
                                                        mesh2d.make_mesh2d(3, 2), num_iters=3)
    st_j, cost_j = jmesh2d.partitioned_distributed_solve(
        *jax_inputs(st_p, f_p), jstate.layout(CFG), CFG, jmesh2d.make_mesh2d(3, 2), num_iters=3)
    assert_states_close(st_t, st_j)
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_j), rtol=TOL)
    # test_mesh2d.py's bound against the vmapped single-device solve
    st_ref, _ = dp.batched_optimize_windows(st_p, f_p, LAY, TCFG, num_iters=3)
    np.testing.assert_allclose(st_t.p.numpy(), st_ref.p.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(st_t.inv_depth.numpy(), st_ref.inv_depth.numpy(), rtol=0, atol=2e-3)


def test_consensus_on_2d_matches_jax(partitioned):
    parts, st_p, f_p, gt_p = partitioned
    st_t = mesh2d.consensus_distributed_solve(st_p, f_p, LAY, TCFG, mesh2d.make_mesh2d(3, 2),
                                              rounds=2, num_iters=3)
    st_j = jmesh2d.consensus_distributed_solve(*jax_inputs(st_p, f_p), jstate.layout(CFG), CFG,
                                               jmesh2d.make_mesh2d(3, 2), rounds=2, num_iters=3)
    assert_states_close(st_t, st_j)
    p_t, _ = consensus.stitch_trajectory(st_t, parts, N_FRAMES)
    assert gt_error(p_t, gt_p) < 2e-2
