"""Port parity, landmark-sharded BA: `plslam_torch/parallel/distributed_ba.py`
with the L shards stacked in one process against
`plslam/parallel/distributed_ba.py` on JAX's forced CPU mesh of L devices
(`tests/conftest.py`), on `tests/test_distributed.py`'s window (seed 3, 48
features, 16 lines, float64, 8 LM iterations), packed by the port and
carried to JAX as numpy.

Tolerances: positions, velocities and landmarks within 1e-7 of JAX's, the
cost within 1e-7 relative (float64; the two reduce in other orders); and
`test_distributed.py`'s own assertions on the port: within 2e-3 m of the
ground truth, within 1e-5 m / 1e-4 m/s of the single-device solve.
"""
import jax
import numpy as np
import pytest
import torch

from plslam.config import SolverConfig
from plslam.models import residuals as jres
from plslam.models import state as jstate
from plslam.parallel import distributed_ba as jdba
from plslam_torch.io import synthetic as tsyn
from plslam_torch.models import packing as tpack
from plslam_torch.models import solver as tsolver
from plslam_torch.models.state import layout, retract
from plslam_torch.parallel import distributed_ba as dba
from test_torch_packing import port_config, to_jax

CFG = SolverConfig(max_features=48, max_line_feats=16)
TCFG = port_config(CFG)
LAY = layout(TCFG)
SHARDS = (1, 4, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def window():
    torch.set_num_threads(1)
    seq = tsyn.make_sequence(duration=6.0, n_points=120, n_lines=40, seed=3)
    state, f = tpack.factors_from_synthetic(seq, list(range(0, 55, 5)), TCFG, LAY, device="cpu")
    rng = np.random.default_rng(9)
    nw = LAY.nw
    delta = np.zeros(LAY.dim)
    delta[6: nw * 6] = rng.standard_normal((nw - 1) * 6) * 0.005
    sb = rng.standard_normal((nw, 9))
    sb[:, 0:3] *= 0.01
    sb[:, 3:6] *= 5e-5
    sb[:, 6:9] *= 5e-6
    delta[LAY.off_sb: LAY.off_ext] = sb.reshape(-1)
    pert = retract(state, torch.as_tensor(delta), LAY)
    solves = {n: dba.distributed_optimize_window(pert, f, LAY, TCFG, dba.make_mesh(n), num_iters=8)
              for n in SHARDS}
    single = tsolver.optimize_window(pert, f, LAY, TCFG, num_iters=8)[0]
    return state, pert, f, solves, single


@pytest.mark.parametrize("n", SHARDS)
def test_stacked_shards_match_jax_mesh(window, n):
    _, pert, f, solves, _ = window
    assert len(jax.devices()) >= n
    st_j, cost_j = jdba.distributed_optimize_window(
        to_jax(pert, jstate.WindowState), to_jax(f, jres.WindowFactors), jstate.layout(CFG), CFG,
        jdba.make_mesh(n), num_iters=8)
    st_t, cost_t = solves[n]
    for name in ("p", "q", "v", "ba", "bg", "inv_depth", "line"):
        np.testing.assert_allclose(getattr(st_t, name).numpy(), np.asarray(getattr(st_j, name)),
                                   rtol=0, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-7)


@pytest.mark.parametrize("n", SHARDS)
def test_stacked_shards_match_single(window, n):
    state_gt, _, _, solves, single = window
    st_d = solves[n][0]
    for st, tag in ((st_d, f"stacked {n}"), (single, "single")):
        p_err = float(torch.linalg.norm(st.p - state_gt.p, dim=-1).max())
        assert p_err < 2e-3, (tag, p_err)
    np.testing.assert_allclose(st_d.p.numpy(), single.p.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st_d.v.numpy(), single.v.numpy(), rtol=0, atol=1e-4)


def test_uneven_shards_pad(window):
    """5 shards do not divide 48 features and 16 lines: the padded slots
    (benign placeholder lines) change nothing."""
    _, pert, f, solves, _ = window
    st5, cost5 = dba.distributed_optimize_window(pert, f, LAY, TCFG, dba.make_mesh(5), num_iters=8)
    st1, cost1 = solves[1]
    assert st5.inv_depth.shape == st1.inv_depth.shape and st5.line.shape == st1.line.shape
    np.testing.assert_allclose(st5.p.numpy(), st1.p.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(st5.line.numpy(), st1.line.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(cost5), float(cost1), rtol=1e-9)
