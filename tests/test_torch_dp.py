"""Port parity, DP sequence batching: `plslam_torch/parallel/dp.py` against
`plslam/parallel/dp.py` on `tests/test_dp.py`'s batch (4 sequences, seeds
1-4, 32 features, 8 lines, float64, 4 LM iterations), packed by the port
and carried to JAX as numpy.

Tolerances: the batched solve equals JAX's within 1e-8 m (positions) and
1e-8 relative (costs), as `test_torch_backend.py` holds the single solve;
it equals the port's own per-item solves within 1e-8, and the batch split
over a device list equals the unsplit batch within 1e-10, as `test_dp.py`
holds JAX's.
"""
import numpy as np
import pytest
import torch

from plslam.config import SolverConfig
from plslam.models import residuals as jres
from plslam.models import state as jstate
from plslam.parallel import dp as jdp
from plslam_torch.io import synthetic as tsyn
from plslam_torch.models import packing as tpack
from plslam_torch.models import solver as tsolver
from plslam_torch.models.state import layout, retract
from plslam_torch.parallel import dp
from test_torch_packing import port_config, to_jax

CFG = SolverConfig(max_features=32, max_line_feats=8, dtype="float64")
TCFG = port_config(CFG)
LAY = layout(TCFG)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch():
    torch.set_num_threads(1)
    pairs = []
    rng = np.random.default_rng(5)
    for seed in (1, 2, 3, 4):
        seq = tsyn.make_sequence(duration=7.0, n_points=60, n_lines=24, seed=seed)
        st, f = tpack.factors_from_synthetic(seq, list(range(0, 22, 2)), TCFG, LAY, device="cpu")
        d = np.zeros(LAY.dim)
        d[6: LAY.nw * 6] = rng.standard_normal((LAY.nw - 1) * 6) * 0.005
        pairs.append((retract(st, torch.as_tensor(d), LAY), f))
    states, factors = dp.stack_windows(pairs)
    st_b, cost_b = dp.batched_optimize_windows(states, factors, LAY, TCFG, num_iters=4)
    return pairs, states, factors, st_b, cost_b


def test_batched_matches_jax(batch):
    _, states, factors, st_b, cost_b = batch
    st_j, cost_j = jdp.batched_optimize_windows(to_jax(states, jstate.WindowState),
                                                to_jax(factors, jres.WindowFactors),
                                                jstate.layout(CFG), CFG, num_iters=4)
    np.testing.assert_allclose(st_b.p.numpy(), np.asarray(st_j.p), rtol=0, atol=1e-8)
    np.testing.assert_allclose(st_b.v.numpy(), np.asarray(st_j.v), rtol=0, atol=1e-8)
    np.testing.assert_allclose(cost_b.numpy(), np.asarray(cost_j), rtol=1e-8)


def test_batched_equals_individual(batch):
    pairs, _, _, st_b, cost_b = batch
    for k, (st, f) in enumerate(pairs):
        st_k, stats_k = tsolver.optimize_window(st, f, LAY, TCFG, num_iters=4)
        np.testing.assert_allclose(st_b.p[k].numpy(), st_k.p.numpy(), rtol=0, atol=1e-8)
        np.testing.assert_allclose(float(cost_b[k]), float(stats_k.cost), rtol=1e-8)


def test_device_split_equals_unsplit(batch):
    """Three chunks (2, 1, 1 problems) on the CPU named three times."""
    _, states, factors, st_b, cost_b = batch
    st_s, cost_s = dp.batched_optimize_windows(states, factors, LAY, TCFG, num_iters=4,
                                               devices=["cpu", "cpu", torch.device("cpu")])
    assert st_s.p.shape == st_b.p.shape and st_s.p.device == st_b.p.device
    np.testing.assert_allclose(st_s.p.numpy(), st_b.p.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(cost_s.numpy(), cost_b.numpy(), rtol=1e-10)


def test_unknown_device_raises(batch):
    _, states, factors, _, _ = batch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="no device"):
        dp.batched_optimize_windows(states, factors, LAY, TCFG, num_iters=1,
                                    devices=["cpu", f"cuda:{n}"])


def float32_witness(iters=(1, 8)):
    """`chip_smoke.py` 9(a)'s eleven full-width windows (192 features, 64
    lines, window 10) in float32 through each package's batched solve and a
    loop of its single solves, after each count of LM iterations in `iters`:
    prints every window's batched-vs-loop gap, the loop's accepted steps and
    both costs. Run as a script, on the CPU, from the repo's root:
    `PYTHONPATH=. python tests/test_torch_dp.py`."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import chip_smoke as cs
    from plslam.io import synthetic as jsyn
    from plslam.models import packing as jpack
    from plslam.models import solver as jsolver
    from plslam_torch.config import SolverConfig as TSolverConfig

    jcfg = SolverConfig(max_features=192, max_line_feats=64, window_size=10, dtype="float32",
                        focal_length=cs.F)
    tcfg = TSolverConfig(max_features=192, max_line_feats=64, window_size=10, dtype="float32",
                         focal_length=cs.F)
    jlay, tlay = jstate.layout(jcfg), layout(tcfg)
    jseq = jsyn.make_sequence(params=jsyn.TrajectoryParams(**cs.TRAJECTORY), **cs.SEQUENCE)
    tseq = tsyn.make_sequence(params=tsyn.TrajectoryParams(**cs.TRAJECTORY), **cs.SEQUENCE)

    def windows(pack, retract_, as_delta, lay):
        rng, pairs = np.random.default_rng(5), []
        for b in range(cs.DP_BATCH):
            st, f = pack(list(range(b * cs.DP_STEP, b * cs.DP_STEP + 2 * lay.nw, 2)))
            d = np.zeros(lay.dim)
            d[6: lay.nw * 6] = rng.standard_normal((lay.nw - 1) * 6) * 0.005
            pairs.append((retract_(st, as_delta(d), lay), f))
        return pairs

    jpairs = windows(lambda fr: jpack.factors_from_synthetic(jseq, fr, jcfg, jlay, jnp.float32),
                     jstate.retract, lambda d: jnp.asarray(d, jnp.float32), jlay)
    tpairs = windows(lambda fr: tpack.factors_from_synthetic(tseq, fr, tcfg, tlay, torch.float32,
                                                             device="cpu"),
                     retract, lambda d: torch.as_tensor(d, dtype=torch.float32), tlay)
    for n in iters:
        for name, pairs, batched, single, lay, cfg in (
                ("JAX", jpairs, jdp.batched_optimize_windows, jsolver.optimize_window, jlay, jcfg),
                ("port", tpairs, dp.batched_optimize_windows, tsolver.optimize_window, tlay,
                 tcfg)):
            stack = jdp.stack_windows if name == "JAX" else dp.stack_windows
            st_b, cost_b = batched(*stack(pairs), lay, cfg, num_iters=n)
            for k, (st, f) in enumerate(pairs):
                st_k, stats = single(st, f, lay, cfg, num_iters=n)
                gap = np.abs(np.asarray(st_b.p[k], np.float64) - np.asarray(st_k.p)).max()
                print(f"{name}, {n} LM iterations, window {k}: batched vs loop {gap:.3e} m; "
                      f"the loop's accepted steps {int(stats.accepted)}; cost batched "
                      f"{float(cost_b[k]):.6g}, loop {float(stats.cost):.6g}", flush=True)


if __name__ == "__main__":
    float32_witness()
