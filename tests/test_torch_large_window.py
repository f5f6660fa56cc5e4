"""Port parity, the large-window mode on simulator observations:
`plslam_torch.runner.run_synthetic_large_window` against
`plslam.runner.run_synthetic_large_window` end to end, and the refinement
stage alone (`runner._refine_large_window`) fed the same live inputs as
the JAX runner's refinement, at a small size: 1.4 s of
`tests/test_large_window.py`'s noisy sequence (seed 13), window 4, 24
features, 2 LM iterations a live solve and 4 a refinement round, every
published frame a keyframe (2 partitions), float64.

Tolerances: the refinement stage within 1e-8 m (positions) and 1e-8
(quaternions) of JAX's on the same inputs; end to end the same keyframe
stamps, and the live and refined ATEs within 1e-4 m of JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.config import PLSlamConfig, SolverConfig
from plslam.eval.metrics import ate_rmse
from plslam.models import packing as jpack
from plslam.models import triangulate as jtri
from plslam.models.state import layout as jlayout
from plslam.models.state import zero_state as jzero_state
from plslam.parallel import consensus as jcons
from plslam.runner import run_synthetic_large_window as j_run
from plslam.utils import quat_np as jqnp
from plslam_torch import runner
from plslam_torch.convert import config_from_jax
from plslam_torch.io import synthetic as tsyn
from plslam_torch.models import packing as tpack
from plslam_torch.models.state import layout as tlayout
from plslam_torch.parallel import consensus as tcons
from test_torch_packing import jax_sequence

CONFIG = PLSlamConfig(solver=SolverConfig(max_features=24, max_line_feats=4, window_size=4,
                                          max_num_iterations=2, dtype="float64"))
RUN = dict(kf_stride=1, rounds=2, num_iters=4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    seq = tsyn.make_sequence(duration=1.4, n_points=120, n_lines=0, seed=13, pix_noise=0.6,
                             acc_noise=0.05, gyr_noise=0.003)
    port = runner.run_synthetic_large_window(seq, config_from_jax(CONFIG), device="cpu", **RUN)
    ref = j_run(jax_sequence(seq), CONFIG, **RUN)
    return seq, port, ref


def test_run_synthetic_large_window_matches_jax(runs):
    seq, (kf_t, live_p, ref_p, ref_q, est), j = runs
    assert len(kf_t) == 2 * CONFIG.solver.window_size + 1  # 2 partitions
    np.testing.assert_array_equal(kf_t, np.asarray(j[0]))
    gt_t, gt_p = seq.frame_t.numpy(), seq.gt_p.numpy()
    for ours, theirs in ((live_p, j[1]), (ref_p, j[2])):
        assert np.all(np.isfinite(ours))
        a = ate_rmse(kf_t, ours, gt_t, gt_p, align="yaw")
        b = ate_rmse(kf_t, np.asarray(theirs), gt_t, gt_p, align="yaw")
        assert abs(a - b) < 1e-4, (a, b)


def _jax_refine(parts, frames, seq, live_t, live_p, live_q, ba, bg):
    """`plslam/runner.py`'s refinement (lines 627-658) on given live inputs."""
    cfg = CONFIG.solver
    lay = jlayout(cfg)
    dtype = jnp.float64
    nw = cfg.window_size + 1
    live_v = np.gradient(live_p, live_t, axis=0)
    p_bc, q_bc = np.asarray(seq.p_bc), np.asarray(seq.q_bc)
    states, factors = [], []
    for pr in parts:
        _, f = jpack.factors_from_synthetic(seq, [int(frames[i]) for i in pr], cfg, lay,
                                            dtype=dtype, with_lines=False)
        st = jzero_state(cfg, dtype)._replace(
            p=jnp.asarray(live_p[pr], dtype), q=jnp.asarray(live_q[pr], dtype),
            v=jnp.asarray(live_v[pr], dtype),
            ba=jnp.asarray(np.tile(ba, (nw, 1)), dtype), bg=jnp.asarray(np.tile(bg, (nw, 1)), dtype),
            p_bc=jnp.asarray(p_bc, dtype), q_bc=jnp.asarray(q_bc, dtype))
        q_wc = jqnp.quat_mul(live_q[pr], q_bc)
        p_wc = live_p[pr] + jqnp.quat_rotate(live_q[pr], np.broadcast_to(p_bc, live_p[pr].shape))
        inv_d, ok = jtri.triangulate_points(jnp.asarray(p_wc, dtype), jnp.asarray(q_wc, dtype),
                                            f.pt_obs, f.pt_mask, f.pt_start)
        inv_d = jnp.where(ok & (inv_d > 0), inv_d, 0.2)
        states.append(st._replace(inv_depth=inv_d * f.pt_valid + 0.2 * (1 - f.pt_valid)))
        factors.append(f)
    stack = lambda items: type(items[0])(*[jnp.stack(xs) for xs in zip(*items)])  # noqa: E731
    st_out = jcons.consensus_solve(stack(states), stack(factors), lay, cfg,
                                   rounds=RUN["rounds"], num_iters=RUN["num_iters"])
    return jcons.stitch_trajectory(st_out, parts, len(live_t))


def test_refinement_matches_jax_on_the_same_live_inputs(runs):
    """The port's run's keyframes, live positions and final biases, with its
    refined orientations standing in for the live ones (the runner returns
    no live orientations), all perturbed (1 cm, ~0.01 rad) so that the
    refinement has work to do, through both refinements."""
    seq, (kf_t, live_p, _, ref_q, est), _ = runs
    rng = np.random.default_rng(3)
    live_p = live_p + 0.01 * rng.standard_normal(live_p.shape)
    live_q = ref_q + 0.005 * rng.standard_normal(ref_q.shape)
    live_q /= np.linalg.norm(live_q, axis=1, keepdims=True)
    frames = np.searchsorted(seq.frame_t.numpy(), kf_t - 1e-9)
    cfg = config_from_jax(CONFIG)
    parts = tcons.partition_frames(len(kf_t), cfg.solver.window_size)
    ba, bg = est.ba[cfg.solver.window_size], est.bg[cfg.solver.window_size]
    factors = [tpack.factors_from_synthetic(seq, [int(frames[i]) for i in pr], cfg.solver,
                                            tlayout(cfg.solver), with_lines=False,
                                            device="cpu")[1] for pr in parts]
    ref_p, ref_q = runner._refine_large_window(parts, factors, kf_t, live_p, live_q, ba, bg,
                                               seq.p_bc.numpy(), seq.q_bc.numpy(), cfg,
                                               RUN["rounds"], RUN["num_iters"], device="cpu")
    j_p, j_q = _jax_refine(parts, frames, jax_sequence(seq), kf_t, live_p, live_q, ba, bg)
    assert np.abs(ref_p - live_p).max() > 1e-3  # the refinement moved the poses
    np.testing.assert_allclose(ref_p, j_p, rtol=0, atol=1e-8)
    np.testing.assert_allclose(ref_q, j_q, rtol=0, atol=1e-8)
