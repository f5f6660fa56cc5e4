"""Port parity, the three line charts (`tests/test_line_variants.py` on the
port): world Plücker, `…_incamera` and `…_instartframe` (lines anchored in
their first-observing camera / body frame).

Each case holds the reference test's own assertions on the port and, where
the reference computes a value, the port's beside JAX's on the same numpy
window (48 features, 16 lines, 11 frames, float64):
  * residuals and chart round trips: 1e-10 against JAX, the reference's
    1e-10 / 1e-9 between charts;
  * the jacobian: JAX's `jacfwd` within 1e-9 × max|J|, finite differences
    within the reference's 5e-9;
  * the window solve (10 LM iterations, frame 0 frozen): positions within
    1e-8 m of JAX's, the reference's 5e-3 m of the truth;
  * the estimator path (float32 `backend_tick`, groups-reuse IRLS weights):
    the reference's 1e-4 on the weights and 6 % on the prior's information,
    and the port's carried weights against JAX's `robust_weights` at the
    port's state within 1e-4 (float32).
`test_assembly_matches_dense` is in `tests/test_torch_assembly.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.config import SolverConfig
from plslam.io import synthetic as jsyn
from plslam.models import residuals as jres
from plslam.models import solver as jsolver
from plslam.models.packing import factors_from_synthetic
from plslam.models.state import layout
from plslam.models.state import retract as jretract
from plslam_torch import convert
from plslam_torch.models import residuals as tres
from plslam_torch.models import solver as tsolver
from plslam_torch.models.state import retract

VARIANTS = ["incamera", "instartframe"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def npy(nt):
    return type(nt)(*[np.asarray(x) for x in nt])


@pytest.fixture(scope="module")
def window():
    cfg = SolverConfig(max_features=48, max_line_feats=16, dtype="float64")
    lay = layout(cfg)
    seq = jsyn.make_sequence(duration=8.0, n_points=80, n_lines=40, seed=3)
    state, f = factors_from_synthetic(seq, list(range(0, 22, 2)), cfg, lay, with_lines=True)
    state, f = npy(state), npy(f)
    return cfg, lay, state, f, convert.window_state_from_numpy(state), convert.factors_from_numpy(f)


def jcast(nt):
    return type(nt)(*[jnp.asarray(x) for x in nt])


@pytest.mark.parametrize("lp", VARIANTS)
def test_residual_equivalence(window, lp):
    cfg, lay, jst, jf, st, f = window
    r_world = tres.line_residuals(st, f, cfg.focal_length, "world")
    st_v = st._replace(line=tres.lines_from_world(st, st.line, f.ln_start, lp))
    r_var = tres.line_residuals(st_v, f, cfg.focal_length, lp)
    np.testing.assert_allclose(r_var.numpy(), r_world.numpy(), atol=1e-10)
    back = tres.lines_to_world(st_v, f.ln_start, lp)
    np.testing.assert_allclose(back.numpy(), st.line.numpy(), atol=1e-9)
    # against JAX: the chart and the residuals in it
    jst, jf = jcast(jst), jcast(jf)
    L_j = jres.lines_from_world(jst, jst.line, jf.ln_start, lp)
    np.testing.assert_allclose(st_v.line.numpy(), np.asarray(L_j), rtol=1e-10, atol=1e-12)
    r_j = jres.line_residuals(jst._replace(line=L_j), jf, cfg.focal_length, lp)
    np.testing.assert_allclose(r_var.numpy(), np.asarray(r_j), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("lp", VARIANTS)
def test_fd_jacobian(window, lp):
    cfg, lay, jst, jf, st, f = window
    st_v = st._replace(line=tres.lines_from_world(st, st.line, f.ln_start, lp))

    def r_fn(delta):
        return tres.line_residuals(retract(st_v, delta, lay), f, cfg.focal_length, lp).reshape(-1)

    J = torch.func.jacfwd(r_fn)(torch.zeros(lay.dim, dtype=torch.float64)).numpy()
    starts, valid = f.ln_start.numpy(), f.ln_valid.numpy() > 0
    a = int(starts[valid].max())
    if a > 0:  # anchored charts couple the anchor pose
        assert np.abs(J[:, lay.off_pose + 6 * a: lay.off_pose + 6 * (a + 1)]).max() > 1e-6
    rng = np.random.default_rng(0)
    for _ in range(4):
        d = torch.as_tensor(rng.standard_normal(lay.dim) * 1e-6)
        fd = ((r_fn(d) - r_fn(-d)) * 0.5).numpy()
        np.testing.assert_allclose(J @ d.numpy(), fd, atol=5e-9)
    # JAX's jacobian of the same function
    jst, jf = jcast(jst), jcast(jf)
    jst_v = jst._replace(line=jres.lines_from_world(jst, jst.line, jf.ln_start, lp))
    J_j = jax.jit(jax.jacfwd(lambda d: jres.line_residuals(
        jretract(jst_v, d, lay), jf, cfg.focal_length, lp).reshape(-1)))(
        jnp.zeros(lay.dim, jnp.float64))
    np.testing.assert_allclose(J, np.asarray(J_j), rtol=0, atol=1e-9 * np.abs(J).max())


@pytest.mark.parametrize("lp", ["world"] + VARIANTS)
def test_solver_recovers_gt(window, lp):
    cfg, lay, jst, jf, st, f = window
    cfg_v = dataclasses.replace(cfg, line_param=lp)
    st0 = st._replace(line=tres.lines_from_world(st, st.line, f.ln_start, lp))
    rng = np.random.default_rng(7)
    d = np.zeros(lay.dim)
    d[lay.off_pose: lay.off_sb] = rng.standard_normal(lay.nw * 6) * 0.01
    d[lay.off_pose: lay.off_pose + 6] = 0.0
    d[lay.off_line:] = rng.standard_normal(lay.max_l * 4) * 0.01
    st_pert = retract(st0, torch.as_tensor(d), lay)
    st_out, stats = tsolver.optimize_window(st_pert, f, lay, cfg_v, num_iters=10,
                                            freeze_frames=(0,))
    err_p = np.abs(st_out.p.numpy() - st.p.numpy()).max()
    assert float(stats.cost) < float(stats.cost0)
    assert err_p < 5e-3, (lp, err_p, float(stats.cost0), float(stats.cost))
    # JAX's solve from the same perturbed window
    j_out, j_stats = jsolver.optimize_window(
        type(jst)(*[jnp.asarray(x.numpy()) for x in st_pert]), jcast(jf), lay, cfg_v,
        num_iters=10, freeze_frames=(0,))
    np.testing.assert_allclose(st_out.p.numpy(), np.asarray(j_out.p), rtol=0, atol=1e-8)
    np.testing.assert_allclose(st_out.line.numpy(), np.asarray(j_out.line), rtol=0, atol=1e-8)
    assert int(stats.accepted) == int(j_stats.accepted)


@pytest.mark.parametrize("lp", VARIANTS)
def test_estimator_path_groups_reuse_prior(lp):
    """The estimator path round-trips anchored lines through world
    coordinates between solve and marginalization: the carried residual
    groups give the same IRLS weights as a from-scratch evaluation, and the
    priors with and without them agree as quadratic forms (the reference's
    6 % for float32 eigenmodes near the pinv floor)."""
    from plslam_torch.models import marginalization as marg
    from plslam_torch.models.estimator import backend_tick

    cfg = SolverConfig(max_features=48, max_line_feats=16, dtype="float32", line_param=lp)
    lay = layout(cfg)
    seq = jsyn.make_sequence(duration=8.0, n_points=80, n_lines=40, seed=3)
    state, f_j = factors_from_synthetic(seq, list(range(0, 22, 2)), cfg, lay, with_lines=True)
    st = convert.window_state_from_numpy(npy(state), dtype=torch.float32)
    f = convert.factors_from_numpy(npy(f_j), dtype=torch.float32)
    MF, ML = cfg.max_features, cfg.max_line_feats
    zeros = torch.zeros(MF, dtype=torch.float32)
    st_out, stats, _, aux = backend_tick(
        st, f, f.pt_valid, zeros, torch.ones(MF, dtype=torch.float32),
        torch.zeros(ML, dtype=torch.float32), f.ln_valid, lay, cfg, False, False, 8, "old")
    f_ref = f._replace(pt_valid=aux["pt_valid"], ln_valid=aux["ln_solved"])

    pt_g, ln_g, _ = tres.weights_of_groups(stats.groups, cfg.cauchy_c)
    st_chart = st_out._replace(line=tres.lines_from_world(st_out, st_out.line, f.ln_start, lp))
    pt_r, ln_r, _ = tres.robust_weights(st_chart, f_ref, cfg.focal_length, cfg.cauchy_c, lp)
    np.testing.assert_allclose(pt_g.numpy(), pt_r.numpy(), atol=1e-4)
    np.testing.assert_allclose(ln_g.numpy(), ln_r.numpy(), atol=1e-4)
    # JAX's from-scratch weights at the port's state
    to_j = lambda cls, nt: cls(*[jnp.asarray(x.numpy()) for x in nt])  # noqa: E731
    pt_j, ln_j, _ = jres.robust_weights(to_j(type(state), st_chart), to_j(type(f_j), f_ref),
                                        cfg.focal_length, cfg.cauchy_c, lp)
    np.testing.assert_allclose(pt_g.numpy(), np.asarray(pt_j), atol=1e-4)
    np.testing.assert_allclose(ln_g.numpy(), np.asarray(ln_j), atol=1e-4)

    prior_a = marg.marginalize_old(st_out, f_ref, lay, cfg, groups=stats.groups)
    prior_b = marg.marginalize_old(st_out, f_ref, lay, cfg)
    Ja, Jb = prior_a.J.double().numpy(), prior_b.J.double().numpy()
    Ha, Hb = Ja.T @ Ja, Jb.T @ Jb
    rel = np.linalg.norm(Ha - Hb) / max(np.linalg.norm(Hb), 1e-9)
    assert rel < 0.06, f"groups-reuse prior H diverges: rel {rel:.2e}"
    ba_, bb_ = Ja.T @ prior_a.r0.double().numpy(), Jb.T @ prior_b.r0.double().numpy()
    b_rel = np.linalg.norm(ba_ - bb_) / max(np.linalg.norm(bb_), 1e-6)
    assert b_rel < 0.06, f"groups-reuse prior b diverges: rel {b_rel:.2e}"
