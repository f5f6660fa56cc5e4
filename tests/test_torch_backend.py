"""Port parity, backend: the LM/Schur window solve, marginalization, one
`backend_tick` from a mid-run estimator state, initialization, and the
synthetic runner (milestone A), `plslam_torch` against `plslam` in float64.

Tolerances (stated per comparison):
  * solve / marginalization / backend tick: 1e-8 absolute on states and on
    the prior's information (JᵀJ, Jᵀr — the eigenvector basis of J itself
    is sign-ambiguous), relative to the matrix scale. Both packages run the
    same float64 algebra; differences are summation order, ~1e-12 measured
    on states (one exception, stated where it applies).
  * initialization: the same accept / reject decision, the same gravity
    -aligned state to 1e-6 (it passes through SVDs and 25 LM iterations).
  * milestone A: ATE ≤ 1e-4 m and the two trajectories within 1e-6 m.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.config import PLSlamConfig, SolverConfig
from plslam.eval.metrics import ate_rmse
from plslam.io import synthetic as jsyn
from plslam.models import estimator as jest_mod
from plslam.models import marginalization as jmarg
from plslam.models import packing
from plslam.models import solver as jsolver
from plslam.models.state import layout, retract as jretract
from plslam.runner import ImuFeeder as JImuFeeder
from plslam.runner import run_synthetic as j_run_synthetic
from plslam_torch import convert
from plslam_torch.io import synthetic as tsyn
from plslam_torch.models import estimator as test_mod
from plslam_torch.models import initializer as tini
from plslam_torch.models import marginalization as tmarg
from plslam_torch.models import solver as tsolver
from plslam_torch.runner import ImuFeeder as TImuFeeder
from plslam_torch.runner import run_synthetic as t_run_synthetic

CFG = SolverConfig(max_features=48, max_line_feats=12, dtype="float64")
LAY = layout(CFG)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def npy(nt):
    return type(nt)(*[np.asarray(x) for x in nt])


def info(prior):
    """The prior's information (JᵀJ, Jᵀr0): invariant to J's row basis."""
    J, r = np.asarray(prior.J), np.asarray(prior.r0)
    return J.T @ J, J.T @ r


@pytest.fixture(scope="module")
def window():
    seq = jsyn.make_sequence(duration=6.0, n_points=120, n_lines=40, seed=3)
    state, f = packing.factors_from_synthetic(seq, list(range(0, 55, 5)), CFG, LAY)
    d = np.random.default_rng(0).standard_normal(LAY.dim) * 1e-2
    d[LAY.off_line:] *= 0.1
    st0 = jretract(state, jnp.asarray(d), LAY)
    return st0, f, convert.window_state_from_numpy(npy(st0)), convert.factors_from_numpy(npy(f))


def test_optimize_window_matches_jax(window):
    st0, f, ts0, tf = window
    js, jst = jsolver.optimize_window(st0, f, LAY, CFG)
    ts, tst = tsolver.optimize_window(ts0, tf, LAY, CFG)
    for name in ts._fields:
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=0, atol=1e-8, err_msg=name)
    assert int(tst.accepted) == int(jst.accepted)
    np.testing.assert_allclose(float(tst.cost), float(jst.cost), rtol=1e-8)
    np.testing.assert_allclose(float(tst.cost_robust), float(jst.cost_robust), rtol=1e-8)
    # Schur on the structured blocks equals the dense full-tangent path
    td, _ = tsolver.optimize_window(ts0, tf, LAY, CFG, dense=True)
    for name in ts._fields:
        np.testing.assert_allclose(getattr(td, name).numpy(), getattr(ts, name).numpy(),
                                   rtol=0, atol=1e-8, err_msg=name)


def test_schur_solve_blocks_matches_jax(window):
    st0, f, ts0, tf = window
    mask_j = jsolver.free_mask(f, LAY, CFG, False, False)
    mask_t = tsolver.free_mask(tf, LAY, CFG, False, False)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    r_j, Jc_j, bl_j = jsolver.linearize_blocks(st0, f, LAY, CFG.focal_length, None, None, mask_j)
    r_t, Jc_t, bl_t = tsolver.linearize_blocks(ts0, tf, LAY, CFG.focal_length, None, None, mask_t)
    np.testing.assert_allclose(Jc_t.numpy(), np.asarray(Jc_j), rtol=1e-9, atol=1e-9)
    d_j = jsolver.schur_solve_blocks(r_j, Jc_j, bl_j, LAY, 1e-4, mask_j)
    d_t = tsolver.schur_solve_blocks(r_t, Jc_t, bl_t, LAY, 1e-4, mask_t)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-8)
    # the dense cross-check solves the same system
    r_d, J_d = tsolver.linearize(ts0, tf, LAY, CFG.focal_length, None, None, mask_t)
    d_d = tsolver.schur_solve(J_d.T @ J_d, J_d.T @ r_d, LAY, 1e-4, mask_t)
    np.testing.assert_allclose(d_d.numpy(), d_t.numpy(), rtol=0, atol=1e-8)


def _compare_prior(tp, jp, vec_tol=1e-8):
    (H_t, g_t), (H_j, g_j) = info(tp), info(jp)
    np.testing.assert_allclose(H_t, H_j, rtol=0, atol=1e-8 * max(1.0, np.abs(H_j).max()))
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=vec_tol * max(1.0, np.abs(g_j).max()))
    for name in ("valid", "p", "q", "v", "ba", "bg", "p_bc", "q_bc", "td"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   rtol=0, atol=1e-12, err_msg=name)


def test_marginalization_matches_jax(window):
    st0, f, ts0, tf = window
    jp = jmarg.marginalize_old(st0, f, LAY, CFG)
    tp = tmarg.marginalize_old(ts0, tf, LAY, CFG)
    _compare_prior(tp, jp)
    # second-new on top of the installed prior
    f2 = jmarg.install_prior(f, jp)
    tf2 = tmarg.install_prior(tf, convert.prior_from_numpy(npy(jp)))
    _compare_prior(tmarg.marginalize_second_new(ts0, tf2, LAY, CFG),
                   jmarg.marginalize_second_new(st0, f2, LAY, CFG))


def _rank_deficient_scaled(seed, n=163, zero=87):
    """A float32 PSD matrix shaped like the marginalization matrix on which
    MKL's float32 `eigh` failed to converge in a 320×240 float32 run with
    lines: 163×163, Jacobi-scaled (unit diagonal, |H| ≤ 1), rank-deficient,
    with 87 all-zero rows and columns (unobserved slots); and a right-hand
    side."""
    rng = np.random.default_rng(seed)
    k = n - zero
    A = rng.standard_normal((k, k // 2))
    B = A @ A.T
    d = np.sqrt(np.diag(B))
    M = np.zeros((n, n))
    idx = np.sort(rng.choice(n, k, replace=False))
    M[np.ix_(idx, idx)] = B / d[:, None] / d[None, :]
    return M.astype(np.float32), rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("seed", [5, 25])
def test_float32_eigh_returns_where_jax_does(seed):
    """`_pinv_psd` and `_sqrt_refactor` in float32 on matrices where MKL's
    float32 `ssyevd` raises "failed to converge" and the JAX package's
    float32 `eigh` returns: the port's results match JAX's within 1e-5 of
    their scale (both float32; ~1e-6 seen)."""
    from plslam_torch.config import SolverConfig as TSolverConfig

    M, b = _rank_deficient_scaled(seed)
    eps = tmarg._eps(TSolverConfig(), torch.float32)
    jP = np.asarray(jmarg._pinv_psd(jnp.asarray(M), eps))
    tP = tmarg._pinv_psd(torch.as_tensor(M), eps)
    assert tP.dtype == torch.float32
    np.testing.assert_allclose(tP.numpy(), jP, rtol=0, atol=1e-5 * np.abs(jP).max())
    jJ, jr = (np.asarray(x) for x in jmarg._sqrt_refactor(jnp.asarray(M), jnp.asarray(b), eps))
    tJ, tr = (x.numpy() for x in tmarg._sqrt_refactor(torch.as_tensor(M), torch.as_tensor(b), eps))
    for a, c in ((tJ.T @ tJ, jJ.T @ jJ), (tJ.T @ tr, jJ.T @ jr)):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-5 * np.abs(c).max())


def test_finish_solve_raises_on_the_eigh_flag():
    """The solve's bundle carries the marginalization's eigh flag last
    (`backend_tick` leaves it on the card): `_finish_solve` takes a bundle
    laid out by `pack_bundle` with the flag at 0 and raises `LinAlgError`,
    as `torch.linalg.eigh` does, with it at 1."""
    import types

    from plslam_torch.config import PLSlamConfig as TPLSlamConfig
    from plslam_torch.config import SolverConfig as TSolverConfig
    from plslam_torch.models.estimator import Estimator, pack_bundle

    est = Estimator(TPLSlamConfig(solver=TSolverConfig(max_features=8, max_line_feats=4,
                                                       window_size=4)), device="cpu")
    MF, ML = est.cfg.max_features, est.cfg.max_line_feats
    z = lambda *shape: torch.zeros(shape, dtype=est.dtype)  # noqa: E731
    stats = types.SimpleNamespace(cost0=z(), cost=z(), cost_robust0=z(), cost_robust=z(),
                                  accepted=z())
    aux = dict(commit=z(MF), lcommit=z(ML), pt_valid=z(MF), ln_solved=z(ML), pt_err=z(MF),
               ln_err=z(ML), p_w=z(MF, 3), eigh_failed=z())
    st = est._device_state()
    m = est._finish_solve(pack_bundle(st, stats, aux).numpy().astype(np.float64))
    assert m["n_pts"] == 0
    b = pack_bundle(st, stats, {**aux, "eigh_failed": torch.ones((), dtype=est.dtype)})
    with pytest.raises(torch.linalg.LinAlgError):
        est._finish_solve(b.numpy().astype(np.float64))


# ---------------------------------------------------------------- estimator
EST_CONFIG = PLSlamConfig(solver=SolverConfig(max_features=64, max_line_feats=16, dtype="float64"))


@pytest.fixture(scope="module")
def seqs():
    kw = dict(duration=4.5, n_points=140, n_lines=48, seed=11)
    return jsyn.make_sequence(**kw), tsyn.make_sequence(**kw)


def _frames(seq, stride=2):
    frame_t = np.asarray(seq.frame_t)[::stride]
    obs = np.asarray(seq.obs)[::stride]
    valid = np.asarray(seq.obs_valid)[::stride]
    for k, t in enumerate(frame_t):
        vis = np.nonzero(valid[k])[0]
        yield k, float(t), vis, obs[k, vis]


def _with_seq_extrinsic(seq):
    import dataclasses

    from plslam.config import ExtrinsicConfig
    from plslam.utils.geometry import quat_to_rot

    R_bc = np.asarray(quat_to_rot(seq.q_bc))
    return dataclasses.replace(EST_CONFIG, extrinsic=ExtrinsicConfig(
        rot=tuple(R_bc.reshape(-1).tolist()), trans=tuple(np.asarray(seq.p_bc).tolist())))


def test_backend_tick_from_jax_midrun_state(seqs):
    """Drive the JAX estimator to mid-run (with a live prior), then hand its
    exact solve inputs to both packages' `backend_tick`."""
    seq = seqs[0]
    cfg = _with_seq_extrinsic(seq)
    est = jest_mod.Estimator(cfg)
    feeder = JImuFeeder(np.asarray(seq.imu_t), np.asarray(seq.imu_acc), np.asarray(seq.imu_gyr))
    gt_p, gt_q, gt_v = (np.asarray(a)[::2] for a in (seq.gt_p, seq.gt_q, seq.gt_v))
    for k, t, ids, obs in _frames(seq):
        feeder.feed_until(est, t)
        oracle = {"p": gt_p[k], "q": gt_q[k], "v": gt_v[k]}
        est.process_frame(t, ids, obs, oracle_state=oracle, defer_solve=True)
        if est._pending is not None and est.prior is not None and k >= 16:
            break
    assert est._pending is not None and est.prior is not None
    mode = est._pending["mode"]
    st, f = est._device_state(), est._factors()
    tbl, ltb = est.pt_table, est.ln_table
    solvable = tbl.solvable()
    masks = [solvable, solvable & (tbl.inv_depth <= 0), np.sum(tbl.mask, axis=1) >= 4]
    ln_active2 = ltb.active & (np.sum(ltb.mask, axis=1) >= 2)
    masks += [ln_active2 & ~ltb.solved, ln_active2]
    lay = layout(cfg.solver)
    kw = dict(ee=False, etd=False, iters=8, marg_mode=mode)
    j_out = jest_mod.backend_tick(st, f, *[jnp.asarray(m, jnp.float64) for m in masks],
                                  lay, cfg.solver, **kw)
    t_out = test_mod.backend_tick(convert.window_state_from_numpy(npy(st)),
                                  convert.factors_from_numpy(npy(f)),
                                  *[torch.as_tensor(m.astype(np.float64)) for m in masks],
                                  lay, cfg.solver, **kw)
    (js, jstats, jprior, jaux), (ts, tstats, tprior, taux) = j_out, t_out
    for name in ts._fields:
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=0, atol=1e-8, err_msg=name)
    for key in jaux:
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]), rtol=0, atol=1e-8,
                                   err_msg=key)
    np.testing.assert_allclose(float(tstats.cost), float(jstats.cost), rtol=1e-8)
    # Jᵀr0 is the gradient projected on the eigen-directions above the
    # marginalization's eigenvalue floor; directions near the floor amplify
    # summation-order noise (measured 1.7e-8 on a 0.16 scale): 1e-7 here
    _compare_prior(tprior, jprior, vec_tol=1e-7)
    est.finalize()


def test_try_initialize_matches_jax(seqs):
    """Both estimators fed the same frames and IMU; at every frame the window
    is full, both run `try_initialize` on their buffers."""
    jseq, tseq = seqs
    cfg = _with_seq_extrinsic(jseq)
    je = jest_mod.Estimator(cfg)
    te = test_mod.Estimator(convert.config_from_jax(cfg), device="cpu")
    jf = JImuFeeder(np.asarray(jseq.imu_t), np.asarray(jseq.imu_acc), np.asarray(jseq.imu_gyr))
    tf = TImuFeeder(np.asarray(tseq.imu_t), np.asarray(tseq.imu_acc), np.asarray(tseq.imu_gyr))
    from plslam.models import initializer as jini

    decisions = []
    for k, t, ids, obs in _frames(jseq):
        jf.feed_until(je, t)
        tf.feed_until(te, t)
        if je.frame_count < cfg.solver.window_size:
            je.process_frame(t, ids, obs)
            te.process_frame(t, ids, obs)
            continue
        fc = cfg.solver.window_size
        for e in (je, te):  # process_frame's steps up to the initialization attempt
            e.timestamps[fc] = t
            e.td_pair[fc] = e.td
            e._close_interval(fc)
            e.pt_table.add_frame(fc, ids, obs, None)
        ok_j, ok_t = jini.try_initialize(je), tini.try_initialize(te)
        decisions.append((ok_j, ok_t))
        assert ok_j == ok_t, decisions
        if ok_j:
            break
        je._slide_uninitialized()
        te._slide_uninitialized()
    assert decisions and decisions[-1] == (True, True), decisions
    for name in ("p", "q", "v", "bg"):
        np.testing.assert_allclose(getattr(te, name), getattr(je, name), rtol=0, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(te.pt_table.inv_depth > 0, je.pt_table.inv_depth > 0)


def test_milestone_a_run_synthetic(seqs):
    """`run_synthetic(oracle_init=True)` on the same `make_sequence(seed=11)`."""
    jseq, tseq = seqs
    jts, jps, _, _ = j_run_synthetic(jseq, EST_CONFIG, oracle_init=True, use_lines=True)
    tts, tps, _, test = t_run_synthetic(tseq, convert.config_from_jax(EST_CONFIG), oracle_init=True,
                                        use_lines=True, device="cpu")
    assert test.initialized and len(tts) > 15
    np.testing.assert_array_equal(tts, jts)
    np.testing.assert_allclose(tps, jps, rtol=0, atol=1e-6)
    ate = ate_rmse(tts, tps, np.asarray(tseq.frame_t), np.asarray(tseq.gt_p), align="yaw")
    assert ate <= 1e-4, ate
