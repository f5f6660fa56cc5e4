"""Port parity, the structured normal-equation assembly
(`models/assembly.py`, `solver.optimize_window(structured=True)`), float64.

Windows: `tests/test_line_variants.py`'s (48 features, 16 lines, 11
frames), with every factor the simulator's packing leaves idle switched on
from a seeded draw: a valid marginalization prior, relocalization factors,
a nonzero td with feature velocities, a rolling-shutter row delay, and (for
the comparison with the port's own dense path) per-frame pairing-time td's
and a prior linearized away from the current state.

Tolerances (as `tests/test_solver.py` / `tests/test_line_variants.py`):
  * H, b against the dense `linearize`'s JᵀJ, Jᵀr and against JAX's
    `assembly.assemble`: 1e-9 × max|·| (the same jacobians summed in another
    order); the cost 1e-10 relative;
  * `optimize_window(structured=True)` against the port's blocks path and
    against JAX's structured solve, 6 LM iterations: 1e-8 m (the same
    algebra; `tests/test_solver.py` holds JAX's structured-vs-dense to 1e-6).

JAX's `assemble` runs under `jax.jit` here (75 s eager, 9 s jitted, on a
CPU). JAX's module leaves out the pairing-time td and takes the prior's
∂(x ⊟ x₀)/∂δ as the identity, also over the relo pose, which the prior's
snapshot does not hold. So the JAX comparison keeps td_ref = 0, the prior at
its linearization point and no prior column on the relo pose, where JAX's
module is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.config import SolverConfig
from plslam.io import synthetic as jsyn
from plslam.models import assembly as jasm
from plslam.models import solver as jsolver
from plslam.models.packing import factors_from_synthetic
from plslam.models.state import layout
from plslam_torch import convert
from plslam_torch.models import assembly as tasm
from plslam_torch.models import residuals as tres
from plslam_torch.models import solver as tsolver
from plslam_torch.models.state import retract

CFG = SolverConfig(max_features=48, max_line_feats=16, dtype="float64")
LAY = layout(CFG)
CHARTS = ["world", "incamera", "instartframe"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def npy(nt):
    return type(nt)(*[np.asarray(x) for x in nt])


@pytest.fixture(scope="module")
def window():
    seq = jsyn.make_sequence(duration=8.0, n_points=80, n_lines=40, seed=3)
    state, f = factors_from_synthetic(seq, list(range(0, 22, 2)), CFG, LAY, with_lines=True)
    return npy(state), npy(f)


def rich(window, lp, jax_safe, seed=0):
    """The window in chart `lp`, perturbed, with the idle factors switched
    on (see the module docstring). Returns numpy (state, factors)."""
    st_np, f_np = window
    rng = np.random.default_rng(seed)
    st = convert.window_state_from_numpy(st_np)
    f = convert.factors_from_numpy(f_np)
    st = st._replace(line=tres.lines_from_world(st, st.line, f.ln_start, lp))
    d = np.zeros(LAY.dim)
    d[6:LAY.off_sb] = rng.standard_normal(LAY.off_sb - 6) * 3e-3
    d[LAY.off_ext:LAY.off_td] = rng.standard_normal(6) * 2e-3
    d[LAY.off_depth:] = rng.standard_normal(LAY.dim - LAY.off_depth) * 3e-3
    st = retract(st, torch.as_tensor(d), LAY)
    NW, MF, DC = LAY.nw, LAY.max_f, LAY.dim_cam
    # relocalization: an old keyframe near frame 3's pose, the window's
    # points seen from it
    st = st._replace(td=torch.tensor(0.004, dtype=torch.float64),
                     relo_p=st.p[3] + torch.as_tensor(rng.standard_normal(3) * 0.05),
                     relo_q=st.q[3])
    p_w = tres._world_points(st, f)
    from plslam_torch.utils.geometry import pose_inverse, quat_mul, quat_rotate

    p_cw, q_cw = pose_inverse(st.relo_p + quat_rotate(st.relo_q, st.p_bc),
                              quat_mul(st.relo_q, st.q_bc))
    x_c = quat_rotate(q_cw.expand(MF, 4), p_w) + p_cw
    relo_obs = (x_c[:, :2] / x_c[:, 2:]).numpy() + rng.standard_normal((MF, 2)) * 2e-3
    J0 = rng.standard_normal((DC, DC)) * 0.3
    fields = dict(
        pt_vel=rng.standard_normal((MF, NW, 2)) * 0.2,
        pt_rowf=rng.uniform(0, 1, (MF, NW)), rs_tr=np.float64(0.02),
        relo_obs=relo_obs, relo_mask=(rng.uniform(size=MF) < 0.7).astype(np.float64),
        relo_valid=np.float64(1.0),
        prior_J=J0, prior_r0=rng.standard_normal(DC) * 0.5, prior_valid=np.float64(1.0))
    snap = st
    if jax_safe:
        J0[:, LAY.off_relo:DC] = 0.0
    else:
        fields["pt_td_ref"] = rng.standard_normal(NW) * 2e-3
        dsnap = np.zeros(LAY.dim)
        dsnap[:DC] = rng.standard_normal(DC) * 2e-2
        snap = retract(st, torch.as_tensor(dsnap), LAY)
    fields.update(prior_p=snap.p.numpy(), prior_q=snap.q.numpy(), prior_v=snap.v.numpy(),
                  prior_ba=snap.ba.numpy(), prior_bg=snap.bg.numpy(), prior_p_bc=snap.p_bc.numpy(),
                  prior_q_bc=snap.q_bc.numpy(), prior_td=snap.td.numpy())
    return npy(st), f_np._replace(**{k: np.asarray(v, np.float64) for k, v in fields.items()})


def t_inputs(st_np, f_np, lp):
    st, f = convert.window_state_from_numpy(st_np), convert.factors_from_numpy(f_np)
    w = tres.robust_weights(st, f, CFG.focal_length, CFG.cauchy_c, lp)
    return st, f, w


def close_rel(a, b, rel=1e-9):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * (np.abs(b).max() + 1e-12))


@pytest.mark.parametrize("lp", CHARTS)
def test_assemble_matches_dense(window, lp):
    """`test_solver.py::test_structured_assembly_matches_dense` and
    `test_line_variants.py::test_assembly_matches_dense` on the port, with
    every factor type live (pairing-time td's, a prior off its point)."""
    st, f, (pt_w, ln_w, relo_w) = t_inputs(*rich(window, lp, jax_safe=False), lp)
    assert float(f.relo_valid) == 1 and float(f.prior_valid) == 1
    mask = torch.ones(LAY.dim, dtype=torch.float64)
    r, J = tsolver.linearize(st, f, LAY, CFG.focal_length, pt_w, ln_w, mask, relo_w, lp)
    H, b, cost = tasm.assemble(st, f, LAY, CFG.focal_length, pt_w, ln_w, relo_w, lp)
    close_rel(H, J.T @ J)
    close_rel(b, J.T @ r)
    np.testing.assert_allclose(float(cost), float(tsolver.cost_of(r)), rtol=1e-10)
    # each factor type reached H: relo, prior, anchored line poses
    assert float(H[LAY.off_relo, LAY.off_relo]) > 0
    if lp != "world":
        assert float(torch.abs(H[LAY.off_line:, :LAY.off_sb]).max()) > 0


@pytest.mark.parametrize("lp", CHARTS)
def test_assemble_matches_jax(window, lp):
    st_np, f_np = rich(window, lp, jax_safe=True)
    st, f, (pt_w, ln_w, relo_w) = t_inputs(st_np, f_np, lp)
    H, b, cost = tasm.assemble(st, f, LAY, CFG.focal_length, pt_w, ln_w, relo_w, lp)
    to_j = lambda nt: type(nt)(*[jnp.asarray(x) for x in nt])  # noqa: E731
    j_asm = jax.jit(jasm.assemble, static_argnums=(2, 3, 7))
    Hj, bj, cj = j_asm(to_j(st_np), to_j(f_np), LAY, CFG.focal_length, jnp.asarray(pt_w.numpy()),
                       jnp.asarray(ln_w.numpy()), jnp.asarray(relo_w.numpy()), lp)
    close_rel(H, Hj)
    close_rel(b, bj)
    np.testing.assert_allclose(float(cost), float(cj), rtol=1e-10)


def test_optimize_structured_matches_blocks_and_jax(window):
    """`test_solver.py::test_optimize_structured_matches_dense_solve`: 6 LM
    iterations from a perturbed window, the structured path against the
    blocks path on the port and against JAX's structured solve."""
    st_np, f_np = window
    rng = np.random.default_rng(8)
    delta = np.zeros(LAY.dim)
    delta[6: LAY.nw * 6] = rng.standard_normal((LAY.nw - 1) * 6) * 0.005
    st0 = retract(convert.window_state_from_numpy(st_np), torch.as_tensor(delta), LAY)
    f = convert.factors_from_numpy(f_np)
    ts, tstats = tsolver.optimize_window(st0, f, LAY, CFG, num_iters=6, structured=True)
    tb, bstats = tsolver.optimize_window(st0, f, LAY, CFG, num_iters=6)
    for name in ts._fields:
        np.testing.assert_allclose(getattr(ts, name).numpy(), getattr(tb, name).numpy(),
                                   rtol=0, atol=1e-8, err_msg=name)
    assert int(tstats.accepted) == int(bstats.accepted)
    jst0 = type(st_np)(*[jnp.asarray(x.numpy()) for x in st0])
    js, jstats = jsolver.optimize_window(jst0, type(f_np)(*map(jnp.asarray, f_np)), LAY, CFG,
                                         num_iters=6, structured=True)
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), rtol=0, atol=1e-8)
    np.testing.assert_allclose(ts.q.numpy(), np.asarray(js.q), rtol=0, atol=1e-8)
    assert int(tstats.accepted) == int(jstats.accepted)
    np.testing.assert_allclose(float(tstats.cost), float(jstats.cost), rtol=1e-8)


def test_optimize_structured_with_pins_and_charts(window):
    """The structured path under the estimator's options: an anchored line
    chart, frozen frames, extra pinned dims, a dynamic pin mask, the
    extrinsic and td free, on the live-factor window: the blocks path's
    answer within 1e-8."""
    cfg = dataclasses.replace(CFG, line_param="incamera")
    st, f, _ = t_inputs(*rich(window, "incamera", jax_safe=False, seed=1), "incamera")
    pin = torch.ones(LAY.dim, dtype=torch.float64)
    pin[LAY.off_depth + 3] = 0.0
    kw = dict(estimate_extrinsic=True, estimate_td=True, num_iters=4, freeze_frames=(0,),
              extra_pinned=(LAY.off_sb + 9 * 4,), pin_mask=pin)
    ts, tstats = tsolver.optimize_window(st, f, LAY, cfg, structured=True, **kw)
    tb, bstats = tsolver.optimize_window(st, f, LAY, cfg, **kw)
    for name in ts._fields:
        np.testing.assert_allclose(getattr(ts, name).numpy(), getattr(tb, name).numpy(),
                                   rtol=0, atol=1e-8, err_msg=name)
    assert int(tstats.accepted) == int(bstats.accepted) > 0
    np.testing.assert_allclose(float(tstats.cost), float(bstats.cost), rtol=1e-8)
