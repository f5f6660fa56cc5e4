"""Online camera-IMU extrinsic refinement on the port
(`tests/test_extrinsic.py::test_solver_refines_perturbed_extrinsic`'s
assertions): the window solver pulls a 2° + 2 cm miscalibrated extrinsic
back toward the truth through the projection factors, and leaves it where
it is while the extrinsic is frozen; and JAX's solver, given the same
perturbed window, lands where the port does.

Bounds: the reference's on the port (frozen q_bc unchanged to 1e-12;
estimated, the rotation error below a quarter of the start's, the lever-arm
error below half, every window position within 2e-2 m of the truth). The
window comes from the port's own packing (`models/packing.py`) at the
reference's widths (96 features, float64) and equals JAX's packing of the
same sequence within 1e-12 (relative, +1e-12 absolute). After the 12 estimated iterations, the port's
p_bc, q_bc and positions are JAX's within 1e-8 (the same float64 solve;
differences are summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.config import SolverConfig as JSolverConfig
from plslam.io import synthetic as jsyn
from plslam.models import packing as jpacking
from plslam.models import solver as jsolver
from plslam.models.state import layout as jlayout
from plslam_torch.config import SolverConfig
from plslam_torch.io import synthetic
from plslam_torch.models import packing, solver
from plslam_torch.models.state import layout
from plslam_torch.utils.geometry import quat_mul, quat_normalize

CFG = SolverConfig(max_features=96, max_line_feats=16, dtype="float64")
LAY = layout(CFG)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ypr_quat(yaw, pitch, roll):
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    return np.array([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ])


def _angle_deg(q, q_gt):
    return 2.0 * np.degrees(np.arccos(min(abs(float(torch.dot(q, q_gt))), 1.0)))


def test_solver_refines_perturbed_extrinsic():
    seq = synthetic.make_sequence(duration=6.0, n_points=260, n_lines=16, seed=5)
    frames = list(range(0, 55, 5))
    state_gt, f = packing.factors_from_synthetic(seq, frames, CFG, LAY, with_lines=False,
                                                 device="cpu")
    dq = torch.as_tensor(_ypr_quat(np.radians(2.0), np.radians(-1.2), np.radians(0.8)))
    pert = state_gt._replace(q_bc=quat_normalize(quat_mul(state_gt.q_bc, dq)),
                             p_bc=state_gt.p_bc + torch.tensor([0.02, -0.012, 0.008],
                                                               dtype=torch.float64))
    ang0 = _angle_deg(pert.q_bc, state_gt.q_bc)
    t0 = float(torch.linalg.norm(pert.p_bc - state_gt.p_bc))

    st_frozen, _ = solver.optimize_window(pert, f, LAY, CFG, num_iters=8)
    np.testing.assert_allclose(st_frozen.q_bc.numpy(), pert.q_bc.numpy(), atol=1e-12)

    st, stats = solver.optimize_window(pert, f, LAY, CFG, estimate_extrinsic=True, num_iters=12)
    ang1 = _angle_deg(st.q_bc, state_gt.q_bc)
    t1 = float(torch.linalg.norm(st.p_bc - state_gt.p_bc))
    assert ang1 < 0.25 * ang0, (ang0, ang1)
    assert t1 < 0.5 * t0, (t0, t1)
    p_err = float(torch.linalg.norm(st.p - state_gt.p, dim=-1).max())
    assert p_err < 2e-2, p_err

    # JAX's packing and solver on the same sequence and perturbation
    jseq = jsyn.SyntheticSequence(*[jnp.asarray(np.asarray(x)) for x in seq])
    jcfg = JSolverConfig(max_features=96, max_line_feats=16, dtype="float64")
    jlay = jlayout(jcfg)
    jstate_gt, jf = jpacking.factors_from_synthetic(jseq, frames, jcfg, jlay, with_lines=False)
    for ours, theirs in ((state_gt, jstate_gt), (f, jf)):
        for name in ours._fields:
            np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)),
                                       rtol=1e-12, atol=1e-12, err_msg=name)
    jpert = jstate_gt._replace(q_bc=jnp.asarray(pert.q_bc.numpy()),
                               p_bc=jnp.asarray(pert.p_bc.numpy()))
    jst, _ = jsolver.optimize_window(jpert, jf, jlay, jcfg, estimate_extrinsic=True, num_iters=12)
    for name in ("p_bc", "q_bc", "p"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(jst, name)),
                                   rtol=0, atol=1e-8, err_msg=name)
