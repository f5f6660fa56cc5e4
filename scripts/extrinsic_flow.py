"""The `estimate_extrinsic=2` live flow of `tests/test_extrinsic.py`, through
either package's `run_synthetic` with the test's ~9.5°-wrong R_bc
(`extrinsic_rot_override`), printed as a timeline.

The same sequence (the test's rotationally excited 12-s trajectory, seed 9)
and configuration in both packages. Prints, per package, the frames where
the hand-eye calibration converged, where the system initialized and where
failure detection cleared it, then the end state the test asserts on
(calibrated, initialized, the extrinsic's error in degrees, the poses
emitted) and the seconds the run took, and one JSON line of all of it.

Run from the repository root (the JAX package on the CPU):

    JAX_PLATFORMS=cpu python3 scripts/extrinsic_flow.py jax port
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEQUENCE = dict(duration=12.0, n_points=260, n_lines=0, seed=9)
TRAJECTORY = dict(omega=0.8, pitch_amp=0.3, roll_amp=0.25, wiggle_amp=0.3, excite_amp=0.1)
PERTURBATION_DEG = (7.0, -5.0, 4.0)  # yaw, pitch, roll of the starting error


def ypr_quat(yaw, pitch, roll):
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    return np.array([cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
                     cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr])


def flow(package, max_frames=None):
    """Run the flow through `package` ("jax" or "port"); returns its record."""
    if package == "jax":
        import jax

        jax.config.update("jax_enable_x64", True)
        from plslam.config import ExtrinsicConfig, PLSlamConfig, SolverConfig
        from plslam.io import synthetic
        from plslam.runner import run_synthetic
        from plslam.utils import quat_np as qnp
        kw = {}
    else:
        import torch

        torch.set_num_threads(1)
        from plslam_torch.config import ExtrinsicConfig, PLSlamConfig, SolverConfig
        from plslam_torch.io import synthetic
        from plslam_torch.runner import run_synthetic
        from plslam_torch.utils import quat_np as qnp
        kw = {"device": "cpu"}
    seq = synthetic.make_sequence(params=synthetic.TrajectoryParams(**TRAJECTORY), **SEQUENCE)
    q_true = np.asarray(seq.q_bc, np.float64)
    R_pert = qnp.quat_to_rot(q_true) @ qnp.quat_to_rot(ypr_quat(*np.radians(PERTURBATION_DEG)))
    cfg = PLSlamConfig(solver=SolverConfig(max_features=96, max_line_feats=16),
                       extrinsic=ExtrinsicConfig(estimate_extrinsic=2))
    t0 = time.perf_counter()
    ts, _, _, est = run_synthetic(seq, cfg, oracle_init=False, use_lines=False,
                                  max_frames=max_frames, extrinsic_rot_override=R_pert, **kw)
    seconds = time.perf_counter() - t0
    solved = [m["t"] for m in est.metrics if "cost" in m]
    failures = [m["t"] for m in est.metrics if m.get("failure")]
    err = 2.0 * np.degrees(np.arccos(min(abs(float(np.dot(est.q_bc, q_true))), 1.0)))
    return {"package": package, "calibrated": bool(est.ex_calibrated),
            "initialized": bool(est.initialized), "extrinsic_error_deg": float(err),
            "poses": len(ts), "hand_eye_pairs": len(est._ex_qcam), "solves": len(solved),
            "first_solve_t": solved[0] if solved else None, "failures_t": failures,
            "seconds": seconds}


def main(argv):
    packages = argv or ["jax", "port"]
    out = []
    for package in packages:
        rec = flow(package)
        print(f"{package}: calibrated {rec['calibrated']}, initialized {rec['initialized']}, "
              f"extrinsic error {rec['extrinsic_error_deg']:.4f}°, {rec['poses']} poses, "
              f"{rec['solves']} solves (first at t={rec['first_solve_t']}), failures at "
              f"{rec['failures_t']}, {rec['hand_eye_pairs']} pending hand-eye pairs, "
              f"{rec['seconds']:.1f} s", flush=True)
        out.append(rec)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
