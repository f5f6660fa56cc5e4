"""Both packages' estimators on one frontend's outputs, over the smoke set.

Runs one package's `run_euroc` (synchronous, on the CPU) over the smoke set
of `chip_smoke.py` with its configuration, recording every call the runner
makes into the estimator (`process_imu`, `process_frame`: IMU samples,
point tracks, line ids and segments). Then replays the recording into a
fresh estimator of each package, with the lines and without them, and
prints each replay's yaw-aligned ATE and its solve costs. The same inputs
through both estimators separate what the estimator does from what the
frontends feed it.

Run from the repository root (CPU; the port's replays take minutes each):

    JAX_PLATFORMS=cpu python3 scripts/estimator_replay.py --frontend jax
    JAX_PLATFORMS=cpu python3 scripts/estimator_replay.py --frontend port
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from smoke_ate import jax_config  # noqa: E402


def record(estimator_cls, run):
    """The estimator calls of `run()`, in order."""
    calls = []
    o_imu, o_frame = estimator_cls.process_imu, estimator_cls.process_frame

    def imu(self, dt, acc, gyr):
        calls.append(("imu", float(dt), np.array(acc, np.float64), np.array(gyr, np.float64)))
        return o_imu(self, dt, acc, gyr)

    def frame(self, t, ids, pts, vel=None, ln_ids=None, ln_segs=None, **kw):
        copy = lambda a: None if a is None else np.array(a)  # noqa: E731
        calls.append(("frame", float(t), copy(ids), copy(pts), copy(vel), copy(ln_ids),
                      copy(ln_segs)))
        return o_frame(self, t, ids, pts, vel, ln_ids, ln_segs, **kw)

    estimator_cls.process_imu, estimator_cls.process_frame = imu, frame
    try:
        out = run()
    finally:
        estimator_cls.process_imu, estimator_cls.process_frame = o_imu, o_frame
    return calls, out


def replay(est, calls, lines):
    """(times, positions, costs) of `est` fed `calls`, as the runner emits."""
    ts, ps, costs = [], [], []
    for c in calls:
        if c[0] == "imu":
            est.process_imu(*c[1:])
            continue
        _, t, ids, pts, vel, ln_ids, ln_segs = c
        if not lines:
            ln_ids = ln_segs = None
        m = est.process_frame(t, ids, pts, vel, ln_ids, ln_segs, defer_solve=False)
        est.finalize()
        costs.append(m.get("cost"))
        if "cost" in m and not m.get("failure") and est.initialized:
            tt, p, _ = est.latest_pose()
            ts.append(tt)
            ps.append(p)
    return np.asarray(ts), np.asarray(ps), costs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frontend", choices=("jax", "port"), default="jax")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float64")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    import torch

    from plslam.eval.metrics import ate_rmse
    from plslam.models import estimator as jest
    from plslam.runner import run_euroc as j_run_euroc
    from plslam_torch.models import estimator as test
    from plslam_torch.runner import run_euroc as t_run_euroc

    torch.set_num_threads(4)
    path, _ = chip_smoke.render_dataset()
    meta = np.load(os.path.join(path, "meta.npz"))
    cfg = chip_smoke.smoke_config(meta)  # binary-LBD lines
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, dtype=args.dtype))
    jcfg = jax_config(cfg)

    def ate(ts, ps):
        return float(ate_rmse(ts, ps, meta["gt_t"], meta["gt_p"], align="yaw"))

    kw = dict(use_lines=True, loop_closure=False, pipeline=False)
    t0 = time.perf_counter()
    if args.frontend == "jax":
        calls, out = record(jest.Estimator, lambda: j_run_euroc(path, jcfg, **kw))
    else:
        calls, out = record(test.Estimator, lambda: t_run_euroc(path, cfg, device="cpu", **kw))
    results = {"run": ate(out[0], out[1])}
    print(f"{args.frontend} run_euroc: {len(out[0])} poses, ATE(yaw) {results['run']:.4f} m, "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    estimators = {"jax": lambda: jest.Estimator(jcfg), "port": lambda: test.Estimator(cfg, device="cpu")}
    for name, make in estimators.items():
        for lines in (True, False):
            t0 = time.perf_counter()
            ts, ps, costs = replay(make(), calls, lines)
            key = f"{name} estimator, {'lines' if lines else 'points only'}"
            results[key] = ate(ts, ps)
            first = [round(c, 2) for c in costs if c is not None][:5]
            print(f"{key}: {len(ts)} poses, ATE(yaw) {results[key]:.4f} m, first costs {first}, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
