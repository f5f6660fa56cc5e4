"""ATE of `run_euroc` over the smoke set of `chip_smoke.py`, by either package.

The same 240 rendered frames as the smoke (the port's simulator and renderer,
the same recipe and the same cache in the temp directory) and the smoke's
configuration, with the solver's dtype and the line matcher as asked. Each
mode is one `run_euroc`: `points` (no lines), `binary` (binary-LBD lines,
the smoke's main path) or `float` (float-cosine LBD lines). `loop` runs
the smoke's loop scene (its phase 6) with loop closure instead, in the JAX
loop test's configuration (points only, float64), and also prints the
pose graph's keyframes, loops, keyframe ATE before and after the PGO, the
loop gaps and the edges the relocalization round trip refined.

`--package jax` runs the JAX reference on the CPU (its configuration carried
field by field into `plslam.config`). `--jax-tracker` picks its point
tracker: `fast`, its default `lk_track_fast`; `per-feature`, its `lk_track`
(the Pallas kernel's formulation but for the det gate, which `lk_track`
applies at every level); or `pallas`, the Pallas kernel itself in
interpret mode (slow). `--package port` runs `plslam_torch` on `--device`
and imports nothing of JAX; `--port-tracker` picks its point tracker's
formulation: `fast` (its default, the JAX `lk_track_fast`) or `pallas` (the
JAX Pallas kernel's). `--seed` sets the point frontend's F-RANSAC seed (7
in both packages by default; their random streams differ).

Run from the repository root:

    JAX_PLATFORMS=cpu python3 scripts/smoke_ate.py --package jax points binary
    JAX_PLATFORMS=cpu python3 scripts/smoke_ate.py --package jax loop
    python3 scripts/smoke_ate.py --package port --device cuda --dtype float64 binary
    python3 scripts/smoke_ate.py --package port --device cuda --port-tracker pallas binary

Prints one line per run and a JSON line of the results.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (its module level imports numpy only)


def jax_config(cfg):
    """The JAX package's `PLSlamConfig` with the values of the port's one."""
    import plslam.config as jconfig

    sections = {f.name: type(f.default) for f in dataclasses.fields(jconfig.PLSlamConfig)}
    return jconfig.PLSlamConfig(**{name: sections[name](**value) if isinstance(value, dict) else value
                                   for name, value in dataclasses.asdict(cfg).items()})


def _with_init(cls, **kw):
    """Give `cls.__init__` the keyword values `kw` (the runners build the
    point frontend themselves)."""
    init = cls.__init__

    def patched(self, *a, **k):
        init(self, *a, **{**k, **kw})

    cls.__init__ = patched


def runner(package, device, dtype, jax_tracker="fast", seed=None, port_tracker="fast",
           x64=False):
    """(run_euroc taking the port's config, ate_rmse) of the package."""
    if package == "port":
        from plslam_torch.eval.metrics import ate_rmse
        from plslam_torch.models.frontend_points import FrontendPoints
        from plslam_torch.runner import run_euroc

        _with_init(FrontendPoints, tracker=port_tracker,
                   **({} if seed is None else {"seed": seed}))
        return (lambda path, cfg, **kw: run_euroc(path, cfg, device=device, **kw)), ate_rmse
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64" or x64)
    from plslam.eval.metrics import ate_rmse
    from plslam.models import frontend_points
    from plslam.runner import run_euroc

    if jax_tracker == "per-feature":
        frontend_points.lk_track_fast = frontend_points.lk_track  # read when the tick is traced
    if jax_tracker == "pallas":
        import functools

        from plslam.ops.kernels import lk

        lk.lk_track_pallas = functools.partial(lk.lk_track_pallas, interpret=True)
        _with_init(frontend_points.FrontendPoints, use_pallas=True)
    if seed is not None:
        init = frontend_points.FrontendPoints.__init__

        def seeded(self, *a, **k):
            init(self, *a, **k)
            self._key = jax.random.PRNGKey(seed)

        frontend_points.FrontendPoints.__init__ = seeded
    return (lambda path, cfg, **kw: run_euroc(path, jax_config(cfg), **kw)), ate_rmse


def loop_run(run_euroc, ate_rmse, args):
    """One `run_euroc(loop_closure=True)` over the loop scene; returns its
    results and prints them."""
    from plslam_torch.utils import quat_np as qnp

    path, render_s = chip_smoke.render_dataset("loop")
    print(f"dataset {path} (rendered in {render_s:.1f} s)", flush=True)
    meta = np.load(os.path.join(path, "meta.npz"))
    reference, _ = chip_smoke.loop_configs(meta)
    t0 = time.perf_counter()
    ts, ps, _, est, pg = run_euroc(path, reference, use_lines=False, loop_closure=True)
    wall = time.perf_counter() - t0
    n = pg.n
    gt_t, gt_p = meta["gt_t"], meta["gt_p"]
    raw_yaw = np.array([qnp.rot_to_ypr(qnp.quat_to_rot(pg.vio_q[k]))[0] for k in range(n)])
    out = dict(
        initialized=bool(est.initialized), emitted=len(ts), keyframes=n, loops=pg.loop_count,
        refined=sum(1 for e in pg.edges if e["loop"] and "t_pnp" in e),
        accepted_inliers=[r["inliers"] for r in pg.stats if r["outcome"] == "accepted"],
        kf_ate_raw_m=float(ate_rmse(pg.t_kf[:n], pg.vio_p[:n], gt_t, gt_p, align="yaw")),
        kf_ate_corrected_m=float(ate_rmse(pg.t_kf[:n], pg.opt_p[:n], gt_t, gt_p, align="yaw")),
        gap_raw_max_m=float(chip_smoke.loop_gaps(pg, pg.vio_p, raw_yaw).max(initial=0)),
        gap_corrected_max_m=float(chip_smoke.loop_gaps(pg, pg.opt_p, pg.opt_yaw).max(initial=0)),
        ate_m=float(ate_rmse(ts, ps, gt_t, gt_p, align="yaw")), wall_s=wall)
    where = args.device if args.package == "port" else "cpu"
    print(f"{args.package} ({where}) loop: " + ", ".join(f"{k} {v}" for k, v in out.items()),
          flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--jax-tracker", choices=("fast", "per-feature", "pallas"), default="fast")
    ap.add_argument("--port-tracker", choices=("fast", "pallas"), default="fast")
    ap.add_argument("--seed", type=int, default=None, help="the point frontend's RANSAC seed")
    ap.add_argument("modes", nargs="*", choices=("points", "binary", "float", "loop"),
                    default=["points", "binary"])
    args = ap.parse_args()
    run_euroc, ate_rmse = runner(args.package, args.device, args.dtype, args.jax_tracker, args.seed,
                                 args.port_tracker, x64="loop" in args.modes)
    results = {}
    if "loop" in args.modes:
        results["loop"] = loop_run(run_euroc, ate_rmse, args)
    modes = [m for m in args.modes if m != "loop"]
    if not modes:
        print(json.dumps(results))
        return

    path, render_s = chip_smoke.render_dataset()
    print(f"dataset {path} (rendered in {render_s:.1f} s)", flush=True)
    meta = np.load(os.path.join(path, "meta.npz"))
    base = chip_smoke.smoke_config(meta)
    for mode in modes:
        cfg = dataclasses.replace(
            base, solver=dataclasses.replace(base.solver, dtype=args.dtype),
            tracker=dataclasses.replace(base.tracker, line_desc="float" if mode == "float" else "binary"))
        t0 = time.perf_counter()
        ts, ps, _, est, _ = run_euroc(path, cfg, use_lines=mode != "points", loop_closure=False)
        wall = time.perf_counter() - t0
        solved = [m for m in est.metrics if "cost" in m]
        med_lines = float(np.median([m.get("n_lines", 0) for m in solved])) if solved else 0.0
        ate = float(ate_rmse(ts, ps, meta["gt_t"], meta["gt_p"], align="yaw"))
        results[mode] = dict(initialized=bool(est.initialized), emitted=len(ts),
                             solved=len(solved), median_lines=med_lines, ate_m=ate,
                             wall_s=wall)
        where = (f"{args.device}, tracker {args.port_tracker}"
                 if args.package == "port"
                 else f"cpu, tracker {args.jax_tracker}")
        where += "" if args.seed is None else f", seed {args.seed}"
        print(f"{args.package} ({where}) {args.dtype} "
              f"{mode}: initialized {est.initialized}, {len(ts)} emitted, {len(solved)} solved, "
              f"median lines solved {med_lines:.0f}, ATE(yaw) {ate:.4f} m, {wall:.1f} s",
              flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
