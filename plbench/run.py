"""The benchmark of plslam_torch: one run of one cell.

    python3 plbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Renders (or reuses) the cell's synthetic EuRoC recording from the seed,
replays it through `plslam_torch.runner.run_euroc` as a user calls it, and
measures a window that opens once the estimator has run the mix's warm-up
solves and closes after `--seconds`. With `--trace 0` the last line of
standard output holds the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics read from a profiled part of the window. Both compare
what the window produced with the plain reference (`checks.py`) and print
each number beside its limit, on standard error last and under "checks"
last in the result line. Without a CUDA card, or with fewer cards than the
cell asks for, it prints no result and exits 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BANNED = ("jax", "jaxlib", "flax", "plslam")  # top-level module names
CACHE = os.path.join(ROOT, ".plbench_cache")


class Failure(Exception):
    """A run that prints no result: (message, exit code)."""


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the control of the comparison (the port with TF32 matmuls switched on)
    # and a run on the CPU, for the benchmark's own tests
    p.add_argument("--control", choices=("tf32",), default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--scene-seconds", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def ate_yaw(ts, ps, gt_t, gt_p) -> float:
    """RMSE of positions after the best yaw rotation and translation
    (4-DoF) onto the ground truth at the same frame times."""
    import numpy as np

    idx = np.searchsorted(gt_t, ts - 1e-6)
    idx = np.clip(idx, 0, len(gt_t) - 1)
    g = gt_p[idx]
    e0, g0 = ps.mean(0), g.mean(0)
    a, b = ps - e0, g - g0
    th = math.atan2(np.sum(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]),
                    np.sum(a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]))
    R = np.array([[math.cos(th), -math.sin(th), 0], [math.sin(th), math.cos(th), 0], [0, 0, 1]])
    d = a @ R.T - b
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


class Run:
    """What the metric readers read."""

    def __init__(self, probes, summary, setup_s, window_s, lk_bound_s):
        self.probes, self.summary = probes, summary
        self.setup_s, self.window_s, self.lk_bound_s = setup_s, window_s, lk_bound_s

    def device_ms(self, span: str, per: str):
        if self.summary is None:
            return None
        n = self.probes.traced[per]
        s = self.summary["by_span"].get(span)
        return 1e3 * s / n if n and s else None


def reader(name: str):
    """The reader module of a metric: `plbench/metrics/<name>.py` (a name
    may hold a dot, so it is loaded by its path)."""
    path = os.path.join(ROOT, "plbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("plbench.metrics._" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lk_bound_mean(samples):
    from plbench import bounds
    from plbench.reference import lk

    vals = []
    for s in samples:
        p = lk.pyramid(s["prev0"].detach().cpu().double(), s["levels"])
        c = lk.pyramid(s["cur0"].detach().cpu().double(), s["levels"])
        vals.append(bounds.lk_bound_s(p, c, s["pts"].detach().cpu().double(), s["valid"].cpu()))
    return sum(vals) / len(vals) if vals else None


def execute(a) -> tuple[dict, dict]:
    from plbench.cell import HERE, Cell, load_json, port_config

    cell = Cell(a.workload)
    import torch

    if a.device == "cuda":
        if not torch.cuda.is_available():
            raise Failure("no CUDA device", 3)
        if torch.cuda.device_count() < cell.chips:
            raise Failure(f"the cell needs {cell.chips} cards, {torch.cuda.device_count()} found", 3)
    # build and kernel caches at fixed paths inside the checkout (the port's
    # own nvcc builds go to plslam_torch/_build/)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    torch.set_num_threads(4)
    dev = torch.device(a.device)

    import plslam_torch.utils.device  # noqa: F401  (the port's matmul policy)
    from plbench import checks, scene
    from plbench import trace as trace_mod
    from plbench.probes import Probes, WindowClosed
    from plslam_torch import runner

    if a.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    recipe = cell.recipe()
    if a.scene_seconds is not None:
        recipe["scene"] = dict(recipe["scene"], duration_s=a.scene_seconds)
    path, cached = scene.recording(recipe, a.seed, os.path.join(CACHE, "scenes"), dev)
    cfg = port_config(cell.config)
    stride = max(1, round(20 / cfg.tracker.freq))
    replay = cell.traffic["replay"]
    loop = bool(cell.config["loop"]["loop_closure"])
    prof = {}

    def on_trace_start():
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof["p"] = profile(activities=acts)
        prof["p"].start()
        prof["t0"] = time.perf_counter()
        probes.trace_on = True

    def on_trace_end():
        if "p" in prof and "t1" not in prof:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            prof["t1"] = time.perf_counter()
            probes.trace_on = False
            prof["p"].stop()

    probes = Probes(cell.traffic, a.seconds, a.seed, stride, bool(a.trace), on_trace_start)
    probes.install(loop)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    closed = False
    try:
        runner.run_euroc(path, cfg, use_lines=bool(cell.config["use_lines"]), loop_closure=loop,
                         pipeline=bool(replay["pipeline"]), burst=int(replay["burst"]),
                         device=dev)
    except WindowClosed:
        closed = True
        on_trace_end()
    finally:
        probes.uninstall()
    if not closed:
        raise Failure("the recording ran out before the window closed "
                      f"(window opened: {probes.t_open is not None})", 4)
    on_trace_end()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    setup_s = probes.t_open - T_START
    window_s = probes.t_close - probes.t_open
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    summary = None
    if "p" in prof:
        summary = trace_mod.summarize(prof["p"], prof["t1"] - prof["t0"])
        del prof["p"]

    # the comparison with the reference, after the window and the peak
    t_check = time.perf_counter()
    numbers, compared = checks.compare(probes.samples)
    limits = load_json(HERE, "limits", cell.entry["config"] + ".json")
    unjudged = {k: v for k, v in numbers.items() if k not in limits["limits"]}
    # the pose graph's numbers, wherever the window drove the pose graph
    required = tuple(limits["required"]) + tuple(
        n for n, kind in (("pgo_gap_m", "pgo"), ("search_mismatch", "search")) if compared[kind])
    correct, judged = checks.judge(numbers, limits["limits"], required)
    check_s = time.perf_counter() - t_check

    run = Run(probes, summary, setup_s, window_s,
              lk_bound_mean(probes.samples["lk"][:4]) if a.trace else None)
    wanted = cell.per_layer if a.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted, failed, camera, lat = probes.frames()
    import numpy as np

    truth = np.load(os.path.join(path, "truth.npz"))
    ts = np.array(sorted(probes.poses))
    ate = (ate_yaw(ts, np.stack([probes.poses[t] for t in ts]), truth["frame_t"], truth["gt_p"])
           if len(ts) >= 10 else None)
    info = {"info": "plbench", "workload": a.workload, "seed": a.seed, "ate_m": ate,
            "poses": len(ts), "attempted": attempted, "failed": failed,
            "camera_frames": camera, "latencies": len(lat), "window_s": window_s,
            "setup_s": setup_s, "scene_cached": cached, "compared": compared,
            "check_s": check_s, "not_compared": unjudged, "control": a.control, "counts": probes.counts,
            "traced": probes.traced}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    result["checks"] = judged
    return result, info


def main(argv=None) -> int:
    a = parse(argv)
    try:
        if not os.path.isdir(os.path.join(ROOT, "plslam_torch")):
            raise Failure(f"no plslam_torch package beside the benchmark at {ROOT}", 2)
        result, info = execute(a)
        found = banned_modules()
        if found:
            raise Failure(f"modules that the benchmark must not load are loaded: {found}", 5)
    except Failure as e:
        print(f"plbench: {e.args[0]}", file=sys.stderr)
        return e.args[1]
    print(json.dumps(info), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
