"""The port's spans over one run of a benchmark cell: where the host's time
goes inside the runner, the frontends, the estimator and the pose graph,
which stage launched the device's work, and which stage the host was in
while the device idled.

    python3 scripts/trace_split.py --workload euroc_plvio.stream --seed 7 \
        --seconds 51 --trace 1 --tracer 1 [--out FILE]
    python3 scripts/trace_split.py --span-cost

Runs `plbench/run.py`'s run in this process, with the port's tracer
(`plslam_torch/utils/timers.py`) enabled from the start when `--tracer 1`,
and prints the benchmark's result line followed by a line of the split:

* `host_ms`: host ms a published frame (a camera frame for
  `runner.load_wait` and `points.process`) of each span, over the window
  outside its profiled part, where the benchmark sums its own host times;
  `host_waits`, the `host_wait` counter a published frame there, and
  `eigh_queued`, the `backend.eigh_queued` counter (the marginalization's
  eigendecompositions queued on the card without a host wait); the
  per-stage readings the spans give (`load_wait_ms`, `frontend_host_ms`,
  `frontend_wait_ms`, `estimator_work_ms` = tables + preintegrate + finish +
  slide, `estimator_pack_ms`, `estimator_launch_ms`, `estimator_wait_ms`,
  `pgo_wait_ms` a `PoseGraph.optimize` call); `init_s` and `capture_s`, the
  seconds in `estimator.initialize` and `graph.capture` before the window
  opened;
* with `--trace 1`, `device_ms`: device ms a published frame of the
  operations launched under each span (the innermost `plslam.` range open
  on the launching thread at the launch; `lm_device_ms`, `marg_device_ms`),
  and the device's idle time of the profiled part split over the spans the
  main thread was in (the innermost program span, else the benchmark's own
  span, else `runner`), with the share that fell under a program span; the
  device operations launched under no program span (`other_ops`); and
  `traced_host_ms`, the spans' host ms a published frame in the profiled
  part, which runs slower than the rest.

The device-side marks of the ranges (user annotations) are left out of the
device's busy time, so that the benchmark's own readings of the profiled
part are what they are without the tracer. `--span-cost` times a span and a
count with the tracer off and on (host µs, the fastest of 5 rounds of
200,000). Run from the repository root; it reads what `plbench/` reads.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from collections import defaultdict
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from plbench import run as run_mod  # noqa: E402  (its import starts the set-up clock)

WORK = ("estimator.tables", "estimator.preintegrate", "estimator.finish", "estimator.slide")


class Timeline:
    """The innermost program span (`plslam.`) and the innermost benchmark span
    (`plbench.`) open on one thread at any time, from that thread's nested
    ranges (start_ns, end_ns, name)."""

    def __init__(self, ranges):
        ranges = [r for r in ranges if r[0] < r[1]]
        cuts = sorted({t for s, e, _ in ranges for t in (s, e)})
        starts = defaultdict(list)
        ends = defaultdict(list)
        for i, (s, e, _) in enumerate(ranges):
            starts[s].append(i)
            ends[e].append(i)
        open_, self.t, self.seg = [], [], []
        for t in cuts:
            for i in ends[t]:
                open_.remove(i)
            open_.extend(sorted(starts[t], key=lambda i: -ranges[i][1]))
            prog = next((ranges[i][2][len("plslam."):] for i in reversed(open_)
                         if ranges[i][2].startswith("plslam.")), None)
            bench = next((ranges[i][2][len("plbench."):] for i in reversed(open_)
                          if ranges[i][2].startswith("plbench.")), None)
            self.t.append(t)
            self.seg.append((prog, bench))

    def at(self, t):
        i = bisect.bisect_right(self.t, t) - 1
        return self.seg[i] if i >= 0 else (None, None)

    def overlaps(self, s, e):
        """(ns, (program span, benchmark span)) pieces of [s, e)."""
        i = max(bisect.bisect_right(self.t, s) - 1, 0)
        out = []
        while i < len(self.t) and self.t[i] < e:
            lo = max(s, self.t[i])
            hi = min(e, self.t[i + 1]) if i + 1 < len(self.t) else e
            if hi > lo:
                out.append((hi - lo, self.seg[i] if self.t[i] <= lo else (None, None)))
            i += 1
        if self.t and s < self.t[0]:
            out.append((min(e, self.t[0]) - s, (None, None)))
        return out


def program_summary(summarize, prof, window_s):
    """The benchmark's summary of a profile without the device-side marks of
    any range, and the program's split of the device's work and idle time."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA

    def annotation(e):
        f = getattr(e, "is_user_annotation", None)
        return f() if f is not None else e.name().startswith(("plbench.", "plslam."))

    kept = [e for e in prof.profiler.kineto_results.events()
            if not (e.device_type() == cuda and annotation(e))]
    base = summarize(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: kept))), window_s)
    ranges, launches, dev = defaultdict(list), {}, []
    for e in kept:
        name = e.name()
        if e.device_type() == cuda:
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.linked_correlation_id() or e.correlation_id(), name))
        elif name.startswith(("plslam.", "plbench.")):
            ranges[e.start_thread_id()].append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                                name))
        elif name.startswith(("cuda", "cu")) and e.correlation_id():
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    lines = {tid: Timeline(v) for tid, v in ranges.items()}
    by_prog, other = defaultdict(float), defaultdict(float)
    for s, e, cid, name in dev:
        at = launches.get(cid)
        prog = lines[at[1]].at(at[0])[0] if at and at[1] in lines else None
        by_prog[prog or "other"] += 1e-9 * (e - s)
        if prog is None:
            other[("launched " if at else "no launch ") + name[:64]] += 1e-9 * (e - s)
    dev.sort()
    gaps, cur_e = [], None
    for s, e, _, _ in dev:
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    bench_count = {tid: sum(1 for r in v if r[2].startswith("plbench."))
                   for tid, v in ranges.items()}
    main = max(bench_count, key=bench_count.get) if bench_count else None
    idle, named, total = defaultdict(float), 0.0, 0.0
    for s, e in gaps:
        pieces = lines[main].overlaps(s, e) if main in lines else [(e - s, (None, None))]
        for ns, (prog, bench) in pieces:
            idle["host: " + (prog or bench or "runner")] += 1e-9 * ns
            total += 1e-9 * ns
            named += 1e-9 * ns if prog else 0.0
    base["by_program_span"] = dict(by_prog)
    base["other_ops"] = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    base["idle_by_program_span"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
    base["idle_named_share"] = named / total if total else None
    return base


def host_split(records, probes):
    """Host ms of each span and the stage readings over the window outside
    its profiled part; set-up seconds before the window."""
    t0 = probes.t_open
    t1 = probes.t_trace if probes.t_trace is not None else probes.t_close
    pub, cam = probes.counts["published"], probes.counts["camera"]
    inside = lambda ns: t0 <= 1e-9 * ns < t1  # noqa: E731
    ms, n = defaultdict(float), defaultdict(int)
    setup, traced = defaultdict(float), defaultdict(float)
    for s in records["spans"]:
        d = 1e-6 * (s.end_ns - s.start_ns)
        if inside(s.start_ns):
            ms[s.name] += d
            n[s.name] += 1
        elif 1e-9 * s.start_ns < t0:
            setup[s.name] += 1e-3 * d
        elif 1e-9 * s.start_ns < probes.t_close:
            traced[s.name] += d
    waits = sum(c.n for c in records["counts"] if c.name == "host_wait" and inside(c.t_ns))
    counters = defaultdict(int)
    for c in records["counts"]:
        if inside(c.t_ns):
            counters[c.name] += c.n
    per = {k: v / (cam if k in ("runner.load_wait", "points.process", "runner.decode") else pub)
           for k, v in ms.items()} if pub else {}
    out = {"published": pub, "camera": cam, "host_ms": per, "calls": dict(n),
           "counters": dict(counters), "setup_s": dict(setup)}
    if probes.t_trace is not None and probes.traced["published"]:
        # the same spans in the profiled part, a published frame there
        out["traced_host_ms"] = {k: v / probes.traced["published"] for k, v in traced.items()}
    if pub:
        out.update(
            load_wait_ms=ms["runner.load_wait"] / cam if cam else None,
            frontend_host_ms=(ms["points.process"] + ms["lines.process"]) / pub,
            frontend_wait_ms=ms["runner.frontend_wait"] / pub,
            estimator_work_ms=sum(ms[k] for k in WORK) / pub,
            estimator_pack_ms=ms["estimator.pack"] / pub,
            estimator_launch_ms=ms["estimator.launch"] / pub,
            estimator_wait_ms=ms["estimator.wait"] / pub,
            host_waits=waits / pub,
            eigh_queued=counters["backend.eigh_queued"] / pub)
    out["init_s"] = setup["estimator.initialize"]
    out["capture_s"] = setup["graph.capture"]
    if n["pose_graph.optimize"]:
        out["pgo_wait_ms"] = ms["pose_graph.pgo_wait"] / n["pose_graph.optimize"]
    return out


def span_cost():
    from plslam_torch.utils import timers

    def rounds(fn, reps=200_000):
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            fn(reps)
            best = min(best, 1e6 * (time.perf_counter() - t0) / reps)
            timers.reset()
        return best

    def spans(reps):
        for _ in range(reps):
            with timers.span("estimator.pack"):
                pass

    def counts(reps):
        for _ in range(reps):
            timers.count("host_wait")

    def bare(reps):
        for _ in range(reps):
            pass

    out = {}
    for state in ("off", "on"):
        (timers.enable if state == "on" else timers.disable)()
        out[state] = {"span_us": rounds(spans), "count_us": rounds(counts),
                      "loop_us": rounds(bare)}
    timers.disable()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", default=None)
    p.add_argument("--span-cost", action="store_true")
    a = p.parse_args(argv)
    if a.span_cost:
        print(json.dumps({"span_cost": span_cost()}), flush=True)
        return 0
    from plbench import trace as trace_mod
    from plslam_torch.utils import timers

    captured = {}
    init0, summarize0 = run_mod.Run.__init__, trace_mod.summarize

    def init(self, *args, **kw):
        init0(self, *args, **kw)
        captured["run"] = self

    run_mod.Run.__init__ = init
    trace_mod.summarize = lambda prof, w: program_summary(summarize0, prof, w)
    if a.tracer:
        timers.reset()
        timers.enable()
    args = run_mod.parse(["--workload", a.workload, "--seed", str(a.seed),
                          "--seconds", str(a.seconds), "--trace", str(a.trace)])
    try:
        result, info = run_mod.execute(args)
    except run_mod.Failure as e:
        print(f"trace_split: {e.args[0]}", file=sys.stderr)
        return e.args[1]
    timers.disable()
    run = captured["run"]
    split = {"workload": a.workload, "seed": a.seed, "trace": a.trace, "tracer": a.tracer}
    if a.tracer:
        split.update(host_split(timers.records(), run.probes))
    if run.summary is not None:
        n = run.probes.traced["published"]
        sm = run.summary
        split["traced_published"] = n
        split["device_ms"] = {k: 1e3 * v / n for k, v in sm["by_program_span"].items()} if n else {}
        split["lm_device_ms"] = split["device_ms"].get("backend.lm")
        split["marg_device_ms"] = split["device_ms"].get("backend.marginalize")
        split["idle_by_program_span"] = sm["idle_by_program_span"]
        split["idle_named_share"] = sm["idle_named_share"]
        split["other_ops"] = sm["other_ops"]
        split["busy_s"], split["window_s"] = sm["busy_s"], sm["window_s"]
    mets = {k: v["value"] for k, v in result["metrics"].items()}
    if "estimator_work_ms" in split and "solve_host_ms" in mets:
        four = sum(split[k] for k in ("estimator_work_ms", "estimator_pack_ms",
                                      "estimator_launch_ms", "estimator_wait_ms"))
        split["estimator_four_ms"] = four
        split["four_over_solve_host"] = four / mets["solve_host_ms"]
    if split.get("lm_device_ms") is not None and "solve_device_ms" in mets:
        split["solve_device_rest_ms"] = (mets["solve_device_ms"] - split["lm_device_ms"]
                                         - (split["marg_device_ms"] or 0.0))
    info_keys = ("workload", "seed", "attempted", "failed", "window_s", "setup_s", "counts",
                 "traced", "ate_m")
    print(json.dumps({k: info[k] for k in info_keys}), flush=True)
    print(json.dumps(result), flush=True)
    print(json.dumps({"split": split}), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as fh:
            fh.write(json.dumps({"result": result, "split": split}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
