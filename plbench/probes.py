"""Wrappers around the port's layers, installed by the harness before a run.

They keep the measured window (it opens once the estimator has run the
mix's warm-up solves and closes at `--seconds`, raised as `WindowClosed`
from the frame loader), time each frame from its turn in the runner to its
pose on the host, count every published frame's outcome, sum host time of
the spans that the per-layer metrics read, mark those spans for the
profiler, and keep a sample, drawn from the seed, of the kernels' and the
solves' inputs and outputs for the comparison with the reference. Nothing
here changes what the port computes.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

SPANS = ("points", "lines", "solve", "keyframe", "pgo")


class WindowClosed(Exception):
    """Raised by the frame loader once the measured window has closed."""


def _clone(x):
    """A detached copy of tensors inside tuples, lists, dicts and NamedTuples
    (queued on the tensors' stream: nothing waits)."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_clone(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


class RecordingList(list):
    """The estimator's metrics list: each published frame's outcome is
    appended once, when the host knows it; `hook` sees every append."""

    def __init__(self, items, hook):
        super().__init__(items)
        self._hook = hook

    def append(self, m):
        super().append(m)
        self._hook(m)


class Probes:
    def __init__(self, traffic: dict, seconds: float, seed: int, stride: int, trace: bool,
                 on_trace_start=None):
        self.warm_solves = int(traffic["window"]["warm_solves"])
        self.trace_s = float(traffic["window"].get("trace_s", 10.0))
        self.want = dict(traffic["check"])
        self.seconds = float(seconds)
        self.stride = stride
        self.trace = trace
        self.on_trace_start = on_trace_start
        self.trace_on = False  # the profiler runs (the window's last `trace_s` seconds)
        self.rng = np.random.default_rng(seed)
        self.t_open = self.t_close = self.t_trace = None
        self.closed = False
        self.solved = 0
        self.turn = {}  # frame time → host time of its turn in the runner
        self.pose_at = {}  # frame time → host time its pose reached the host
        self.poses = {}  # frame time → emitted position
        self.outcomes = []  # (host time, frame time, posed) of each published frame
        self.host_s = {k: 0.0 for k in (*SPANS, "decode")}
        # counts of the window outside the traced part, and inside it
        self.counts = {"camera": 0, "published": 0, "decode": 0}
        self.traced = {"camera": 0, "published": 0}
        self.kf_ms, self.pgo_ms = [], []  # PoseGraph.times entries of the window
        # "hamming": the line matcher's calls; "search": the keyframe search's
        self.samples = {"lk": [], "hamming": [], "search": [], "solve": [], "pgo": []}
        self.hamming_shapes = []  # (n1, n2) of each launch while traced
        self._depth = {k: 0 for k in SPANS}
        self._last_pose_t = None
        self._undo = []

    # ------------------------------------------------------------ window
    def in_window(self, now=None) -> bool:
        now = time.perf_counter() if now is None else now
        return self.t_open is not None and not self.closed and now < self.t_close

    def _open(self, now):
        self.t_open, self.t_close = now, now + self.seconds
        if self.trace:
            self.t_trace = self.t_close - min(self.trace_s, self.seconds)

    def host_window(self, t0) -> bool:
        """Inside the window and outside its traced part: where host spans
        are summed, so that the profiler's cost stays out of them."""
        return self.in_window(t0) and not self.tracing()

    def tracing(self) -> bool:
        return self.trace_on

    def _outcome(self, m):
        now = time.perf_counter()
        posed = "cost" in m and not m.get("failure")
        if self.in_window(now):
            self.outcomes.append((now, float(m["t"]), posed))
        if "cost" in m:
            self.solved += 1
            if self.t_open is None and self.solved >= self.warm_solves:
                self._open(now)

    def _take(self, kind) -> bool:
        """A sample of this call for the comparison, drawn from the seed: the
        window's first call, then each with the mix's probability, up to its
        most."""
        n = len(self.samples[kind])
        if not self.in_window() or n >= self.want[kind + "_max"]:
            return False
        return n == 0 or bool(self.rng.random() < self.want[kind + "_p"])

    # ------------------------------------------------------------ spans
    @contextlib.contextmanager
    def span(self, name):
        outer = self._depth[name] == 0
        self._depth[name] += 1
        t0 = time.perf_counter()
        ctx = (torch.profiler.record_function("plbench." + name) if outer and self.tracing()
               else contextlib.nullcontext())
        try:
            with ctx:
                yield
        finally:
            self._depth[name] -= 1
            if outer and self.host_window(t0):
                self.host_s[name] += time.perf_counter() - t0

    # ------------------------------------------------------------ install
    def _patch(self, owner, attr, new):
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def uninstall(self):
        for owner, attr, old in reversed(self._undo):
            setattr(owner, attr, old)
        self._undo.clear()

    def install(self, loop_closure: bool):
        from plslam_torch import runner
        from plslam_torch.io.euroc import EurocSequence
        from plslam_torch.models import estimator as est_mod
        from plslam_torch.models import frontend_lines as fl_mod
        from plslam_torch.models import frontend_points as fp_mod
        from plslam_torch.models import pose_graph as pg_mod
        from plslam_torch.ops.kernels import hamming as ham_mod

        P = self

        # the runner's frame loader: decode + CLAHE, on the loader's thread
        image0, clahe0 = EurocSequence.image, runner._clahe

        def image(seq, k):
            t0 = time.perf_counter()
            if P.t_open is not None and t0 >= P.t_close:
                P.closed = True
                raise WindowClosed()
            out = image0(seq, k)
            if P.host_window(t0):
                P.host_s["decode"] += time.perf_counter() - t0
                P.counts["decode"] += 1
            return out

        def clahe(img, *a, **kw):
            t0 = time.perf_counter()
            out = clahe0(img, *a, **kw)
            if P.host_window(t0):
                P.host_s["decode"] += time.perf_counter() - t0
            return out

        self._patch(EurocSequence, "image", image)
        self._patch(runner, "_clahe", clahe)

        # point frontend: a frame's turn, its span, the LK launches
        fp_process0 = fp_mod.FrontendPoints.process

        def fp_process(fp, img, t, *a, **kw):
            now = time.perf_counter()
            P.turn[float(t)] = now
            if (P.trace and not P.trace_on and P.t_trace is not None and now >= P.t_trace
                    and P.in_window(now) and P.on_trace_start is not None):
                P.on_trace_start()
            if P.tracing():
                P.traced["camera"] += 1
            elif P.in_window(now):
                P.counts["camera"] += 1
            with P.span("points"):
                return fp_process0(fp, img, t, *a, **kw)

        self._patch(fp_mod.FrontendPoints, "process", fp_process)
        lk0 = fp_mod.lk_track

        def lk_track(pyr_prev, pyr_cur, pts, valid, *a, **kw):
            out = lk0(pyr_prev, pyr_cur, pts, valid, *a, **kw)
            if P._take("lk"):
                P.samples["lk"].append(dict(
                    prev0=pyr_prev[0].detach().clone(), cur0=pyr_cur[0].detach().clone(),
                    levels=len(pyr_prev), pts=pts.detach().clone(),
                    valid=valid.detach().clone(), out=_clone(out[:2])))
            return out

        self._patch(fp_mod, "lk_track", lk_track)

        # line frontend and the Hamming kernel (line matches and the
        # keyframe search)
        fl_process0 = fl_mod.FrontendLines.process

        def fl_process(fl, *a, **kw):
            with P.span("lines"):
                return fl_process0(fl, *a, **kw)

        self._patch(fl_mod.FrontendLines, "process", fl_process)

        def hamming_of(fn, kind):
            def hamming_matrix(d1, d2):
                out = fn(d1, d2)
                if P.tracing():
                    P.hamming_shapes.append((int(d1.shape[0]), int(d2.shape[0])))
                if P._take(kind):
                    P.samples[kind].append(dict(d1=d1.detach().clone(), d2=d2.detach().clone(),
                                                out=out.detach().clone()))
                return out
            return hamming_matrix

        self._patch(fl_mod, "hamming_matrix", hamming_of(fl_mod.hamming_matrix, "hamming"))
        self._patch(ham_mod, "hamming_matrix", hamming_of(ham_mod.hamming_matrix, "search"))

        # the estimator: outcomes, poses, the solve's span and its samples
        clear0 = est_mod.Estimator.clear_state

        def clear_state(est):
            clear0(est)
            if not isinstance(est.metrics, RecordingList):
                est.metrics = RecordingList(est.metrics, P._outcome)

        self._patch(est_mod.Estimator, "clear_state", clear_state)
        for name in ("process_frame", "finalize"):
            def spanned(est, *a, _fn=getattr(est_mod.Estimator, name), _pub=name == "process_frame",
                        **kw):
                if _pub:
                    if P.tracing():
                        P.traced["published"] += 1
                    elif P.in_window():
                        P.counts["published"] += 1
                with P.span("solve"):
                    return _fn(est, *a, **kw)
            self._patch(est_mod.Estimator, name, spanned)
        latest0 = est_mod.Estimator.latest_pose

        def latest_pose(est):
            out = latest0(est)
            t = float(out[0])
            P.pose_at[t] = time.perf_counter()
            P.poses[t] = np.asarray(out[1], np.float64).copy()
            P._last_pose_t = t
            return out

        self._patch(est_mod.Estimator, "latest_pose", latest_pose)
        tick0 = est_mod.backend_tick

        def backend_tick(st, f, solvable, tri_need, fb4, lneed, ln_active2, lay, cfg, *a, **kw):
            take = P._take("solve")
            if take:
                inputs = _clone((st, f, solvable, tri_need, fb4, lneed, ln_active2))
            out = tick0(st, f, solvable, tri_need, fb4, lneed, ln_active2, lay, cfg, *a, **kw)
            if take:
                st_out, stats, prior, aux = out
                P.samples["solve"].append(dict(
                    inputs=inputs, lay=lay, cfg=cfg, kw=dict(kw), st_out=_clone(st_out),
                    cost=stats.cost_robust.detach().clone(), prior=_clone(prior)))
            return out

        self._patch(est_mod, "backend_tick", backend_tick)

        if loop_closure:
            add0, opt0 = pg_mod.PoseGraph.add_keyframe, pg_mod.PoseGraph.optimize

            def add_keyframe(pg, *a, **kw):
                t0 = time.perf_counter()
                n = len(pg.times["add_keyframe"])
                with P.span("keyframe"):
                    out = add0(pg, *a, **kw)
                if P.in_window(t0) and len(pg.times["add_keyframe"]) > n:
                    P.kf_ms.append(pg.times["add_keyframe"][-1])
                return out

            def optimize(pg, *a, **kw):
                t0 = time.perf_counter()
                n = len(pg.times["optimize"])
                with P.span("pgo"):
                    out = opt0(pg, *a, **kw)
                if P.in_window(t0) and len(pg.times["optimize"]) > n:
                    P.pgo_ms.append(pg.times["optimize"][-1][2])
                return out

            correct0 = pg_mod.PoseGraph.correct

            def correct(pg, p, q):
                out = correct0(pg, p, q)
                if P._last_pose_t is not None:
                    P.pose_at[P._last_pose_t] = time.perf_counter()
                    P.poses[P._last_pose_t] = np.asarray(out[0], np.float64).copy()
                return out

            self._patch(pg_mod.PoseGraph, "add_keyframe", add_keyframe)
            self._patch(pg_mod.PoseGraph, "optimize", optimize)
            self._patch(pg_mod.PoseGraph, "correct", correct)
            for fname in ("optimize_4dof", "optimize_4dof_pcg"):
                def solve(*args, _fn=getattr(pg_mod, fname), **kw):
                    out = _fn(*args, **kw)
                    if P._take("pgo"):
                        P.samples["pgo"].append(dict(args=_clone(args), kw=dict(kw),
                                                     xyz=out[0].detach().clone(),
                                                     yaw=out[1].detach().clone()))
                    return out
                self._patch(pg_mod, fname, solve)

    # ------------------------------------------------------------ results
    def frames(self, untraced: bool = False):
        """(attempted, failed, camera frames completed, latencies in ms of
        the posed frames) over the window, or over its part before the
        profiler started."""
        outcomes = self.outcomes
        if untraced and self.t_trace is not None:
            outcomes = [o for o in outcomes if o[0] < self.t_trace]
        attempted = len(outcomes)
        failed = sum(1 for _, _, posed in outcomes if not posed)
        lat = []
        for _, t, posed in outcomes:
            if posed and t in self.turn and t in self.pose_at:
                lat.append(1e3 * (self.pose_at[t] - self.turn[t]))
        return attempted, failed, attempted * self.stride, lat
