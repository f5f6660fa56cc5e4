"""The port's tracer (`plslam_torch/utils/timers.py`): spans and counters on
the run path.

Off (the default) a span is one shared object that records nothing. On, a
streaming `run_euroc` (pipeline on, loop closure on, points and binary
lines) over a 2-s 320×240 render gives the same trajectory bit for bit as
with the tracer off, and records the span tree its docstrings name: the
runner's stages on the main thread and the decode on the loader thread,
the estimator's stages under `estimator.process_frame` and, one published
frame later, under `estimator.finalize` inside `runner.emit`, each with
the frame's time. `host_wait` equals the reads of the card's results that
the run made, counted apart by wrapping them. The pose graph's PGO and loop
search, the burst runner's chunks, `Timers.timed`, the profiler's ranges and
`scripts/trace_split.py`'s split of a made-up profile are checked on small
inputs. No JAX here: the card test (`test_graph_capture_once_per_key`) runs
on the machine with the card, with

    python -m pytest --noconftest -m gpu tests/test_torch_trace.py -q
"""
import os
import sys
import threading
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import plslam_torch
from plslam_torch.config import (CameraConfig, ExtrinsicConfig, LoopConfig, PLSlamConfig,
                                 SolverConfig, TrackerConfig)
from plslam_torch.io import render, synthetic
from plslam_torch.ops.cameras import PinholeRadTan
from plslam_torch.runner import run_euroc
from plslam_torch.utils import timers
from plslam_torch.utils.device import HostCopy
from plslam_torch.utils.geometry import quat_to_rot

H, W, F = 240, 320, 230.0
PKG = os.path.dirname(plslam_torch.__file__)

# the span each span opens inside (None: at the top of its thread)
PARENT = {
    "runner.decode": None, "runner.load_wait": None, "points.process": None,
    "lines.process": None, "runner.frontend_wait": None, "runner.imu": None,
    "runner.emit": None, "estimator.process_frame": None,
    "estimator.preintegrate": "estimator.process_frame",
    "estimator.tables": "estimator.process_frame",
    "estimator.initialize": "estimator.process_frame",
    "estimator.pack": "estimator.process_frame", "estimator.launch": "estimator.process_frame",
    "backend.triangulate": "estimator.launch", "backend.lm": "estimator.launch",
    "backend.marginalize": "estimator.launch", "backend.gating": "estimator.launch",
    "estimator.finalize": "runner.emit", "estimator.wait": "estimator.finalize",
    "estimator.finish": "estimator.finalize", "estimator.slide": "estimator.finalize",
    "pose_graph.add_keyframe": "runner.emit", "pose_graph.features": "pose_graph.add_keyframe",
    "pose_graph.query": "pose_graph.add_keyframe",
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def tracer():
    """The tracer on and empty; off and empty again afterwards."""
    timers.reset()
    timers.enable()
    yield
    timers.disable()
    timers.reset()


def _config(seq):
    """The slice tests' 320×240 pipeline configuration with binary lines, a
    7-state window, 48 point slots and two LM iterations (a short CPU run)."""
    R_bc = quat_to_rot(torch.as_tensor(np.asarray(seq.q_bc), dtype=torch.float64)).numpy()
    return PLSlamConfig(
        camera=CameraConfig(image_width=W, image_height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                            k1=0, k2=0, p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=80, min_dist=20, equalize=True, min_score=2e-3,
                              line_desc="binary"),
        solver=SolverConfig(max_features=48, max_line_feats=8, focal_length=F, window_size=6,
                            max_num_iterations=2),
        extrinsic=ExtrinsicConfig(0, tuple(R_bc.reshape(-1)), tuple(np.asarray(seq.p_bc))),
        loop=LoopConfig(loop_closure=True))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(untraced run, traced run, its records, the reads tallied during it,
    the main thread) over one render."""
    torch.set_num_threads(1)  # a module fixture runs before the function-scoped one
    path = tmp_path_factory.mktemp("trace_render")
    seq = synthetic.make_sequence(duration=2.0, n_points=300, n_lines=20, seed=11,
                                  params=synthetic.TrajectoryParams(
                                      omega=0.4, z_omega=0.7, wiggle_amp=0.15, excite_amp=0.1))
    render.write_euroc_dataset(seq, str(path), PinholeRadTan.create(F, F, W / 2, H / 2), H, W,
                               blob_sigma=2.0, style="textured")
    cfg = _config(seq)
    off = run_euroc(str(path), cfg, device="cpu")

    # every read of a result on the host, wrapped apart from the tracer:
    # the handles' waits and the port's own `.cpu()` and `float(tensor)`
    tally = Counter()
    get, joint = HostCopy.get, HostCopy.get_joint
    cpu, to_float = torch.Tensor.cpu, torch.Tensor.__float__

    def from_port():
        return sys._getframe(2).f_code.co_filename.startswith(PKG)

    def counted_get(self):
        tally["get"] += 1
        return get(self)

    def counted_joint(*handles):
        tally["get_joint"] += 1
        return joint(*handles)

    def counted_cpu(self, *a, **kw):
        if from_port():
            tally["cpu"] += 1
        return cpu(self, *a, **kw)

    def counted_float(self):
        if from_port():
            tally["float"] += 1
        return to_float(self)

    timers.reset()
    timers.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(HostCopy, "get", counted_get)
            mp.setattr(HostCopy, "get_joint", staticmethod(counted_joint))
            mp.setattr(torch.Tensor, "cpu", counted_cpu)
            mp.setattr(torch.Tensor, "__float__", counted_float)
            on = run_euroc(str(path), cfg, device="cpu")
    finally:
        timers.disable()
    rec = timers.records()
    timers.reset()
    return off, on, rec, tally, threading.get_ident()


def test_off_span_is_the_shared_noop():
    timers.disable()
    timers.reset()
    a, b = timers.span("estimator.pack"), timers.span("backend.lm", frame=1.0)
    assert a is b is timers._NO_SPAN
    with a:
        timers.count("host_wait")
    assert timers.records() == {"spans": [], "counts": []}


def test_tracing_keeps_the_trajectory(runs):
    (ts0, ps0, qs0, est0, pg0), (ts1, ps1, qs1, est1, pg1), _, _, _ = runs
    assert len(ts0) >= 10
    for a, b in ((ts0, ts1), (ps0, ps1), (qs0, qs1)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert est0.metrics == est1.metrics
    assert pg0.n == pg1.n and np.array_equal(pg0.opt_p, pg1.opt_p)


def test_span_tree(runs):
    _, (_, _, _, est, _), rec, _, main = runs
    spans = rec["spans"]
    by_id = {s.id: s for s in spans}
    names = Counter(s.name for s in spans)
    assert set(names) == set(PARENT), names
    for s in spans:
        parent = by_id[s.parent] if s.parent is not None else None
        assert (parent.name if parent else None) == PARENT[s.name], (s, parent)
        assert s.start_ns <= s.end_ns
        if parent is not None:
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
            assert parent.thread == s.thread and parent.frame == s.frame
        # the loader decodes on its own thread; everything else runs on the caller's
        assert (s.thread != main) == (s.name == "runner.decode"), s
    published = [m["t"] for m in est.metrics]
    cam_t = sorted({s.frame for s in spans if s.name == "points.process"})
    assert len(cam_t) == names["points.process"] == names["runner.decode"]
    assert sorted(s.frame for s in spans if s.name == "runner.decode") == cam_t
    for name in ("estimator.process_frame", "runner.frontend_wait", "runner.imu",
                 "lines.process", "runner.emit"):
        assert [s.frame for s in spans if s.name == name] == published, name
    # a deferred solve completes one published frame later, under its own frame
    solved = [m["t"] for m in est.metrics if "cost" in m]
    emits = {s.id: s for s in spans if s.name == "runner.emit"}
    fin = [s for s in spans if s.name == "estimator.finalize"]
    assert [s.frame for s in fin] == solved
    for s in fin:
        assert emits[s.parent].frame == s.frame
        launch = [x for x in spans if x.name == "estimator.launch" and x.frame == s.frame]
        assert len(launch) == 1 and launch[0].end_ns < s.start_ns
    # keyframes enter the pose graph inside their own frame's output
    kf = [m["t"] for m in est.metrics if m.get("keyframe") and "cost" in m]
    assert [s.frame for s in spans if s.name == "pose_graph.add_keyframe"] == kf
    assert names["estimator.initialize"] >= 1


def test_one_launch_per_solved_frame(runs):
    _, (_, _, _, est, _), rec, _, _ = runs
    solved = [m["t"] for m in est.metrics if "cost" in m]
    launches = [s.frame for s in rec["spans"] if s.name == "estimator.launch"]
    assert launches == solved and len(set(launches)) == len(launches) >= 8
    counts = [c for c in rec["counts"] if c.name == "estimator.solve"]
    assert [c.frame for c in counts] == solved and all(c.n == 1 for c in counts)
    assert not [c for c in rec["counts"] if c.name == "estimator.failure"]
    assert not [m for m in est.metrics if m.get("failure")]


def test_host_wait_counts_every_read(runs):
    _, (_, _, _, est, _), rec, tally, _ = runs
    waits = [c for c in rec["counts"] if c.name == "host_wait"]
    assert sum(c.n for c in waits) == sum(tally.values()) > 0, tally
    # one handle wait a published frame (both frontends) and one a solve
    published = len(est.metrics)
    solved = sum(1 for m in est.metrics if "cost" in m)
    assert (tally["get_joint"], tally["get"]) == (published, solved)
    spans = {s.id: s for s in rec["spans"]}

    def inside(name):
        return sum(c.n for c in waits if any(
            s.name == name and s.thread == c.thread and s.start_ns <= c.t_ns <= s.end_ns
            for s in spans.values()))

    assert inside("runner.frontend_wait") == published
    assert inside("estimator.wait") == solved


def test_pose_graph_spans_and_waits(tracer):
    """A 4-DoF PGO over a small graph with one loop edge, and one loop
    search between a keyframe and an old one that shares its descriptors."""
    from plslam_torch.models import keyframe_db as kdb
    from plslam_torch.models.pose_graph import PoseGraph

    rng = np.random.default_rng(4)
    pg = PoseGraph(LoopConfig(), device="cpu")
    for k in range(6):
        pg.add_keyframe(0.1 * k, np.array([0.3 * k, 0.0, 0.0]), np.array([1.0, 0, 0, 0]))
    pg.edges.append(dict(i=0, j=5, t=np.array([1.4, 0.05, 0.0]), yaw=0.01, w=2.0, loop=1))
    pg.optimize()
    # the loop search: the same descriptors on both keyframes, the old
    # keyframe's corners the projections of the current window's points
    cam = PinholeRadTan.create(F, F, W / 2, H / 2)
    n = 40
    pts3d = np.c_[rng.uniform(-1, 1, (n, 2)), rng.uniform(3, 6, n)]
    uv = F * pts3d[:, :2] / pts3d[:, 2:] + [W / 2, H / 2]
    words = rng.integers(0, 2 ** 32, (n, kdb.N_BRIEF_WORDS), dtype=np.uint64).astype(np.uint32)
    old = dict(desc=words, valid=np.ones(n, bool), uv=uv, cam=cam)
    cur = dict(win_desc=words, win_pts3d=pts3d, win_ids=np.arange(n), win_uv=uv, cam=cam)
    pg.db.entries = [old]
    pg._find_connection(0, 5, cur)
    assert pg.stats[-1]["inliers"] >= 8, pg.stats[-1]

    rec = timers.records()
    by_id = {s.id: s for s in rec["spans"]}
    tree = Counter((s.name, by_id[s.parent].name if s.parent is not None else None)
                   for s in rec["spans"])
    assert tree == Counter({
        ("pose_graph.add_keyframe", None): 6, ("pose_graph.optimize", None): 1,
        ("pose_graph.pgo_pack", "pose_graph.optimize"): 1,
        ("pose_graph.pgo_solve", "pose_graph.optimize"): 1,
        ("pose_graph.pgo_wait", "pose_graph.optimize"): 1,
        ("pose_graph.connect", None): 1, ("pose_graph.search", "pose_graph.connect"): 1,
        ("pose_graph.pnp", "pose_graph.connect"): 1}), tree
    waits = {}
    for c in rec["counts"]:
        holder = max((s for s in rec["spans"] if s.start_ns <= c.t_ns <= s.end_ns),
                     key=lambda s: s.start_ns)
        waits[(c.name, holder.name)] = waits.get((c.name, holder.name), 0) + c.n
    # PGO: positions and yaws; search: the distances and the lifted corners
    assert waits == {("host_wait", "pose_graph.pgo_wait"): 2,
                     ("host_wait", "pose_graph.search"): 2,
                     ("pose_graph.candidate", "pose_graph.connect"): 1}, waits


def test_burst_chunk_counts_its_dropped_frames(tracer, monkeypatch):
    """`runner._burst_tail` with stand-ins for the estimator, the frontends
    and the device steps: the second chunk's step 3 fails, so that chunk
    emits 3 published frames and drops 5; each chunk's readback is one
    `host_wait`."""
    from plslam_torch import runner
    from plslam_torch.models import burst as burst_mod

    B, stride, W_ = 8, 2, 4

    class Step:
        def __init__(self, est, fp, fl, stride):
            self.calls = 0

        def run_chunk(self, carry, imgs, dts_cam, acc, gyr, dts, n_imu, td):
            fail = torch.zeros(B, dtype=torch.bool)
            if carry == 1:
                fail[3:] = True  # a latched failure
            outs = {"fail": fail, "keyframe": torch.zeros(B, dtype=torch.bool),
                    "p": torch.zeros(B, 3), "q": torch.tensor([[1.0, 0, 0, 0]] * B),
                    "cost": torch.ones(B), "long_tracked": torch.full((B,), 20),
                    "n_pts": torch.full((B,), 20), "td": torch.zeros(B),
                    "eigh_failed": torch.zeros(B)}
            return carry + 1, outs

    class Packer:
        def __init__(self, *a):
            self.i, self.prev_t, self.prev_acc, self.prev_gyr = 0, None, None, None

        def interval(self, t, td):
            return np.zeros((3, 3)), np.zeros((3, 3)), np.zeros(2), 2

    monkeypatch.setattr(burst_mod, "make_carry", lambda est, fp, fl: 0)
    monkeypatch.setattr(burst_mod, "BurstStep", Step)
    monkeypatch.setattr(burst_mod, "ImuChunkPacker", Packer)
    monkeypatch.setattr(burst_mod, "sync_back", lambda *a, **kw: None)
    n_cam = 3 * B * stride
    seq = SimpleNamespace(cam_t=0.05 * np.arange(1, n_cam + 1), imu_t=None, imu_acc=None,
                          imu_gyr=None)
    cleared = []
    est = SimpleNamespace(cfg=SimpleNamespace(window_size=W_), timestamps=np.zeros(W_ + 1),
                          td=0.0, device=torch.device("cpu"), metrics=[],
                          clear_state=lambda: cleared.append(True))
    feeder = SimpleNamespace(i=0, prev_t=None, prev_acc=None, prev_gyr=None)
    log, ts = [], []
    k, n_pub, relo = runner._burst_tail(
        seq, PLSlamConfig(), est, None, None, feeder, 0, stride, B,
        lambda k: np.zeros((8, 8), np.float32), ts, [], [], 0, 100, False, None, None, log)
    chunks = [e for e in log if "fallback" not in e]
    assert [(e["frames"], e["dropped"]) for e in chunks] == [(B, 0), (3, B - 3)]
    assert log[-1]["fallback"] == "failure detection" and cleared == [True]
    assert n_pub == len(ts) == B + 3 and k == 2 * B * stride and relo is None
    assert sum(c.n for c in timers.records()["counts"] if c.name == "host_wait") == 2


def test_timers_timed_is_a_span(tracer):
    t = timers.Timers()
    with t.timed("io"):
        with timers.span("inner"):
            pass
    with t.timed("io"):
        pass
    assert t.summary()["io"]["n"] == 2
    spans = timers.records()["spans"]
    assert [s.name for s in spans] == ["io", "inner", "io"]
    assert spans[1].parent == spans[0].id and spans[2].parent is None


def test_profiler_shows_the_program_ranges(tracer, tmp_path):
    """Under a torch profiler each span is a `plslam.<name>` range, which
    `profiler_trace` writes into its Chrome trace."""
    with timers.profiler_trace(str(tmp_path / "trace")):
        with timers.span("backend.lm"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert '"plslam.backend.lm"' in trace
    with timers.span("runner.imu"):  # no profiler: no range, still a record
        pass
    assert [s.name for s in timers.records()["spans"]] == ["backend.lm", "runner.imu"]


@pytest.mark.gpu
def test_graph_capture_once_per_key(tracer):
    """`graph.capture` fires at the first call of each graph key and never on
    a replay; the estimator's solves capture each of its graphs once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from plslam_torch.runner import run_synthetic
    from plslam_torch.utils import cuda_graph

    dev = torch.device("cuda", 0)
    graphs = {}
    x = torch.ones(16, device=dev)
    for _ in range(3):
        for key, scale in (("a", 2.0), ("b", 3.0)):
            y = cuda_graph.run(graphs, (key,), lambda v, s=scale: v * s, x)
    torch.cuda.synchronize()
    assert float(y[0]) == 3.0
    counts = [c for c in timers.records()["counts"] if c.name == "graph.capture"]
    assert len(counts) == 2 == len(graphs)
    timers.reset()
    seq = synthetic.make_sequence(duration=4.0, n_points=120, n_lines=24, seed=3)
    cfg = PLSlamConfig(solver=SolverConfig(max_features=96, max_line_feats=24))
    _, _, _, est = run_synthetic(seq, cfg, oracle_init=True, device=dev)
    rec = timers.records()
    captures = [s for s in rec["spans"] if s.name == "graph.capture"]
    assert sum(c.n for c in rec["counts"] if c.name == "graph.capture") == len(captures)
    assert len(captures) == len(est._graphs) >= 2
    assert len([s for s in rec["spans"] if s.name == "backend.lm"]) > len(captures)


class _Event:
    """A profiler event as `kineto_results.events()` gives it."""

    def __init__(self, name, start, dur, cuda=False, cid=0, linked=0, tid=1, mark=False):
        self._v = (name, start, dur, cuda, cid, linked, tid, mark)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


def test_profile_split_by_program_span():
    """`scripts/trace_split.py` on a made-up profile: the benchmark's summary
    reads as it does without the program's ranges, each device operation
    goes to the innermost program span open at its launch, and the device's
    idle time to the spans the main thread was in."""
    import importlib.util

    from plbench import trace as trace_mod

    spec = importlib.util.spec_from_file_location(
        "trace_split", os.path.join(os.path.dirname(PKG), "scripts", "trace_split.py"))
    split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split)
    E = _Event
    host = [E("plbench.solve", 0, 100), E("plslam.estimator.process_frame", 5, 90),
            E("plslam.estimator.launch", 50, 40), E("plslam.backend.lm", 60, 20),
            E("plslam.runner.frontend_wait", 100, 50), E("plbench.points", 150, 10),
            E("cudaLaunchKernel", 10, 2, cid=8), E("cudaGraphLaunch", 65, 2, cid=7),
            E("cudaLaunchKernel", 152, 2, cid=9)]
    device = [E("gemm", 20, 10, cuda=True, cid=81, linked=8),
              E("replayed", 70, 50, cuda=True, cid=71, linked=7),
              E("copy", 200, 5, cuda=True, cid=91, linked=9)]
    marks = [E("plbench.solve", 20, 100, cuda=True, mark=True),
             E("plslam.backend.lm", 70, 50, cuda=True, mark=True)]

    def prof(events):
        return SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events)))

    plain = trace_mod.summarize(prof(host[:1] + host[5:] + device + marks[:1]), 1.0)
    out = split.program_summary(trace_mod.summarize, prof(host + device + marks), 1.0)
    for key, value in plain.items():
        assert out[key] == value, key
    assert plain["busy_s"] == pytest.approx(65e-9)
    assert out["by_program_span"] == pytest.approx(
        {"estimator.process_frame": 10e-9, "backend.lm": 50e-9, "other": 5e-9})
    assert out["idle_by_program_span"] == pytest.approx(
        {"host: estimator.process_frame": 20e-9, "host: estimator.launch": 10e-9,
         "host: backend.lm": 10e-9, "host: runner.frontend_wait": 30e-9,
         "host: points": 10e-9, "host: runner": 40e-9})
    assert out["idle_named_share"] == pytest.approx(70 / 120)
