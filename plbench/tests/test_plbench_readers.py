"""The window's accounting and the metric readers, on made-up events."""
import statistics

import pytest

from plbench import run as run_mod
from plbench.probes import Probes, RecordingList

TRAFFIC = {"window": {"warm_solves": 2, "trace_s": 1.0},
           "check": {"lk_p": 1, "lk_max": 1, "hamming_p": 1, "hamming_max": 1, "search_p": 1,
                     "search_max": 1, "solve_p": 1, "solve_max": 1, "pgo_p": 1, "pgo_max": 1}}


def _probes(seconds=1000.0):
    return Probes(TRAFFIC, seconds, seed=3, stride=2, trace=False)


def test_window_opens_after_the_warm_up_solves():
    p = _probes()
    m = RecordingList([], p._outcome)
    m.append({"t": 0.0})  # initializing: no solve
    m.append({"t": 0.1, "cost": 1.0})
    assert p.t_open is None
    m.append({"t": 0.2, "cost": 1.0})
    assert p.t_open is not None and p.outcomes == []  # the opening frame is not counted


def test_failed_counts_a_frame_without_a_pose():
    p = _probes()
    m = RecordingList([], p._outcome)
    for t in (0.0, 0.1):
        m.append({"t": t, "cost": 1.0})
    m.append({"t": 0.2, "cost": 1.0})
    m.append({"t": 0.3, "cost": 2.0, "failure": True})  # failure detection flagged it
    m.append({"t": 0.4})  # the estimator initializing again
    m.append({"t": 0.5, "cost": 1.0})
    attempted, failed, camera, _ = p.frames()
    assert (attempted, failed, camera) == (4, 2, 8)


def test_latency_is_turn_to_pose():
    p = _probes()
    p.t_open, p.t_close = 0.0, 1e12
    for i in range(30):
        t = 0.1 * i
        p.turn[t] = 10.0 + i
        p.pose_at[t] = 10.0 + i + 0.001 * (i + 1)
        p.outcomes.append((0.0, t, True))
    run = run_mod.Run(p, None, setup_s=5.0, window_s=2.0, lk_bound_s=None)
    from plbench.metrics import frames_per_s, pose_ms_p90, setup_s

    lat = [1.0 * (i + 1) for i in range(30)]
    assert pose_ms_p90.read(run) == pytest.approx(
        statistics.quantiles(lat, n=10, method="inclusive")[8])
    assert frames_per_s.read(run) == pytest.approx(30 * 2 / 2.0)
    assert setup_s.read(run) == 5.0


def test_readers_without_a_trace_read_nothing():
    p = _probes()
    run = run_mod.Run(p, None, setup_s=1.0, window_s=1.0, lk_bound_s=None)
    from plbench.metrics import (decode_ms, device_idle_pct, hamming_roofline, keyframe_ms,
                                 lk_roofline, pgo_ms, points_device_ms, solve_host_ms)

    for r in (decode_ms, device_idle_pct, hamming_roofline, keyframe_ms, lk_roofline, pgo_ms,
              points_device_ms, solve_host_ms):
        assert r.read(run) is None


def test_trace_readers():
    p = _probes()
    p.traced = {"camera": 10, "published": 5}
    p.hamming_shapes = [(64, 64)] * 5
    summary = {"busy_s": 0.25, "window_s": 1.0,
               "by_span": {"points": 0.02, "lines": 0.01, "solve": 0.2},
               "by_name": {"lk_track_kernel": 0.001, "hamming_kernel_x": 0.0001, "gemm": 0.2},
               "count": {"lk_track_kernel": 10, "hamming_kernel_x": 5, "gemm": 100}}
    run = run_mod.Run(p, summary, setup_s=1.0, window_s=1.0, lk_bound_s=1e-6)
    from plbench import bounds
    from plbench.metrics import (device_idle_pct, hamming_roofline, lines_device_ms,
                                 lk_roofline, points_device_ms, solve_device_ms)

    assert points_device_ms.read(run) == pytest.approx(2.0)
    assert lines_device_ms.read(run) == pytest.approx(2.0)
    assert solve_device_ms.read(run) == pytest.approx(40.0)
    assert device_idle_pct.read(run) == pytest.approx(75.0)
    assert lk_roofline.read(run) == pytest.approx(100 * 1e-6 / 1e-4)
    assert hamming_roofline.read(run) == pytest.approx(
        100 * 5 * bounds.hamming_bound_s(64, 64) / 1e-4)


def test_span_sums_host_time_inside_the_window_only():
    p = _probes()
    with p.span("solve"):
        pass
    assert p.host_s["solve"] == 0.0
    p.t_open, p.t_close = 0.0, 1e12
    with p.span("solve"):
        with p.span("solve"):  # nested: counted once
            sum(range(10000))
    assert p.host_s["solve"] > 0.0


def test_line_and_search_calls_are_sampled_apart():
    check = dict(TRAFFIC["check"], hamming_p=1.0, hamming_max=2, search_p=0.0, search_max=3)
    p = Probes(dict(TRAFFIC, check=check), 1000.0, seed=3, stride=2, trace=False)
    p.t_open, p.t_close = 0.0, 1e12

    def calls(kind, n):
        taken = [p._take(kind) for _ in range(n)]
        p.samples[kind].extend({} for t in taken if t)
        return taken

    # the line matcher's calls fill their own quota ...
    assert [calls("hamming", 1)[0] for _ in range(3)] == [True, True, False]
    # ... and the keyframe search's first call of the window is still taken
    assert [calls("search", 1)[0] for _ in range(3)] == [True, False, False]
