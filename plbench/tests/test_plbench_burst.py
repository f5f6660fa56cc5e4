"""Offline burst replay under the harness, on the CPU (the port's plain
kernels), at a short recording: the window opens at the end of the first
chunk, so the first LK, line-matcher Hamming and solve samples come from
chunk steps (the steps call the frontend modules' patched globals and the
burst module's own binding of `backend_tick`), the run is correct, the
layers' spans open inside the steps, and the published frames of a chunk
that failure detection cuts short count as attempted and failed. The look for a card is skipped (`--device cpu`). A
chunk takes tens of seconds on a CPU, so the window holds one chunk,
whatever its length: it closes once the runner has logged the first chunk
that started inside it (or a fallback to streaming, or 16 outcomes)."""
import io
import json
import math
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from plbench import probes, run
from plbench.tests.test_plbench_harness import _fault, every_tick

ARGS = ["--workload", "euroc_plvio.burst", "--seed", "2147483659", "--seconds", "1000",
        "--device", "cpu", "--scene-seconds", "8", "--trace", "0"]


def _run(monkeypatch, fail_from=None, lk_half=False):
    """(result line, info line, the run's Probes) of a run whose window holds
    its first chunk alone; `fail_from`: that chunk's steps from this one on
    report failure detection; `lk_half`: inside the window, the second half
    of the tracks that the LK kernel calls good are called lost (outside it
    the tracker would lose too many to initialize on a short recording)."""
    from plslam_torch.models import burst

    seen = []
    install, chunk = probes.Probes.install, burst.BurstStep.run_chunk

    def keep(self, *a, **kw):
        seen.append(self)
        hook = self.burst_log._hook

        def close_after(e):
            hook(e)
            if self.t_open is not None and (("chunk_s" in e and e["t0"] >= self.t_open)
                                            or ("fallback" in e and self.in_window())):
                self.t_close = min(self.t_close, time.perf_counter())

        outcome = self._outcome

        def close_after_16(m):  # read as the estimator's metrics list's hook
            outcome(m)
            if self.in_window() and len(self.outcomes) >= 16:
                self.t_close = min(self.t_close, time.perf_counter())

        self.burst_log._hook, self._outcome = close_after, close_after_16
        return install(self, *a, **kw)

    def run_chunk(step, *a, **kw):
        carry, outs = chunk(step, *a, **kw)
        if fail_from is not None and seen[0].in_window():  # the window's chunk
            fail = outs["fail"].clone()
            fail[fail_from:] = True
            outs = dict(outs, fail=fail)
        return carry, outs

    monkeypatch.setattr(probes.Probes, "install", keep)
    monkeypatch.setattr(burst.BurstStep, "run_chunk", run_chunk)
    if lk_half:
        from plslam_torch.models import frontend_points

        lk = frontend_points.lk_track

        def lk_track(*a, **kw):
            pts, status, err = lk(*a, **kw)
            if seen[0].in_window():
                good = torch.nonzero(status).flatten()
                status = status.clone()
                status[good[len(good) // 2:]] = False
            return pts, status, err

        monkeypatch.setattr(frontend_points, "lk_track", lk_track)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(ARGS)
    lines = out.getvalue().splitlines()
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(lines[-1]), json.loads(lines[-2]), seen[0]


def test_burst_samples_come_from_chunk_steps(monkeypatch):
    res, info, p = _run(monkeypatch)
    assert res["correct"] is True, res["checks"]
    for kind in ("lk", "hamming", "solve"):
        assert p.samples[kind] and all(s["chunk"] for s in p.samples[kind]), kind
        assert info["from_chunk"][kind] == info["compared"][kind] == len(p.samples[kind]), (
            kind, info["from_chunk"], info["compared"])
    assert {"solve_cost_gap", "marg_gap", "lk_gap_px", "hamming_mismatch"} <= set(res["checks"])
    # the window's chunk: 8 published frames of 2 camera frames each, all posed
    assert p.counts["published"] == 8 and p.counts["camera"] == 16
    assert (res["attempted"], res["failed"], info["dropped"]) == (8, 0, 0)
    assert res["metrics"]["frames_per_s"]["value"] == 16 / info["window_s"]
    # the layers' spans inside the steps: each holds host time of its own
    assert all(p.host_s[k] > 0.0 for k in ("points", "lines", "solve")), p.host_s
    assert res["metrics"].keys() == {"frames_per_s", "setup_s"}
    # the burst frames' positions, read back after the run, reach the ATE
    assert info["poses"] >= 16 and info["ate_m"] is not None


def test_a_chunk_cut_by_failure_detection_counts_its_dropped_frames(monkeypatch):
    """Failure detection planted in the window's first chunk from its fourth
    step on: the runner emits three frames, drops five and falls back to
    streaming, which clears the estimator and initializes again."""
    res, info, p = _run(monkeypatch, fail_from=3)
    assert [e["dropped"] for e in p.burst_log if e.get("dropped")] == [5]
    assert any(e.get("fallback") == "failure detection" for e in p.burst_log)
    assert info["dropped"] == 5
    assert (res["attempted"], res["failed"]) == (8, 5)
    dropped = [o for o in p.outcomes if math.isnan(o[1])]
    assert len(dropped) == 5 and not any(posed for _, _, posed in dropped)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("which", ["stale_solve", "stale_prior", "dropped_prior", "lk_answer",
                                   "lk_half", "hamming_answer"])
def test_a_broken_chunk_step_is_not_correct(monkeypatch, which):
    """The timed path broken underneath the chunk steps, as the streaming
    cells' faults break it: a solve that returns its state unchanged, a
    prior that stops moving or is left out of the next solve, an LK track
    or a Hamming distance altered where it is produced, half of a batch of
    tracks left out."""
    if which != "lk_half":
        _fault(monkeypatch, which)
    if which.endswith("_prior"):
        every_tick(monkeypatch)
    res, info, p = _run(monkeypatch, lk_half=which == "lk_half")
    assert res["correct"] is False, res["checks"]
