"""The harness end to end on the CPU (the port's plain kernels), at a short
recording: the last line's contract, and `correct` coming out false with the
timed path broken underneath, once for each fault the cells can have: a
solve that returns its state unchanged, a marginalization whose prior stops
moving (it returns the prior it was given) or is left out of the next
solve, half of a batch of tracks left out, and an answer altered where it
is produced (an LK track, a Hamming distance). The look for a card is
skipped (`--device cpu`)."""
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from plbench import run

ARGS = ["--workload", "euroc_plvio.stream", "--seed", "2147483659", "--seconds", "20",
        "--device", "cpu", "--scene-seconds", "7", "--trace", "0"]


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


def test_last_line_contract():
    rc, out, err = _run(ARGS)
    assert rc == 0
    res = json.loads(out[-1])
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) <= {"frames_per_s", "pose_ms_p90", "setup_s"}
    assert "setup_s" in res["metrics"] and res["metrics"]["setup_s"]["unit"] == "s"
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    info = json.loads(out[-2])
    assert info["info"] == "plbench" and "ate_m" in info
    # every number compared, beside its limit, as the last lines on stderr
    checks = [line for line in err if line.startswith("check ")]
    assert len(checks) == len(res["checks"]) and err[-len(checks):] == checks


def _fault(monkeypatch, which, when=None):
    """Break the timed path underneath the harness: `which` names the fault;
    `when`, where given, says whether a prior fault acts at this tick (by
    default from the run's first prior on)."""
    from plslam_torch.models import burst, estimator, frontend_lines, frontend_points
    from plslam_torch.models import marginalization
    from plslam_torch.ops.kernels import hamming

    # the streaming estimator's solve and the burst step's (its module binds
    # `backend_tick` by name)
    def solve_fault(backend_tick):
        monkeypatch.setattr(estimator, "backend_tick", backend_tick)
        monkeypatch.setattr(burst, "backend_tick", backend_tick)

    if which in ("stale_prior", "dropped_prior"):
        tick = estimator.backend_tick

        def backend_tick(st, f, *a, **kw):
            st_out, stats, prior, aux = tick(st, f, *a, **kw)
            if prior is None or (when is not None and not when()):
                pass
            elif which == "stale_prior":
                # once there is a prior, the one it was given: it stops moving
                given = marginalization.Prior(
                    J=f.prior_J, r0=f.prior_r0, valid=f.prior_valid, p=f.prior_p, q=f.prior_q,
                    v=f.prior_v, ba=f.prior_ba, bg=f.prior_bg, p_bc=f.prior_p_bc,
                    q_bc=f.prior_q_bc, td=f.prior_td)
                prior = marginalization.Prior(*[torch.where(f.prior_valid > 0, a, b)
                                                for a, b in zip(given, prior)])
            else:  # left out of the next solve
                prior = prior._replace(valid=torch.zeros_like(prior.valid))
            return st_out, stats, prior, aux

        solve_fault(backend_tick)
    elif which == "stale_solve":
        tick = estimator.backend_tick

        def backend_tick(st, *a, **kw):
            st_out, stats, prior, aux = tick(st, *a, **kw)
            return st, stats, prior, aux

        solve_fault(backend_tick)
    elif which in ("lk_answer", "lk_half"):
        lk = frontend_points.lk_track

        def lk_track(*a, **kw):
            pts, status, err = lk(*a, **kw)
            pts, status = pts.clone(), status.clone()
            if which == "lk_answer":
                pts[int(torch.argmax(status.to(torch.int64)))] += 0.5
            else:
                status[status.shape[0] // 2:] = False
            return pts, status, err

        monkeypatch.setattr(frontend_points, "lk_track", lk_track)
    elif which in ("hamming_answer", "search_answer"):
        # the line matcher holds its own binding of the kernel's function;
        # the keyframe search calls it through the kernel's module
        owner = frontend_lines if which == "hamming_answer" else hamming
        ham = owner.hamming_matrix

        def hamming_matrix(d1, d2):
            out = ham(d1, d2).clone()
            out[0, 0] += 1
            return out

        monkeypatch.setattr(owner, "hamming_matrix", hamming_matrix)


def every_tick(monkeypatch):
    """Compare every tick of the window, up to the cell's most: a short
    window holds few ticks, and a prior that stops moving shows only at a
    tick that has a prior to keep and would have moved it."""
    from plbench import probes

    init = probes.Probes.__init__

    def __init__(self, *a, **kw):
        init(self, *a, **kw)
        self.want["solve_p"] = 1.0

    monkeypatch.setattr(probes.Probes, "__init__", __init__)


@pytest.mark.parametrize("which", ["stale_solve", "stale_prior", "dropped_prior", "lk_answer",
                                   "lk_half", "hamming_answer"])
def test_a_broken_path_is_not_correct(monkeypatch, which):
    _fault(monkeypatch, which)
    if which.endswith("_prior"):
        every_tick(monkeypatch)
    rc, out, _ = _run(ARGS)
    assert rc == 0
    assert json.loads(out[-1])["correct"] is False
