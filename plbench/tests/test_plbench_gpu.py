"""On the card, at the cells' own sizes: the control of the comparison and
the faults that the CPU tests cannot reach. The control is the port with
TF32 matmuls and convolutions switched on (the precision below the
configuration's float32 with TF32 off); it has to come out not correct on
three seeds in each cell. The faults, each on three seeds: a 4-DoF PGO that
returns the poses it was given (`pgo_gap_m`); a marginalization whose prior
stops moving, or is left out of the next solve, in each cell (`marg_gap`;
in the burst cell from the window's opening on, so inside the chunk
steps); a distance of the keyframe search altered where it is produced
(`search_mismatch`). Run on a card with

    python3 -m pytest plbench/tests/test_plbench_gpu.py -m gpu -s
"""
import io
import json
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from plbench import cell, probes, run
from plbench.tests.test_plbench_harness import _fault, every_tick

SEEDS = (1985095059, 2200000001, 7)
CELLS = ["euroc_plvio.stream", "euroc_plslam.revisit", "euroc_plvio.burst"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(card, workload, seed):
    cmd = [sys.executable, "plbench/run.py", "--workload", workload, "--seed", str(seed),
           "--seconds", "15", "--trace", "0", "--control", "tf32"]
    p = subprocess.run(cmd, cwd=cell.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.splitlines()[-1])
    print(workload, seed, json.dumps(res["checks"]))
    assert res["correct"] is False


def _main(argv, info=None):
    """The result line of a run in this process; `info`, where given, takes
    the info line."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(argv)
    assert rc == 0, err.getvalue()[-2000:]
    lines = out.getvalue().splitlines()
    if info is not None:
        info.update(json.loads(lines[-2]))
    return json.loads(lines[-1])


def _window_open(monkeypatch):
    """A callable that is true while the run's window is open."""
    seen = []
    install = probes.Probes.install

    def keep(self, *a, **kw):
        seen.append(self)
        return install(self, *a, **kw)

    monkeypatch.setattr(probes.Probes, "install", keep)
    return lambda: bool(seen) and seen[0].in_window()


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["stale_prior", "dropped_prior"])
@pytest.mark.parametrize("seed", SEEDS)
def test_a_broken_prior_is_not_correct(card, monkeypatch, workload, fault, seed):
    burst = workload == "euroc_plvio.burst"
    if burst:
        # from the window's opening on: a prior broken from the first one on
        # drives the estimator into failure detection and the runner back to
        # streaming before the window; a 6-s window holds few ticks, so each
        # is compared up to the cell's most
        _fault(monkeypatch, fault, when=_window_open(monkeypatch))
        every_tick(monkeypatch)
    else:
        _fault(monkeypatch, fault)
    info = {}
    res = _main(["--workload", workload, "--seed", str(seed), "--seconds", "6", "--trace", "0"],
                info)
    print(workload, fault, seed, json.dumps(res["checks"]), json.dumps(info["from_chunk"]))
    assert res["correct"] is False
    if burst:
        assert info["compared"]["solve"] == info["from_chunk"]["solve"] > 0
    # a prior that stops moving can leave the estimator failing through the
    # whole window: then no tick is compared and the number is missing
    gap = res["checks"]["marg_gap"]
    assert gap["value"] is None or gap["value"] > gap["limit"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_an_altered_search_is_not_correct(card, monkeypatch, seed):
    _fault(monkeypatch, "search_answer")
    res = _main(["--workload", "euroc_plslam.revisit", "--seed", str(seed), "--seconds", "40",
                 "--trace", "0"])
    print("altered search", seed, json.dumps(res["checks"]))
    assert "search_mismatch" in res["checks"] and res["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_stale_pgo_is_not_correct(card, monkeypatch, seed):
    from plslam_torch.models import pose_graph

    solve = pose_graph.optimize_4dof

    def optimize_4dof(xyz0, yaw0, *a, **kw):
        _, _, costs = solve(xyz0, yaw0, *a, **kw)
        return xyz0.clone(), yaw0.clone(), costs

    monkeypatch.setattr(pose_graph, "optimize_4dof", optimize_4dof)
    res = _main(["--workload", "euroc_plslam.revisit", "--seed", str(seed), "--seconds", "40",
                 "--trace", "0"])
    print("stale pgo", seed, json.dumps(res["checks"]))
    assert "pgo_gap_m" in res["checks"] and res["correct"] is False
