"""On the card, at the cells' own sizes: the control of the comparison and
the faults that the CPU tests cannot reach. The control is the port with
TF32 matmuls and convolutions switched on (the precision below the
configuration's float32 with TF32 off); it has to come out not correct on
three seeds in each cell. The faults, each on three seeds: a 4-DoF PGO that
returns the poses it was given (`pgo_gap_m`); a marginalization whose prior
stops moving, or is left out of the next solve, in each cell (`marg_gap`); a distance of the keyframe search altered where it
is produced (`search_mismatch`). Run on a card with

    python3 -m pytest plbench/tests/test_plbench_gpu.py -m gpu -s
"""
import io
import json
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from plbench import cell, run
from plbench.tests.test_plbench_harness import _fault

SEEDS = (1985095059, 2200000001, 7)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["euroc_plvio.stream", "euroc_plslam.revisit"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(card, workload, seed):
    cmd = [sys.executable, "plbench/run.py", "--workload", workload, "--seed", str(seed),
           "--seconds", "15", "--trace", "0", "--control", "tf32"]
    p = subprocess.run(cmd, cwd=cell.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.splitlines()[-1])
    print(workload, seed, json.dumps(res["checks"]))
    assert res["correct"] is False


def _main(argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(argv)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["euroc_plvio.stream", "euroc_plslam.revisit"])
@pytest.mark.parametrize("fault", ["stale_prior", "dropped_prior"])
@pytest.mark.parametrize("seed", SEEDS)
def test_a_broken_prior_is_not_correct(card, monkeypatch, workload, fault, seed):
    _fault(monkeypatch, fault)
    res = _main(["--workload", workload, "--seed", str(seed), "--seconds", "6", "--trace", "0"])
    print(workload, fault, seed, json.dumps(res["checks"]))
    assert res["correct"] is False
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
