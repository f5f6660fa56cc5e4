"""The port's runner on its own: the pipelined loop (decode worker thread +
deferred solve readback) gives the same trajectory as the synchronous loop,
the slice runs with JAX and the JAX package blocked (as on the machine with
the card), neither the package nor the chip smoke script imports JAX or
`plslam`, the entry points default to the card (and raise without one), and the
track visualizer (`tracker.show_track`), not ported yet, raises a clear
`NotImplementedError`. Loop closure over two runs sharing a map is held against JAX in
`test_torch_map.py`."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from plslam_torch.config import PLSlamConfig, TrackerConfig
from plslam_torch.convert import config_from_jax
from plslam_torch.runner import run_euroc
from plslam_torch.utils.device import resolve_device
from test_torch_slice import small_config, small_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("render")
    return path, small_dataset(path, 3.5)


def test_pipeline_matches_synchronous(dataset):
    path, seq = dataset
    cfg = config_from_jax(small_config(seq))
    out_p = run_euroc(str(path), cfg, pipeline=True, device="cpu")
    out_s = run_euroc(str(path), cfg, pipeline=False, device="cpu")
    assert out_p[3].initialized and len(out_p[0]) > 5
    for a, b in zip(out_p[:3], out_s[:3]):
        np.testing.assert_array_equal(a, b)  # bit-identical


@pytest.mark.parametrize("kwargs,item", [
    (dict(config=PLSlamConfig(tracker=TrackerConfig(show_track=True))), "item 15"),
])
def test_run_euroc_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        run_euroc("unused", **kwargs)


def test_package_has_no_jax_import():
    """No module of the port imports JAX or the JAX package."""
    for root, _, files in os.walk(os.path.join(REPO, "plslam_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as fh:
                    src = fh.read()
                for bad in ("import jax", "from jax", "import plslam\n", "import plslam.",
                            "import plslam ", "from plslam."):
                    assert bad not in src, (name, bad)


def test_resolve_device_defaults_to_the_card():
    """`device=None` means CUDA and raises on a host without it: no CPU fallback."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_imports_only_the_port():
    """`chip_smoke.py` imports the port and nothing of JAX or `plslam`."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert any(m.startswith("plslam_torch") for m in names)
    for m in names:
        assert m.split(".")[0] not in ("plslam", "jax", "jaxlib"), m


_BLOCKED = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["plslam"] = None  # and so does any import of the JAX package
import numpy as np, torch
torch.set_num_threads(1)
from plslam_torch.io import synthetic
from plslam_torch.runner import run_euroc, run_synthetic
from plslam_torch.config import PLSlamConfig, SolverConfig
seq = synthetic.make_sequence(duration=2.0, n_points=60, n_lines=12, seed=1)
cfg = PLSlamConfig(solver=SolverConfig(max_features=32, max_line_feats=8, dtype="float64"))
ts, ps, qs, est = run_synthetic(seq, cfg, oracle_init=True, max_frames=13, device="cpu")
assert est.initialized and np.isfinite(ps).all() and len(ps) >= 2
from plslam_torch.config import CameraConfig, TrackerConfig
cfg = PLSlamConfig(
    camera=CameraConfig(image_width=320, image_height=240, fx=230.0, fy=230.0, cx=160.0, cy=120.0,
                        k1=0, k2=0, p1=0, p2=0),
    tracker=TrackerConfig(max_cnt=80, min_dist=20, min_score=2e-3, max_lines=16, line_desc="binary"),
    solver=SolverConfig(max_features=64, max_line_feats=8, dtype="float64", focal_length=230.0))
ts, ps, qs, est, _ = run_euroc({path!r}, cfg, max_frames=4, device="cpu")  # lines by default
assert len(est.metrics) == 4 and est.ln_table.active.any()
print("ran without jax")
"""


def test_slice_runs_with_jax_blocked(dataset):
    path, _ = dataset
    code = _BLOCKED.format(path=str(path))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ran without jax" in proc.stdout
