"""The port's command line (`python -m plslam_torch`) against the JAX
package's (`plslam/__main__.py`): `test_cli.py`'s six cases on the port, all
with `--device cpu`; `eval` printing the JAX `eval`'s JSON line on the same
TUM files; `run`'s TUM trajectory equal to `run_euroc` called directly; and
`--device cuda` on a host without CUDA raising instead of falling back.

The runs use `test_cli.py`'s rendered set and YAML with a 5-state window and
64 feature slots, over 12 published frames, to keep the port's CPU solves
short. Tolerances: score lines equal as parsed JSON (both packages round the same
float64 numbers the same way); TUM files byte for byte.
"""
import json
import os

import numpy as np
import pytest
import torch

from plslam.__main__ import main as jax_main
from plslam_torch.__main__ import EUROC_SEQUENCES, main
from plslam_torch.eval.metrics import write_tum

H, W, F = 240, 376, 160.0
MAX_FRAMES = 12  # published frames of a run (JAX's test: 25, with the default 10-state window)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _make_traj(n=60, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    ts = np.arange(n) * 0.1
    ps = np.stack([np.cos(ts), np.sin(ts), 0.1 * ts], axis=1)
    ps = ps + noise * rng.standard_normal(ps.shape)
    qs = np.tile(np.array([1.0, 0, 0, 0]), (n, 1))
    return ts, ps, qs


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _gauge_pair(tmp_path):
    """gt.tum and est.tum: the ground truth turned 30° in yaw and shifted."""
    ts, ps, qs = _make_traj()
    gt, est = tmp_path / "gt.tum", tmp_path / "est.tum"
    write_tum(gt, ts, ps, qs)
    th = np.deg2rad(30)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    write_tum(est, ts, ps @ R.T + np.array([5.0, -2.0, 0.3]), qs)
    return est, gt


def _euroc_gt_dir(tmp_path, ts, ps):
    mav = tmp_path / "seq" / "mav0"
    for sub in ("imu0", "cam0", "state_groundtruth_estimate0"):
        os.makedirs(mav / sub)
    with open(mav / "imu0" / "data.csv", "w") as fh:
        fh.write("#t,wx,wy,wz,ax,ay,az\n")
        for t in ts:
            fh.write(f"{int(t*1e9)},0,0,0,0,0,9.81\n")
    with open(mav / "cam0" / "data.csv", "w") as fh:
        fh.write("#t,filename\n")
    with open(mav / "state_groundtruth_estimate0" / "data.csv", "w") as fh:
        fh.write("#t,px,py,pz,qw,qx,qy,qz,vx,vy,vz\n")
        for t, p in zip(ts, ps):
            fh.write(f"{int(t*1e9)},{p[0]},{p[1]},{p[2]},1,0,0,0,0,0,0\n")
    return tmp_path / "seq"


def test_eval_subcommand(tmp_path, capsys):
    est, gt = _gauge_pair(tmp_path)
    main(["eval", "--est", str(est), "--gt", str(gt)])
    out = _last_json(capsys)
    assert out["ate_rmse_m"] < 1e-4  # yaw alignment removes the gauge offset
    assert out["frames"] == 60


def test_eval_against_euroc_gt_csv(tmp_path, capsys):
    ts, ps, qs = _make_traj()
    seq = _euroc_gt_dir(tmp_path, ts, ps)
    est = tmp_path / "est.tum"
    write_tum(est, ts, ps + 0.01, qs)
    main(["eval", "--est", str(est), "--data", str(seq)])
    out = _last_json(capsys)
    assert out["ate_rmse_m"] < 0.02


@pytest.mark.parametrize("align", ["yaw", "se3", "sim3"])
def test_eval_prints_the_jax_line(tmp_path, capsys, align):
    """The same TUM files through both packages' `eval`: the same line, for
    noisy trajectories and both ground-truth sources."""
    ts, ps, qs = _make_traj(noise=0.05, seed=3)
    rng = np.random.default_rng(4)
    qs = qs + 0.05 * rng.standard_normal(qs.shape)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    est, gt = tmp_path / "est.tum", tmp_path / "gt.tum"
    write_tum(est, ts, ps, qs)
    gts, gps, gqs = _make_traj()
    write_tum(gt, gts, gps, gqs)
    seq = _euroc_gt_dir(tmp_path, gts, gps)
    for src in (["--gt", str(gt)], ["--data", str(seq)]):
        args = ["eval", "--est", str(est), *src, "--align", align, "--rpe-delta", "0.5"]
        main(args)
        port = capsys.readouterr().out
        jax_main(args)
        ref = capsys.readouterr().out
        assert port == ref
        assert json.loads(port)["ate_rmse_m"] > 0.01


def test_run_requires_data():
    with pytest.raises(SystemExit):
        main(["run"])


def test_parity_no_sequences_exits(tmp_path):
    with pytest.raises(SystemExit):
        main(["parity", "--data", str(tmp_path), "--device", "cpu"])


def test_euroc_sequences_are_jax_s():
    from plslam.__main__ import EUROC_SEQUENCES as JAX_SEQUENCES

    assert EUROC_SEQUENCES == JAX_SEQUENCES


def _render_dataset(path):
    from plslam_torch.io import render, synthetic
    from plslam_torch.ops.cameras import PinholeRadTan

    seq = synthetic.make_sequence(duration=4.0, n_points=300, n_lines=0, seed=5,
                                  params=synthetic.TrajectoryParams(wiggle_amp=0.1))
    cam = PinholeRadTan.create(F, F, W / 2, H / 2)
    render.write_euroc_dataset(seq, str(path), cam, H, W, max_frames=60,
                               blob_sigma=2.0, style="textured")
    return seq


def _yaml(path, seq):
    """`test_cli.py`'s reference-format YAML, with a 5-state window."""
    from plslam_torch.utils.geometry import quat_to_rot

    R_bc = quat_to_rot(seq.q_bc).numpy().reshape(-1)
    p_bc = seq.p_bc.numpy()
    path.write_text(f"""%YAML:1.0
image_width: {W}
image_height: {H}
projection_parameters:
   fx: {F}
   fy: {F}
   cx: {W/2}
   cy: {H/2}
max_cnt: 80
min_dist: 20
min_score: 0.002
equalize: 1
loop_closure: 0
window_size: 5
max_features: 64
extrinsicRotation: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [{", ".join(f"{v:.9f}" for v in R_bc)}]
extrinsicTranslation: !!opencv-matrix
   rows: 3
   cols: 1
   dt: d
   data: [{", ".join(f"{v:.9f}" for v in p_bc)}]
""")
    return path


@pytest.fixture(scope="module")
def euroc_root(tmp_path_factory):
    """`test_cli.py`'s rendered set, as the MH_01_easy sequence of a root."""
    torch.set_num_threads(1)  # module fixtures run before the autouse one
    root = tmp_path_factory.mktemp("euroc")
    seq = _render_dataset(root / "MH_01_easy")
    return root, _yaml(root / "cfg.yaml", seq)


def test_run_subcommand_on_rendered_dataset(euroc_root, tmp_path, capsys):
    """`python -m plslam_torch run` end to end on the small rendered set; its
    TUM file is `run_euroc`'s trajectory, called directly, byte for byte."""
    from plslam_torch.config import PLSlamConfig
    from plslam_torch.runner import run_euroc

    root, yaml_path = euroc_root
    data = str(root / "MH_01_easy")
    out = tmp_path / "out"
    main(["run", "--data", data, "--config", str(yaml_path), "--output", str(out),
          "--no-lines", "--max-frames", str(MAX_FRAMES), "--quiet", "--device", "cpu"])
    traj = out / "traj_vio.tum"
    body = np.loadtxt(traj)
    assert body.ndim == 2 and body.shape[1] == 8 and len(body) > 5
    score = _last_json(capsys)
    assert np.isfinite(score["ate_rmse_m"]) and score["frames"] == len(body)
    ts, ps, qs, _, pg = run_euroc(data, PLSlamConfig.from_yaml(str(yaml_path)), use_lines=False,
                                  max_frames=MAX_FRAMES, device="cpu")
    assert pg is None
    write_tum(tmp_path / "direct.tum", ts, ps, qs)
    assert (tmp_path / "direct.tum").read_bytes() == traj.read_bytes()


def test_parity_subcommand_autodetects_sequences(euroc_root, tmp_path, capsys):
    """`python -m plslam_torch parity` finds the sequence under the root,
    runs it and writes the table."""
    root, yaml_path = euroc_root
    out = tmp_path / "pout"
    main(["parity", "--data", str(root), "--config", str(yaml_path), "--output", str(out),
          "--no-lines", "--max-frames", str(MAX_FRAMES), "--device", "cpu"])
    row = _last_json(capsys)
    assert row["sequence"] == "MH_01_easy"
    assert "error" not in row, row
    assert np.isfinite(row["ate_rmse_m"]) and row["lineage_ate_m"] == 0.12
    assert (out / "parity.md").exists()
    assert (out / "MH_01_easy.tum").exists()


@pytest.mark.parametrize("cmd", ["run", "parity"])
def test_device_cuda_without_a_card_raises(euroc_root, tmp_path, monkeypatch, cmd):
    """The default `--device cuda` on a host without CUDA raises; nothing
    runs on the CPU instead and no trajectory is written."""
    root, _ = euroc_root
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = str(root / "MH_01_easy") if cmd == "run" else str(root)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([cmd, "--data", data, "--output", str(tmp_path / "o")])
    assert not (tmp_path / "o" / "traj_vio.tum").exists()
