"""Port parity, the slice end to end: the simulator and renderer, then the
points-only streaming `run_euroc` of both packages on the same rendered
dataset.

Tolerances:
  * simulator sequences 1e-9 (both float64; trajectory derivatives by
    forward-mode AD in both packages, the numpy RNG drawn in the same order);
  * rendered images within 1/255 (one 8-bit PNG quantization step);
  * `run_euroc`: both initialize, both ATEs < 0.4 m and within 0.05 m of
    each other, with loop closure off and on (the JAX default). Both track with the same LK formulation (each package's
    default, `lk_track_fast`) but draw different RANSAC samples, so
    trajectories are compared, not bits; they were 0.0076 m apart (JAX
    0.0213 m, port 0.0289 m, one run on a CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

from plslam.config import (CameraConfig, ExtrinsicConfig, LoopConfig, PLSlamConfig, SolverConfig,
                           TrackerConfig)
from plslam.eval.metrics import ate_rmse
from plslam.io import render as jrender
from plslam.io import synthetic as jsyn
from plslam.ops.cameras import PinholeRadTan as JCam
from plslam.runner import run_euroc as j_run_euroc
from plslam_torch.convert import config_from_jax
from plslam_torch.io import render as trender
from plslam_torch.io import synthetic as tsyn
from plslam_torch.ops.cameras import PinholeRadTan as TCam
from plslam_torch.runner import run_euroc as t_run_euroc

H, W, F = 240, 320, 230.0
PARAMS = dict(omega=0.4, z_omega=0.7, wiggle_amp=0.15, excite_amp=0.1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def small_config(seq, dtype="float64"):
    """The 320×240, f=230 rendered-pipeline configuration of the slice tests."""
    from plslam_torch.utils.geometry import quat_to_rot

    R_bc = quat_to_rot(torch.as_tensor(np.asarray(seq.q_bc), dtype=torch.float64)).numpy()
    return PLSlamConfig(
        camera=CameraConfig(image_width=W, image_height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                            k1=0, k2=0, p1=0, p2=0),
        tracker=TrackerConfig(max_cnt=80, min_dist=20, equalize=True, min_score=2e-3),
        solver=SolverConfig(max_features=64, max_line_feats=8, dtype=dtype, focal_length=F),
        extrinsic=ExtrinsicConfig(0, tuple(R_bc.reshape(-1)), tuple(np.asarray(seq.p_bc))),
        loop=LoopConfig(loop_closure=False),
    )


def small_dataset(path, duration, seed=11):
    seq = tsyn.make_sequence(duration=duration, n_points=300, n_lines=20, seed=seed,
                             params=tsyn.TrajectoryParams(**PARAMS))
    trender.write_euroc_dataset(seq, str(path), TCam.create(F, F, W / 2, H / 2), H, W,
                                blob_sigma=2.0, style="textured")
    return seq


def test_synthetic_matches_jax():
    kw = dict(duration=3.0, n_points=80, n_lines=20, seed=5, acc_noise=0.1, gyr_noise=0.005,
              acc_bias=0.05, gyr_bias=0.002, pix_noise=0.5)
    j = jsyn.make_sequence(params=jsyn.TrajectoryParams(**PARAMS), **kw)
    t = tsyn.make_sequence(params=tsyn.TrajectoryParams(**PARAMS), **kw)
    for name in t._fields:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            # points behind the camera project through z clamped at 1e-6 (~1e7):
            # those entries are compared relatively
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("style", ["gaussian", "textured"])
def test_render_matches_jax(style):
    kw = dict(duration=1.0, n_points=200, n_lines=30, seed=2, params=None)
    j = jsyn.make_sequence(**{**kw, "params": jsyn.TrajectoryParams(**PARAMS)})
    t = tsyn.make_sequence(**{**kw, "params": tsyn.TrajectoryParams(**PARAMS)})
    for k in (0, 7, 19):
        a = trender.render_frame(t, k, TCam.create(F, F, W / 2, H / 2), H, W, blob_sigma=2.0,
                                 style=style)
        b = jrender.render_frame(j, k, JCam.create(F, F, W / 2, H / 2), H, W, blob_sigma=2.0,
                                 style=style)
        assert a.shape == b.shape == (H, W)
        np.testing.assert_allclose(a, b, rtol=0, atol=1.0 / 255.0)


def test_run_euroc_matches_jax(tmp_path):
    """Points-only streaming run of both packages on the same 5 s render."""
    seq = small_dataset(tmp_path, 5.0)
    cfg = small_config(seq)
    gt_t, gt_p = seq.frame_t.numpy(), seq.gt_p.numpy()
    jts, jps, _, jest, _ = j_run_euroc(str(tmp_path), cfg, use_lines=False, loop_closure=False)
    tts, tps, _, test, _ = t_run_euroc(str(tmp_path), config_from_jax(cfg), use_lines=False,
                                       loop_closure=False, device="cpu")
    assert jest.initialized and test.initialized
    assert len(tts) > 20 and len(jts) > 20
    j_ate = ate_rmse(jts, jps, gt_t, gt_p, align="yaw")
    t_ate = ate_rmse(tts, tps, gt_t, gt_p, align="yaw")
    assert j_ate < 0.4 and t_ate < 0.4, (j_ate, t_ate)
    assert abs(t_ate - j_ate) < 0.05, (j_ate, t_ate)


def test_run_euroc_loop_closure_matches_jax(tmp_path):
    """The same comparison with loop closure on, as each package's
    `run_euroc` defaults to it from `config.loop`: every solved keyframe
    enters both pose graphs with its image (the 5-s run is too short for a
    loop, so the corrected poses are the VIO poses)."""
    seq = small_dataset(tmp_path, 5.0)
    cfg = dataclasses.replace(small_config(seq), loop=LoopConfig(loop_closure=True))
    gt_t, gt_p = seq.frame_t.numpy(), seq.gt_p.numpy()
    jts, jps, _, jest, jpg = j_run_euroc(str(tmp_path), cfg, use_lines=False)
    tts, tps, _, test, tpg = t_run_euroc(str(tmp_path), config_from_jax(cfg), use_lines=False,
                                         device="cpu")
    assert jest.initialized and test.initialized
    assert len(tts) > 20 and len(jts) > 20
    assert tpg.n == tpg.db.n and jpg.n == jpg.db.n
    assert tpg.n > 10 and abs(tpg.n - jpg.n) <= 1, (tpg.n, jpg.n)
    assert tpg.loop_count == jpg.loop_count == 0
    j_ate = ate_rmse(jts, jps, gt_t, gt_p, align="yaw")
    t_ate = ate_rmse(tts, tps, gt_t, gt_p, align="yaw")
    assert j_ate < 0.4 and t_ate < 0.4, (j_ate, t_ate)
    assert abs(t_ate - j_ate) < 0.05, (j_ate, t_ate)
