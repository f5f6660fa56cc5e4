"""Runner faults repaired in the port, each against the JAX package's runner:

* `run_synthetic(extrinsic_rot_override=)`: the estimator starts from the
  given R_bc (the JAX runner's option), equal to JAX's start within 1e-12.
* `run_euroc` with a fisheye mask image (`tracker.fisheye_mask`): loaded and
  applied as JAX loads it, and a file that does not load warns and falls
  back to the centered circle. Held against JAX's `run_euroc` on a rendered
  320×240 set with a mask the test writes (its left 64 columns masked out),
  points only, both point frontends fed the JAX frontend's RANSAC draws:
  both ATEs < 0.4 m and within 0.05 m of each other (the slice tests'
  points-only bound), no tracked point inside the masked columns.
* `run_euroc(record_tracks=)`: the published frames' tracks `{t: (ids,
  normalized obs)}`, JAX's and the port's with the mask on: the same
  times, and over the first 3 published frames ids equal exactly and
  observations within 1e-3 px (the frontend tests' bound). Over the whole
  3-s run (30 published frames): ids equal exactly until the first frame
  where they part (at least the first 5; on a CPU they part at t = 0.5 s);
  the ids both packages issued before that frame keep their observations
  within 1e-3 px in every frame (measured at most 1.7e-4 px); in every
  frame at least 80 % of the ids are common (measured 85.9 % at least) and
  at least 95 % of the port's observations have a JAX observation within
  1e-3 px, whatever its id (measured 97.2 % at least). Why they part: at
  t = 0.5 s both LKs put one track 4.2 px off its motion (err 0.094, the
  same position in both); the two F-RANSACs, fed the same draws, rank
  several hypotheses at 69 inliers, a float32 count at the threshold
  differs, and they pick different ones: JAX's keeps the track, the
  port's rejects it and refills the slot. From there every new id is
  issued one apart, so a shared id can name another corner. Recording
  keeps both packages streaming though `burst` is asked for.
"""
import dataclasses

import numpy as np
import pytest
import torch

from plslam.runner import run_euroc as j_run_euroc
from plslam.runner import run_synthetic as j_run_synthetic
from plslam.io import synthetic as jsyn
from plslam.config import ExtrinsicConfig, PLSlamConfig, SolverConfig
from plslam_torch.convert import config_from_jax
from plslam_torch.eval.metrics import ate_rmse
from plslam_torch.io.render import write_png_gray
from plslam_torch.io import synthetic as tsyn
from plslam_torch.runner import run_euroc as t_run_euroc
from plslam_torch.runner import run_synthetic as t_run_synthetic
from plslam_torch.utils import quat_np as qnp
from test_torch_burst_jax import feed_jax_draws
from test_torch_slice import F, H, W, small_config, small_dataset

MASKED_COLS = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_run_synthetic_starts_from_the_extrinsic_override():
    kw = dict(duration=2.0, n_points=60, n_lines=0, seed=9)
    jseq, tseq = jsyn.make_sequence(**kw), tsyn.make_sequence(**kw)
    q_true = np.asarray(jseq.q_bc, np.float64)
    c, s = np.cos(0.1), np.sin(0.1)
    R_pert = qnp.quat_to_rot(q_true) @ np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    cfg = PLSlamConfig(solver=SolverConfig(max_features=32, max_line_feats=8, dtype="float64"),
                       extrinsic=ExtrinsicConfig(estimate_extrinsic=1))
    *_, jest = j_run_synthetic(jseq, cfg, use_lines=False, max_frames=3,
                               extrinsic_rot_override=R_pert)
    *_, test = t_run_synthetic(tseq, config_from_jax(cfg), use_lines=False, max_frames=3,
                               extrinsic_rot_override=R_pert, device="cpu")
    np.testing.assert_allclose(test.q_bc, np.asarray(jest.q_bc), rtol=0, atol=1e-12)
    np.testing.assert_allclose(qnp.quat_to_rot(test.q_bc), R_pert, rtol=0, atol=1e-12)
    err = 2.0 * np.degrees(np.arccos(min(abs(float(np.dot(test.q_bc, q_true))), 1.0)))
    assert err == pytest.approx(np.degrees(0.1), abs=1e-6)


def _mask_png(path):
    mask = np.ones((H, W), np.float32)
    mask[:, :MASKED_COLS] = 0.0
    write_png_gray(str(path), mask)
    return str(path)


def test_fisheye_mask_that_does_not_load_falls_back(tmp_path):
    seq = small_dataset(tmp_path, 0.5)
    cfg = small_config(seq)
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, fisheye=True, fisheye_mask=str(tmp_path / "missing.png")))
    with pytest.warns(UserWarning, match="fisheye_mask"):
        out = t_run_euroc(str(tmp_path), config_from_jax(cfg), use_lines=False, max_frames=2,
                          device="cpu")
    assert len(out[3].metrics) == 2


def _masked_runs(tmp_path, duration, **kw):
    """Both packages' `run_euroc` (points only) over one render with the
    mask, the port fed the JAX frontend's RANSAC draws; each records its
    tracks. Returns (seq, JAX outputs, JAX tracks, port outputs, port tracks)."""
    seq = small_dataset(tmp_path / "set", duration)
    cfg = small_config(seq)
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, fisheye=True, fisheye_mask=_mask_png(tmp_path / "mask.png")))
    j_rec, t_rec = {}, {}
    jout = j_run_euroc(str(tmp_path / "set"), cfg, use_lines=False, record_tracks=j_rec, **kw)
    with pytest.MonkeyPatch.context() as mp:
        feed_jax_draws(mp, cfg.tracker.max_cnt)
        tout = t_run_euroc(str(tmp_path / "set"), config_from_jax(cfg), use_lines=False,
                           record_tracks=t_rec, device="cpu", **kw)
    assert sorted(t_rec) == sorted(j_rec)
    for rec in (j_rec, t_rec):  # nothing tracked inside the masked columns
        for t, (_, obs) in rec.items():
            assert (obs[:, 0] * F + W / 2 > MASKED_COLS - 0.5).all(), t
    return seq, jout, j_rec, tout, t_rec


def test_recorded_tracks_match_jax(tmp_path):
    """The first 3 published frames (the frontend parity tests' regime:
    detection, then tracked and refilled frames)."""
    _, _, j_rec, _, t_rec = _masked_runs(tmp_path, 1.0, max_frames=3)
    assert len(t_rec) == 3
    for t in sorted(t_rec):
        (ti, to), (ji, jo) = t_rec[t], j_rec[t]
        np.testing.assert_array_equal(ti, ji, err_msg=f"ids at t={t}")
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-3 / F, err_msg=f"obs at t={t}")


@pytest.fixture(scope="module")
def masked_run(tmp_path_factory):
    """A whole 3-s run with the mask; `burst=8` is asked for but recording
    the tracks keeps both packages streaming."""
    torch.set_num_threads(1)  # a module fixture runs before the function-scoped one
    return _masked_runs(tmp_path_factory.mktemp("masked"), 3.0, burst=8)


def test_fisheye_mask_run_matches_jax(masked_run):
    seq, (jts, jps, _, jest, _), _, (tts, tps, _, test, _), t_rec = masked_run
    assert jest.initialized and test.initialized and test.solves_since_init > 7
    assert len(t_rec) == 30
    assert not any(m.get("burst") for m in test.metrics + jest.metrics)
    gt_t, gt_p = seq.frame_t.numpy(), seq.gt_p.numpy()
    j_ate = ate_rmse(jts, jps, gt_t, gt_p, align="yaw")
    t_ate = ate_rmse(tts, tps, gt_t, gt_p, align="yaw")
    assert j_ate < 0.4 and t_ate < 0.4, (j_ate, t_ate)
    assert abs(t_ate - j_ate) < 0.05, (j_ate, t_ate)


def test_recorded_tracks_match_jax_over_the_run(masked_run):
    _, _, j_rec, _, t_rec = masked_run
    times = sorted(t_rec)
    part = next((k for k, t in enumerate(times) if not np.array_equal(t_rec[t][0], j_rec[t][0])),
                len(times))
    assert part >= 5, f"the recorded ids part at t = {times[part]}"
    issued = set()  # ids both packages issued before the ids part
    for t in times[:part]:
        issued.update(t_rec[t][0].tolist())
    tol = 1e-3 / F
    for t in times:
        (ti, to), (ji, jo) = t_rec[t], j_rec[t]
        shared, it, ij = np.intersect1d(ti, ji, return_indices=True)
        assert len(shared) >= 0.8 * max(len(ti), len(ji)), (t, len(shared), len(ti), len(ji))
        early = np.isin(shared, list(issued))
        np.testing.assert_allclose(to[it[early]], jo[ij[early]], rtol=0, atol=tol,
                                   err_msg=f"obs of the ids issued before the part at t={t}")
        near = np.abs(to[:, None, :] - jo[None, :, :]).max(axis=-1).min(axis=1) < tol
        assert near.mean() >= 0.95, (t, near.mean())
