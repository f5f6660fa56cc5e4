"""The port's debug visualizer (`plslam_torch/eval/viz.py`) and
`run_euroc`'s `tracker.show_track` against the JAX package's.

`test_viz.py` runs on the port; the drawn overlays and match images equal
JAX's element for element, and the PNG files byte for byte. A small render
runs through both packages' `run_euroc` with and without `show_track`: the
same PNG names (a track overlay every 4th camera frame), and the same
relation of the trajectories. With the visualizer on, every camera frame
reads its tracks back, so that (as in JAX, which passes
`light=not want_pts`) tracked-only frames run the full tick with detection
and refill: the trajectory is not the one without it, in both packages
(1-6 cm apart on these renders). The loop match images are compared in
`test_torch_loop.py`'s pose-graph replay.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from plslam.eval import viz as jviz
from plslam.runner import run_euroc as jax_run_euroc
from plslam_torch.convert import config_from_jax
from plslam_torch.eval import viz
from plslam_torch.io.euroc import _read_png_gray
from plslam_torch.runner import run_euroc
from test_torch_burst_jax import feed_jax_draws
from test_torch_slice import small_config, small_dataset


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_track_overlay_and_match_image(tmp_path):
    """`test_viz.py` on the port."""
    rng = np.random.default_rng(0)
    img = rng.random((120, 160)).astype(np.float32)
    uv = np.array([[20.0, 30.0], [80.0, 60.0], [150.0, 110.0]])
    out = viz.draw_tracks(img, uv, track_cnt=[1, 10, 30], vel=np.ones((3, 2)) * 0.5)
    assert out.shape == img.shape
    assert out[30, 20] > img[30, 20] * 0.6 + 0.1 or out[30, 20] > 0.5
    m = viz.draw_match_image(img, uv, img, uv + 2.0)
    assert m.shape == (120, 320)
    tv = viz.TrackVisualizer(str(tmp_path), every=2)
    p1 = tv.track_frame(img, uv, [1, 2, 3])
    p2 = tv.track_frame(img, uv, [1, 2, 3])  # skipped (every=2)
    p3 = tv.match_image(img, uv, img, uv, tag="0_5")
    assert p1 is not None and p2 is None and p3 is not None
    assert _read_png_gray(p1).shape == img.shape


def _scene(seed, n=40, h=120, w=160):
    """A random image and features, some on and past the border."""
    rng = np.random.default_rng(seed)
    img = rng.random((h, w)).astype(np.float32)
    uv = np.concatenate([rng.uniform([0, 0], [w, h], (n, 2)),
                         [[-3.0, 5.0], [w - 0.5, h - 0.5], [w + 4.0, 10.0], [0.0, 0.0]]])
    return rng, img, uv


@pytest.mark.parametrize("seed,with_cnt,with_vel", [(1, True, True), (2, False, True),
                                                    (3, True, False), (4, False, False)])
def test_draw_tracks_matches_jax(seed, with_cnt, with_vel):
    rng, img, uv = _scene(seed)
    cnt = rng.integers(0, 40, len(uv)) if with_cnt else None
    vel = rng.normal(0, 2.0, uv.shape) if with_vel else None
    a = viz.draw_tracks(img, uv, cnt, vel)
    b = jviz.draw_tracks(img, uv, cnt, vel)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shapes", [((120, 160), (120, 160)), ((100, 160), (120, 140))])
def test_draw_match_image_matches_jax(shapes):
    rng = np.random.default_rng(5)
    (hc, wc), (ho, wo) = shapes
    img_cur = rng.random((hc, wc)).astype(np.float32)
    img_old = rng.random((ho, wo)).astype(np.float32)
    uv_cur = rng.uniform([0, 0], [wc, hc], (25, 2))
    uv_old = rng.uniform([0, 0], [wo, ho], (25, 2))
    np.testing.assert_array_equal(viz.draw_match_image(img_cur, uv_cur, img_old, uv_old),
                                  jviz.draw_match_image(img_cur, uv_cur, img_old, uv_old))


def test_visualizer_files_match_jax(tmp_path):
    _, img, uv = _scene(6)
    cnt = np.arange(len(uv))
    a = viz.TrackVisualizer(str(tmp_path / "t"), every=3)
    b = jviz.TrackVisualizer(str(tmp_path / "j"), every=3)
    for k in range(7):
        pa = a.track_frame(img, uv + k, cnt)
        pb = b.track_frame(img, uv + k, cnt)
        assert (pa is None) == (pb is None)
    a.match_image(img, uv, img[::-1], uv[::-1], tag="3_9")
    b.match_image(img, uv, img[::-1], uv[::-1], tag="3_9")
    names = sorted(os.listdir(tmp_path / "t" / "viz"))
    assert names == sorted(os.listdir(tmp_path / "j" / "viz"))
    assert names == ["match_3_9.png", "track_000000.png", "track_000003.png", "track_000006.png"]
    for n in names:
        assert (tmp_path / "t" / "viz" / n).read_bytes() == (tmp_path / "j" / "viz" / n).read_bytes()
    # a disabled visualizer writes nothing and makes no directory
    off = viz.TrackVisualizer(str(tmp_path / "off"), enabled=False)
    assert off.track_frame(img, uv) is None and not (tmp_path / "off").exists()


@pytest.fixture(scope="module")
def show_track_runs(tmp_path_factory):
    """One 2-s 320×240 render (40 camera frames, 20 published) through both
    packages' `run_euroc`, points only, without and with `show_track`; the
    port fed JAX's RANSAC draws. The runs with the visualizer ask for
    `burst=4`, which it turns down in both packages."""
    torch.set_num_threads(1)  # module fixtures run before the autouse one
    d = tmp_path_factory.mktemp("show_track")
    seq = small_dataset(d, 2.0)
    base = small_config(seq)
    runs, burst_log = {}, []
    for show in (False, True):
        cfg = dataclasses.replace(base, output_path=str(d / f"jax_{show}"),
                                  tracker=dataclasses.replace(base.tracker, show_track=show))
        runs["jax", show] = jax_run_euroc(str(d), cfg, use_lines=False, burst=4 * show)[:3]
        tcfg = dataclasses.replace(config_from_jax(cfg), output_path=str(d / f"port_{show}"))
        with pytest.MonkeyPatch.context() as mp:
            feed_jax_draws(mp, tcfg.tracker.max_cnt)
            runs["port", show] = run_euroc(str(d), tcfg, use_lines=False, burst=4 * show,
                                           burst_log=burst_log if show else None,
                                           device="cpu")[:3]
    return d, len(seq.frame_t), runs, burst_log


def test_show_track_writes_jax_s_images(show_track_runs):
    """The same PNG names in both packages, one a 4th camera frame; the first
    overlay (the detection frame) equal, the later ones equal but at the
    few features that one package's f32 LK drops at a threshold and the
    other's keeps (at most 0.5 % of the pixels)."""
    d, n_cam, _, _ = show_track_runs
    names = sorted(os.listdir(d / "port_True" / "viz"))
    assert names == sorted(os.listdir(d / "jax_True" / "viz"))
    assert names == [f"track_{k:06d}.png" for k in range(0, n_cam, 4)]  # ⌈frames / 4⌉
    for i, n in enumerate(names):
        a = _read_png_gray(str(d / "port_True" / "viz" / n))
        b = _read_png_gray(str(d / "jax_True" / "viz" / n))
        assert a.shape == b.shape
        assert np.mean(a != b) <= (0.0 if i == 0 else 5e-3), n
    assert not (d / "port_False").exists() and not (d / "jax_False").exists()


def test_show_track_trajectory_relation_matches_jax(show_track_runs):
    """In both packages the trajectory with the visualizer is not the one
    without it; the port's with it is JAX's with it within the slice tests'
    0.05 m (a feature that the two f32 LKs keep differently at a threshold
    moves the solve by millimetres)."""
    _, _, runs, burst_log = show_track_runs
    assert burst_log == []  # `show_track` forces streaming: no chunk ran
    for pkg in ("jax", "port"):
        (t0, p0, _), (t1, p1, _) = runs[pkg, False], runs[pkg, True]
        assert len(p1) > 5
        np.testing.assert_array_equal(t0, t1)
        assert np.abs(p1 - p0).max() > 1e-3, pkg  # the visualizer's full ticks move it
    for show in (False, True):
        (jt, jp, _), (tt, tp, _) = runs["jax", show], runs["port", show]
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=0.05)
