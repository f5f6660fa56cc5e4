"""Port parity, the line frontend and the slice with lines:
`plslam_torch/models/frontend_lines.py` against `plslam/models/frontend_lines.py`
on the drawn-line scenes of `test_frontend.py`, then both packages'
`run_euroc(use_lines=True, line_desc="binary")` on one rendered dataset, and
the port's own configuration against the JAX package's.

Tolerances (float64 unless a case says float32):
  * `edge_map`: magnitudes and angles 1e-10, the edge mask exact (the same
    float64 stencil arithmetic; only a mean is summed in another order);
  * `detect_segments`, `merge_candidates`: the same valid set, endpoints and
    scores 1e-8 (sums over a tile's pixels in another order);
  * `lbd_descriptors` 1e-10 (bilinear samples and band statistics);
  * `binarize_lbd`: bit-exact against the JAX uint32 words;
  * `match_lbd`, `match_lbd_binary`: identical indices, also on inputs built
    to tie (duplicated descriptors: the lower index wins in both);
  * two `FrontendLines` ticks (and a third on a shared half-resolution
    octave), both descriptor modes: identical ids, segments 1e-8;
  * float32: at least 90 % of the valid segments within 0.5 px of the JAX
    ones — the Hough weights are rounded through bfloat16 in both packages
    and summed in another order, so near-tied peaks may flip;
  * the rendered `run_euroc` with binary lines: both initialize, solve lines,
    and their ATEs are within 0.015 m. Both track with `lk_track_fast`'s
    formulation but draw different RANSAC samples, as in
    `test_torch_slice.py`; they were 0.0112 m apart (JAX 0.0535 m, port
    0.0424 m, one run on a CPU; 0.0065 m apart while the port tracked with
    the Pallas kernel's formulation). The limit lies below the 0.032 m by
    which binary lines raise the reference's ATE on this render over points
    only (0.0213 m), so a port whose lines changed nothing (0.0289 m points
    only), or did twice the reference's harm, fails;
  * the port's `Estimator` fed every call the JAX run made into its own
    (IMU samples, point tracks, binary-line ids and segments): the same
    points and lines solved on every frame, costs within 1e-6 relative,
    poses within 1e-6 m (float64 on the same inputs: only summation order
    differs; 1.4e-10 m seen);
  * configuration: every dataclass, field and default equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plslam.config as jconfig
import plslam_torch.config as tconfig
from plslam.eval.metrics import ate_rmse
from plslam.models import estimator as jestimator
from plslam.models import frontend_lines as jfl
from plslam.models import frontend_points as jfp
from plslam.ops.cameras import PinholeRadTan as JCam
from plslam.runner import run_euroc as j_run_euroc
from plslam_torch.convert import config_from_jax
from plslam_torch.models import frontend_lines as tfl
from plslam_torch.models.estimator import Estimator as TEstimator
from plslam_torch.ops.cameras import PinholeRadTan as TCam
from plslam_torch.runner import run_euroc as t_run_euroc
from test_frontend import draw_lines, shift_image
from test_torch_slice import small_config, small_dataset

SEGS = [(40, 40, 200, 60), (260, 30, 250, 200), (60, 180, 280, 150), (20, 222, 300, 212),
        (150, 10, 172, 228)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(seed=3, dx=0.0, dy=0.0):
    rng = np.random.default_rng(seed)
    img = draw_lines(SEGS) + rng.standard_normal((240, 320)).astype(np.float32) * 0.01
    return shift_image(img, dx, dy) if dx or dy else img


def _jt(x, jdt=jnp.float64, tdt=torch.float64):
    """The same numpy array as a JAX and a torch array of the given type."""
    return jnp.asarray(np.asarray(x), jdt), torch.tensor(np.asarray(x)).to(tdt)


def _detect(img, jdt=jnp.float64, tdt=torch.float64, max_out=32):
    ji, ti = _jt(img, jdt, tdt)
    j = jfl.detect_segments(*jfl.edge_map(ji), *img.shape, max_out=max_out)
    t = tfl.detect_segments(*tfl.edge_map(ti), *img.shape, max_out=max_out)
    return [np.array(a) for a in j], [a.numpy() for a in t]


def test_edge_map_matches_jax():
    ji, ti = _jt(_scene())
    j = [np.asarray(a) for a in jfl.edge_map(ji)]
    t = [a.numpy() for a in tfl.edge_map(ti)]
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-10)  # magnitude
    np.testing.assert_allclose(t[1], j[1], rtol=0, atol=1e-10)  # orientation
    np.testing.assert_array_equal(t[2], j[2])  # edge mask
    assert t[2].sum() > 1000


def test_detect_and_merge_match_jax():
    img = _scene()
    (js, jsc, jv), (ts, tsc, tv) = _detect(img)
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() >= 5
    np.testing.assert_allclose(ts[tv], js[jv], rtol=0, atol=1e-8)
    np.testing.assert_allclose(tsc[tv], jsc[jv], rtol=1e-12, atol=1e-8)
    # a second octave (blurred + decimated by both packages' own code), merged
    half = np.asarray(jfp._sep_conv(jnp.asarray(img, jnp.float64),
                                    jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0))[::2, ::2]
    (js2, jsc2, jv2), (ts2, tsc2, tv2) = _detect(half)
    np.testing.assert_array_equal(tv2, jv2)
    jm = jfl.merge_candidates(jnp.concatenate([js, 2 * js2]), jnp.concatenate([jsc, 2 * jsc2]),
                              jnp.concatenate([jv, jv2]), max_out=32)
    tm = tfl.merge_candidates(torch.cat([torch.as_tensor(ts), 2 * torch.as_tensor(ts2)]),
                              torch.cat([torch.as_tensor(tsc), 2 * torch.as_tensor(tsc2)]),
                              torch.cat([torch.as_tensor(tv), torch.as_tensor(tv2)]), max_out=32)
    jm, tm = [np.asarray(a) for a in jm], [a.numpy() for a in tm]
    np.testing.assert_array_equal(tm[2], jm[2])
    np.testing.assert_allclose(tm[0][tm[2]], jm[0][jm[2]], rtol=0, atol=1e-8)
    np.testing.assert_allclose(tm[1], jm[1], rtol=1e-12, atol=1e-8)


def _descriptors(img, segs, valid):
    ji, ti = _jt(img)
    jd = jfl.lbd_descriptors(*jfl._scharr(ji), jnp.asarray(segs), jnp.asarray(valid, jnp.float64))
    td = tfl.lbd_descriptors(*tfl._scharr(ti), torch.as_tensor(segs),
                             torch.as_tensor(valid, dtype=torch.float64))
    return np.array(jd), td


def test_lbd_and_binarize_match_jax():
    img = _scene()
    (js, _, jv), _ = _detect(img)
    # detected segments, hand-placed ones leaving the image, an invalid row
    extra = np.array([[-20.0, 5.0, 100.0, 3.0], [300.0, 100.0, 330.0, 260.0], [0, 0, 0, 0]])
    segs = np.concatenate([js, extra])
    valid = np.concatenate([jv, [True, True, False]])
    jd, td = _descriptors(img, segs, valid)
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(tfl._LBD_PA, jfl._LBD_PA)
    np.testing.assert_array_equal(tfl._LBD_PB, jfl._LBD_PB)
    jb = np.asarray(jfl.binarize_lbd(jnp.asarray(jd)))  # uint32 words (uint64 under x64)
    tb = tfl.binarize_lbd(torch.as_tensor(jd))  # int32 carrying the same bits
    assert tb.dtype == torch.int32 and jb.max() < 2 ** 32
    np.testing.assert_array_equal(tb.numpy().view(np.uint32), jb)
    assert (jb[valid] >= 2 ** 31).any()  # the sign bit is exercised


def _match_inputs(ties: bool):
    """Descriptors + segments of a frame and of its shifted copy; with
    `ties`, frame 2 repeats rows so that minima tie."""
    img1, img2 = _scene(), _scene(dx=4.0, dy=2.0)
    (s1, _, v1), _ = _detect(img1)
    (s2, _, v2), _ = _detect(img2)
    d1, _ = _descriptors(img1, s1, v1)
    d2, _ = _descriptors(img2, s2, v2)
    if ties:
        n = int(v2.sum())
        for dst, src in ((n, 0), (n + 1, 1), (n + 2, 0)):
            d2[dst], s2[dst], v2[dst] = d2[src], s2[src] + 0.5, True
    return d1, s1, v1.astype(np.float64), d2, s2, v2.astype(np.float64)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("binary", [False, True])
def test_match_lbd_matches_jax(binary, ties):
    d1, s1, v1, d2, s2, v2 = _match_inputs(ties)
    if binary:
        d1 = np.asarray(jfl.binarize_lbd(jnp.asarray(d1))).astype(np.uint32)
        d2 = np.asarray(jfl.binarize_lbd(jnp.asarray(d2))).astype(np.uint32)
        jm = jfl.match_lbd_binary(*map(jnp.asarray, (d1, s1, v1, d2, s2, v2)))
        tm = tfl.match_lbd_binary(torch.from_numpy(d1.view(np.int32)), torch.as_tensor(s1),
                                  torch.as_tensor(v1), torch.from_numpy(d2.view(np.int32)),
                                  torch.as_tensor(s2), torch.as_tensor(v2))
    else:
        jm = jfl.match_lbd(*map(jnp.asarray, (d1, s1, v1, d2, s2, v2)))
        tm = tfl.match_lbd(*map(torch.as_tensor, (d1, s1, v1, d2, s2, v2)))
    jm = np.asarray(jm)
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert (jm >= 0).sum() >= 3


def test_match_binary_ties_go_to_the_lower_index():
    """Equal Hamming rows: both argmins take the first, as `jnp.argmin` does."""
    words = np.random.default_rng(5).integers(0, 2 ** 32, (4, 8), dtype=np.uint32)
    d2 = words[[0, 1, 0, 2]]  # rows 0 and 2 tie for every query
    segs = np.tile([[10.0, 10.0, 60.0, 12.0]], (4, 1))
    v = np.ones(4)
    jm = np.asarray(jfl.match_lbd_binary(*map(jnp.asarray, (words, segs, v, d2, segs, v))))
    tm = tfl.match_lbd_binary(torch.from_numpy(words.view(np.int32)), torch.as_tensor(segs),
                              torch.as_tensor(v), torch.from_numpy(d2.view(np.int32)),
                              torch.as_tensor(segs), torch.as_tensor(v))
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert tm[0] == 0


@pytest.mark.parametrize("binary", [False, True])
def test_frontend_lines_ticks_match_jax(binary):
    """Three ticks: a frame, its shifted copy, then a third frame given a
    shared half-resolution octave (the runner's point-pyramid level 1)."""
    img1, img2, img3 = _scene(), _scene(dx=4.0, dy=2.0), _scene(dx=6.5, dy=3.0)
    oct1 = np.asarray(jfp.build_pyramid(jnp.asarray(img3, jnp.float64), levels=2)[1])
    cam = (300.0, 300.0, 160.0, 120.0)
    jfe = jfl.FrontendLines(JCam.create(*cam, dtype=jnp.float64), max_lines=32, dtype=jnp.float64,
                            binary_desc=binary, pallas=False)
    tfe = tfl.FrontendLines(TCam.create(*cam, dtype=torch.float64), max_lines=32,
                            dtype=torch.float64, binary_desc=binary, device="cpu")
    seen = []
    for k, (img, oct1_k) in enumerate(((img1, None), (img2, None), (img3, oct1))):
        j = jfe.process(img, 0.05 * k, oct1=oct1_k)
        t = tfe.process(img, 0.05 * k, oct1=None if oct1_k is None else torch.as_tensor(oct1_k))
        np.testing.assert_array_equal(t[0], j[0])  # ids
        np.testing.assert_allclose(t[1], j[1], rtol=0, atol=1e-8)  # normalized segments
        seen.append(set(t[0].tolist()))
    assert len(seen[0] & seen[1]) >= 3 and len(seen[1] & seen[2]) >= 3  # lines tracked


def test_detect_float32_close_to_jax():
    """float32 (bfloat16 Hough weights in both packages): ≥ 90 % of the JAX
    valid segments have a port segment within 0.5 px."""
    img = _scene(seed=4)
    (js, _, jv), (ts, _, tv) = _detect(img, jnp.float32, torch.float32, max_out=48)
    js, ts = js[jv].astype(np.float64), ts[tv].astype(np.float64)
    assert len(js) >= 5 and abs(len(ts) - len(js)) <= max(1, len(js) // 10)
    d = np.abs(js[:, None, :] - ts[None, :, :]).max(axis=-1).min(axis=1)
    assert (d < 0.5).mean() >= 0.9, d


@pytest.fixture(scope="module")
def binary_run(tmp_path_factory):
    """The 5-s 320×240 render, its configuration with binary lines, the JAX
    `run_euroc` over it, and every call that run made into its estimator."""
    path = tmp_path_factory.mktemp("render")
    seq = small_dataset(path, 5.0)
    cfg = small_config(seq)
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, line_desc="binary"))
    calls = []
    process_imu, process_frame = jestimator.Estimator.process_imu, jestimator.Estimator.process_frame

    def imu(self, dt, acc, gyr):
        calls.append(("imu", dt, np.array(acc), np.array(gyr)))
        return process_imu(self, dt, acc, gyr)

    def frame(self, t, *obs, **kw):
        calls.append(("frame", t, *(None if a is None else np.array(a) for a in obs)))
        return process_frame(self, t, *obs, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jestimator.Estimator, "process_imu", imu)
        mp.setattr(jestimator.Estimator, "process_frame", frame)
        out = j_run_euroc(str(path), cfg, use_lines=True, loop_closure=False)
    return path, seq, cfg, out, calls


def test_run_euroc_with_binary_lines_matches_jax(binary_run):
    path, seq, cfg, (jts, jps, _, jest, _), _ = binary_run
    gt_t, gt_p = seq.frame_t.numpy(), seq.gt_p.numpy()
    tts, tps, _, test, _ = t_run_euroc(str(path), config_from_jax(cfg), use_lines=True,
                                       loop_closure=False, device="cpu")
    assert jest.initialized and test.initialized
    assert len(tts) > 20 and len(jts) > 20
    assert max(m.get("n_lines", 0) for m in test.metrics) > 0
    assert max(m.get("n_lines", 0) for m in jest.metrics) > 0
    j_ate = ate_rmse(jts, jps, gt_t, gt_p, align="yaw")
    t_ate = ate_rmse(tts, tps, gt_t, gt_p, align="yaw")
    assert j_ate < 0.4 and t_ate < 0.4, (j_ate, t_ate)
    assert abs(t_ate - j_ate) < 0.015, (j_ate, t_ate)


def test_estimator_with_lines_matches_jax_on_its_inputs(binary_run):
    """The port's estimator replays the JAX run's inputs, lines included:
    the same solves frame by frame, so what the line frontends feed the
    solve is all that can set the two packages' trajectories apart."""
    _, _, cfg, (jts, jps, _, jest, _), calls = binary_run
    est = TEstimator(config_from_jax(cfg), device="cpu")
    ts, ps = [], []
    for kind, *args in calls:
        if kind == "imu":
            est.process_imu(*args)
            continue
        m = est.process_frame(*args, defer_solve=False)
        est.finalize()
        if "cost" in m and not m.get("failure") and est.initialized:
            t, p, _ = est.latest_pose()
            ts.append(t)
            ps.append(p)
    assert len(est.metrics) == len(jest.metrics)
    assert sum(m.get("n_lines", 0) for m in jest.metrics) > 0
    for k, (a, b) in enumerate(zip(jest.metrics, est.metrics)):
        assert (b.get("n_pts"), b.get("n_lines")) == (a.get("n_pts"), a.get("n_lines")), k
        if "cost" in a:
            assert b["cost"] == pytest.approx(a["cost"], rel=1e-6), k
    np.testing.assert_allclose(ts, jts, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ps, jps, rtol=0, atol=1e-6)


def test_config_matches_jax():
    """The port's copy of the configuration: the same classes, fields and
    defaults, and `config_from_jax` carries every value across."""
    names = [n for n, v in vars(jconfig).items()
             if dataclasses.is_dataclass(v) and v.__module__ == jconfig.__name__]
    assert len(names) == 8
    def spec(cls):
        return [(f.name, dataclasses.asdict(f.default) if dataclasses.is_dataclass(f.default)
                 else f.default) for f in dataclasses.fields(cls)]

    for name in names:
        assert spec(getattr(tconfig, name)) == spec(getattr(jconfig, name)), name
    assert dataclasses.asdict(tconfig.PLSlamConfig()) == dataclasses.asdict(jconfig.PLSlamConfig())
    cfg = jconfig.PLSlamConfig(tracker=jconfig.TrackerConfig(max_lines=12, line_desc="binary"),
                               solver=jconfig.SolverConfig(dtype="float64"))
    out = config_from_jax(cfg)
    assert type(out) is tconfig.PLSlamConfig and type(out.tracker) is tconfig.TrackerConfig
    assert dataclasses.asdict(out) == dataclasses.asdict(cfg)
