"""Port parity, point frontend: the plain LK versions (the CPU side of the
Hopper LK kernel) against the JAX trackers — the `"fast"` formulation
against `lk_track_fast` (the JAX default), the `"pallas"` one against the
Pallas kernel in interpret mode — the pyramid, Shi-Tomasi detection,
F-RANSAC on shared Gumbel draws, and whole `FrontendPoints` ticks with
either tracker — `plslam_torch` against `plslam`.

Tolerances:
  * LK positions 1e-3 px where both trackers report status true; status
    identical except where err lies within 1e-4 of the 0.12 gate. Both run
    the same float32 bilinear / Gauss-Newton arithmetic, summed in another
    order (`lk_track_fast` blends through one-hot matmuls, the port
    directly from the window).
  * pyramid 1e-6 absolute on [0,1] images, Shi-Tomasi scores 1e-6 (float32
    matmul / box-filter summation order); detected corners and the RANSAC
    inlier mask exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.models import frontend_points as jfp
from plslam.ops.cameras import PinholeRadTan as JCam
from plslam.ops.kernels import lk as jlk
from plslam_torch.models import frontend_points as tfp
from plslam_torch.ops.cameras import PinholeRadTan as TCam
from plslam_torch.ops.kernels import lk as tlk
from test_frontend import shift_image, smooth_texture

ERR_GATE = 0.12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(seed, dx, dy):
    rng = np.random.default_rng(seed)
    img1 = smooth_texture(rng)
    return img1, shift_image(img1, dx, dy)


def _pyramids(img1, img2):
    lv = jfp.auto_levels(img1.shape)
    jp = [jfp.build_pyramid(jnp.asarray(i), levels=lv) for i in (img1, img2)]
    tp = [tfp.build_pyramid(torch.as_tensor(i), levels=lv) for i in (img1, img2)]
    return jp, tp


def test_build_pyramid_matches_jax():
    img1, _ = _pair(3, 0.0, 0.0)
    jp, tp = _pyramids(img1, img1)
    assert len(tp[0]) == len(jp[0]) == 3
    for a, b in zip(tp[0], jp[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_shi_tomasi_matches_jax():
    img1, _ = _pair(4, 0.0, 0.0)
    occ = np.array([[100.0, 100.0], [37.5, 200.2], [-3.0, 5.0]], np.float32)
    occ_v = np.array([1.0, 1.0, 0.0], np.float32)
    ju, js = jfp.shi_tomasi_grid(jnp.asarray(img1), jnp.asarray(occ), jnp.asarray(occ_v),
                                 cell=24, max_out=60)
    tu, ts = tfp.shi_tomasi_grid(torch.as_tensor(img1), torch.as_tensor(occ),
                                 torch.as_tensor(occ_v), cell=24, max_out=60)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


BORDER = np.array([[4.2, 120.3], [316.7, 60.1], [160.5, 2.6], [200.4, 237.2],
                   [11.3, 11.8], [309.1, 229.4]], np.float32)


def _lk_case(seed, dx, dy):
    """The shifted-texture pair, both packages' pyramids, and the detector's
    corners followed by points near every border."""
    img1, img2 = _pair(seed, dx, dy)
    jp, tp = _pyramids(img1, img2)
    uv, score = jfp.shi_tomasi_grid(jnp.asarray(img1), jnp.zeros((1, 2), jnp.float32),
                                    jnp.zeros((1,), jnp.float32), cell=24, max_out=40)
    uv = np.asarray(uv)[np.asarray(score) > 1e-5][:24]
    pts = np.concatenate([uv, BORDER]).astype(np.float32)
    return jp, tp, uv, pts, np.ones(len(pts), bool)


def _check_lk(j, t, t_err, uv, dx, dy, min_tracked=0.7):
    """Positions 1e-3 px where both track, status equal away from the err
    gate, and the existing bar of test_kernels: the GT flow is recovered."""
    (j_out, j_st), (t_out, t_st) = ((np.asarray(a), np.asarray(b)) for a, b in (j, t))
    both = j_st & t_st
    np.testing.assert_allclose(t_out[both], j_out[both], rtol=0, atol=1e-3)
    near_gate = np.abs(np.asarray(t_err) - ERR_GATE) < 1e-4
    np.testing.assert_array_equal(t_st[~near_gate], j_st[~near_gate])
    sel = t_st[: len(uv)]
    flow = t_out[: len(uv)][sel] - uv[sel]
    assert sel.sum() >= len(uv) * min_tracked
    assert np.median(np.linalg.norm(flow - np.array([dx, dy]), axis=1)) < 0.3


@pytest.mark.parametrize("seed,dx,dy", [(3, 3.7, -2.3), (5, 2.6, 3.1)])
def test_lk_plain_matches_pallas(seed, dx, dy):
    """The `"pallas"` formulation on the shifted-texture fixtures of
    test_kernels, with features near every border (where the (8,128)
    padding and top-left clamp matter)."""
    jp, tp, uv, pts, valid = _lk_case(seed, dx, dy)
    j = jlk.lk_track_pallas(jp[0], jp[1], jnp.asarray(pts), jnp.asarray(valid), interpret=True)
    t_out, t_st, t_err = tlk.lk_track(tp[0], tp[1], torch.as_tensor(pts), torch.as_tensor(valid),
                                      formulation="pallas")
    _check_lk(j, (t_out, t_st), t_err, uv, dx, dy)


@pytest.mark.parametrize("seed,dx,dy", [(3, 3.7, -2.3), (5, 2.6, 3.1), (9, 16.6, -3.1)])
def test_lk_fast_plain_matches_jax(seed, dx, dy):
    """`lk_track`'s default, the `"fast"` formulation, against the JAX
    default `lk_track_fast` on the same fixtures. The border points start
    outside their clipped search windows, so the guess is clamped to
    [lo, hi]; the third case moves 16.6 px, more than the coarsest level's
    window lets the guess move (LK_MARGIN px at scale 4), so the clamp binds
    there and the finer levels take the rest. Features that the shift
    carries across the image edge are lost in both packages there (14 of
    24 tracked), so that case asks half of them."""
    jp, tp, uv, pts, valid = _lk_case(seed, dx, dy)
    j = jfp.lk_track_fast(jp[0], jp[1], jnp.asarray(pts), jnp.asarray(valid))
    t_out, t_st, t_err = tlk.lk_track(tp[0], tp[1], torch.as_tensor(pts), torch.as_tensor(valid))
    beyond_margin = abs(dx) / 2 ** (len(tp[0]) - 1) > tlk.LK_MARGIN
    assert beyond_margin == (seed == 9)
    _check_lk(j, (t_out, t_st), t_err, uv, dx, dy, min_tracked=0.5 if beyond_margin else 0.7)


def test_fundamental_ransac_same_draws():
    """The same Gumbel array fed to both packages gives the same inliers."""
    rng = np.random.default_rng(3)
    n = 60
    pts = rng.uniform(-1, 1, (n, 3)) * [2, 2, 1] + [0, 0, 6]
    t = np.array([0.3, 0.05, 0.0])
    p1 = pts[:, :2] / pts[:, 2:3]
    pc2 = pts + t
    p2 = pc2[:, :2] / pc2[:, 2:3]
    bad = rng.choice(n, 10, replace=False)
    p2[bad] += rng.uniform(0.05, 0.1, (10, 2)) * rng.choice([-1, 1], (10, 2))
    valid = np.ones(n, bool)
    valid[[3, 17]] = False
    key = jax.random.PRNGKey(1)
    gumbel = np.asarray(jax.random.gumbel(key, (100, n), jnp.float64))
    j_inl = np.asarray(jfp.fundamental_ransac(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                              2.0 / 460.0, key=key))
    t_inl = tfp.fundamental_ransac(torch.as_tensor(p1), torch.as_tensor(p2), torch.as_tensor(valid),
                                   2.0 / 460.0, gumbel=torch.as_tensor(gumbel)).numpy()
    np.testing.assert_array_equal(t_inl, j_inl)
    assert t_inl[bad].sum() <= 3 and t_inl.sum() > 40


def _two_ticks(jfe, tfe):
    """Two frames (detect, then a full tick) through both frontends, both
    RANSACs on the same Gumbel draws: ids exact, uv 1e-3 px."""
    img1, img2 = _pair(7, 2.2, -1.4)
    for k, img in enumerate((img1, img2)):
        gumbel = np.asarray(jax.random.gumbel(jax.random.fold_in(jfe._key, k), (100, 40),
                                              jnp.float32))
        j = jfe.process(img, 0.05 * k)
        t = tfe.process(img, 0.05 * k, gumbel=torch.as_tensor(gumbel))
        np.testing.assert_array_equal(t[0], j[0])  # ids
        np.testing.assert_allclose(t[3], j[3], rtol=0, atol=1e-3)  # pixel uv
        np.testing.assert_allclose(t[1], j[1], rtol=0, atol=1e-3 / 200.0)  # normalized
        np.testing.assert_allclose(t[2], j[2], rtol=0, atol=2e-3 / 200.0 / 0.05)  # velocity
        np.testing.assert_array_equal(tfe.track_cnt, jfe.track_cnt)
    assert (tfe.track_cnt[tfe.prev_valid] >= 2).sum() > 10  # most features tracked


FRONTEND_KW = dict(max_cnt=40, min_dist=24, min_score=1e-4, focal=200.0)


def test_frontend_tick_matches_jax(monkeypatch):
    """`tracker="pallas"` against JAX's `use_pallas=True`, the Pallas kernel
    in interpret mode."""
    import functools

    monkeypatch.setattr(jlk, "lk_track_pallas",
                        functools.partial(jlk.lk_track_pallas, interpret=True))
    jfe = jfp.FrontendPoints(JCam.create(200.0, 200.0, 160.0, 120.0), use_pallas=True,
                             **FRONTEND_KW)
    tfe = tfp.FrontendPoints(TCam.create(200.0, 200.0, 160.0, 120.0), tracker="pallas",
                             device="cpu", **FRONTEND_KW)
    _two_ticks(jfe, tfe)


def test_frontend_default_tick_matches_jax_default():
    """Both packages' default trackers: the port's `"fast"` formulation
    against JAX's `lk_track_fast` (`use_pallas=False`)."""
    jfe = jfp.FrontendPoints(JCam.create(200.0, 200.0, 160.0, 120.0), **FRONTEND_KW)
    tfe = tfp.FrontendPoints(TCam.create(200.0, 200.0, 160.0, 120.0), device="cpu", **FRONTEND_KW)
    assert not jfe.use_pallas and tfe.tracker == "fast"
    _two_ticks(jfe, tfe)
