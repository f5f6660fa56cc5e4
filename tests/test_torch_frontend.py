"""Port parity, point frontend: the plain LK (the CPU side of the Hopper LK
kernel) against the Pallas kernel in interpret mode, the pyramid,
Shi-Tomasi detection, F-RANSAC on shared Gumbel draws, and one whole
`FrontendPoints` tick — `plslam_torch` against `plslam`.

Tolerances:
  * LK positions 1e-3 px where both trackers report status true; status
    identical except where err lies within 1e-4 of the 0.12 gate. Both run
    the same float32 bilinear / Gauss-Newton arithmetic, summed in another
    order.
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


@pytest.mark.parametrize("seed,dx,dy", [(3, 3.7, -2.3), (5, 2.6, 3.1)])
def test_lk_plain_matches_pallas(seed, dx, dy):
    """On the shifted-texture fixtures of test_kernels, with features near
    every border (where the (8,128) padding and top-left clamp matter)."""
    img1, img2 = _pair(seed, dx, dy)
    jp, tp = _pyramids(img1, img2)
    uv, score = jfp.shi_tomasi_grid(jnp.asarray(img1), jnp.zeros((1, 2), jnp.float32),
                                    jnp.zeros((1,), jnp.float32), cell=24, max_out=40)
    uv = np.asarray(uv)[np.asarray(score) > 1e-5][:24]
    border = np.array([[4.2, 120.3], [316.7, 60.1], [160.5, 2.6], [200.4, 237.2],
                       [11.3, 11.8], [309.1, 229.4]], np.float32)
    pts = np.concatenate([uv, border]).astype(np.float32)
    valid = np.ones(len(pts), bool)

    j_out, j_st = jlk.lk_track_pallas(jp[0], jp[1], jnp.asarray(pts), jnp.asarray(valid),
                                      interpret=True)
    t_out, t_st = tlk.lk_track(tp[0], tp[1], torch.as_tensor(pts), torch.as_tensor(valid))
    j_out, j_st, t_out, t_st = np.asarray(j_out), np.asarray(j_st), t_out.numpy(), t_st.numpy()

    both = j_st & t_st
    np.testing.assert_allclose(t_out[both], j_out[both], rtol=0, atol=1e-3)
    # the last level's err, for the status comparison near the gate
    _, err = tlk.lk_level_torch(tp[0][0], tp[1][0], torch.as_tensor(pts),
                                torch.as_tensor(t_out), iters=0)
    near_gate = np.abs(err.numpy() - ERR_GATE) < 1e-4
    np.testing.assert_array_equal(t_st[~near_gate], j_st[~near_gate])
    # the existing bar of test_kernels: the GT flow is recovered
    sel = t_st[: len(uv)]
    flow = t_out[: len(uv)][sel] - uv[sel]
    assert sel.sum() >= len(uv) * 0.7
    assert np.median(np.linalg.norm(flow - np.array([dx, dy]), axis=1)) < 0.3


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


def test_frontend_tick_matches_jax(monkeypatch):
    """Two `FrontendPoints` frames (detect, then a full tick) through both
    packages, the JAX one tracking with the Pallas kernel in interpret mode
    and both RANSACs on the same Gumbel draws: ids exact."""
    import functools

    monkeypatch.setattr(jlk, "lk_track_pallas",
                        functools.partial(jlk.lk_track_pallas, interpret=True))
    img1, img2 = _pair(7, 2.2, -1.4)
    kw = dict(max_cnt=40, min_dist=24, min_score=1e-4, focal=200.0)
    jfe = jfp.FrontendPoints(JCam.create(200.0, 200.0, 160.0, 120.0), use_pallas=True, **kw)
    tfe = tfp.FrontendPoints(TCam.create(200.0, 200.0, 160.0, 120.0), device="cpu", **kw)
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
