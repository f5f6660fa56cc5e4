"""Port parity, the device feature tables (`plslam_torch/models/device_table.py`):
`tests/test_device_table.py`'s three cases run through the JAX package's
`device_table` functions, the port's, and the port's host tables on the same
inputs (float64).

Tolerances: every integer output (ids, starts, masks, the keyframe flag)
equal to JAX's exactly, slot for slot; observations and velocities within
1e-12 of JAX's (the same float64 arithmetic), depths within 1e-6 (the
port transfers them with the host table's rotation formula, 1 − 2(y² + z²)
on the diagonal; the test's anchor quaternion is unit only to 5e-7, where
JAX's w² + x² − y² − z² differs by as much); everything within 1e-6 of
the port's host table, slot for slot by id (the JAX test's own bound), and
depths within 1e-12 of it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.models import device_table as jdt
from plslam_torch.config import SolverConfig
from plslam_torch.models import device_table as tdt
from plslam_torch.models.feature_table import LineTable, PointTable

CFG = SolverConfig(max_features=24, max_line_feats=12)
NW = CFG.window_size + 1


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rand_frame(rng, pool, n):
    ids = rng.choice(pool, size=min(n, len(pool)), replace=False)
    return ids, rng.standard_normal((len(ids), 2)) * 0.3, rng.standard_normal((len(ids), 2)) * 0.05


def _pad(ids, cols, cap):
    """(ids [cap] int32 with -1 padding, each array of `cols` zero-padded to
    [cap,...], valid [cap]) as numpy."""
    fid = np.full(cap, -1, np.int32)
    fid[: len(ids)] = ids
    out = []
    for c in cols:
        a = np.zeros((cap,) + c.shape[1:])
        a[: len(ids)] = c
        out.append(a)
    val = np.zeros(cap, bool)
    val[: len(ids)] = True
    return fid, out, val


class Pair:
    """A JAX and a port device table advanced through the same calls."""

    def __init__(self, j, t):
        self.j, self.t = j, t

    def apply(self, jfn, tfn, *args):
        self.j = jfn(self.j, *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
        self.t = tfn(self.t, *[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                               for a in args])

    def check(self):
        for name in self.t._fields:
            a, b = getattr(self.t, name).numpy(), np.asarray(getattr(self.j, name))
            if name in ("ids", "start", "mask"):
                assert a.dtype == (np.int32 if name != "mask" else np.float64), (name, a.dtype)
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                tol = 1e-6 if name == "inv_depth" else 1e-12
                np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def _assert_matches_host(host, dev, with_vel=True):
    """The device table equals the host table up to the slot order."""
    h_act = np.nonzero(host.ids >= 0)[0]
    d_ids = dev.ids.numpy()
    assert sorted(host.ids[h_act]) == sorted(d_ids[d_ids >= 0])
    d_slot = {int(i): s for s, i in enumerate(d_ids) if i >= 0}
    for s in h_act:
        ds = d_slot[int(host.ids[s])]
        np.testing.assert_allclose(dev.obs[ds].numpy(), host.obs[s], atol=1e-6)
        np.testing.assert_array_equal(dev.mask[ds].numpy() > 0.5, host.mask[s])
        assert int(dev.start[ds]) == int(host.start[s])
        if with_vel:
            np.testing.assert_allclose(dev.vel[ds].numpy(), host.vel[s], atol=1e-6)
            assert float(dev.inv_depth[ds]) == pytest.approx(host.inv_depth[s], abs=1e-12)


def test_point_add_and_slides_match_jax_and_host():
    rng = np.random.default_rng(3)
    host = PointTable(CFG)
    pair = Pair(jdt.empty_point_table(CFG.max_features, NW, jnp.float64),
                tdt.empty_point_table(CFG.max_features, NW, torch.float64))
    pool = np.arange(60)
    for fc in range(NW):  # fill the window
        ids, obs, vel = _rand_frame(rng, pool[fc: fc + 30], 18)
        host.add_frame(fc, ids, obs, vel)
        fid, (fobs, fvel), val = _pad(ids, (obs, vel), CFG.max_features)
        pair.apply(jdt.pt_add_frame, tdt.pt_add_frame, fc, fid, fobs, fvel, val)
        pair.check()
    _assert_matches_host(host, pair.t)

    minp = CFG.keyframe_parallax / CFG.focal_length
    want = host.parallax_keyframe_decision(NW - 1)
    got = tdt.pt_parallax_keyframe(pair.t, NW - 1, minp)
    assert got.dtype == torch.bool and bool(got) == want
    assert bool(jdt.pt_parallax_keyframe(pair.j, NW - 1, minp)) == want

    # depths for some features, then slide_old with a real anchor change
    sel = np.nonzero(host.ids >= 0)[0][:8]
    host.inv_depth[sel] = 0.5
    d_ids = pair.t.ids.numpy()
    d_slot = {int(i): s for s, i in enumerate(d_ids) if i >= 0}
    dinv = pair.t.inv_depth.numpy().copy()
    for s in sel:
        dinv[d_slot[int(host.ids[s])]] = 0.5
    pair.j = pair.j._replace(inv_depth=jnp.asarray(dinv))
    pair.t = pair.t._replace(inv_depth=torch.as_tensor(dinv))
    p0, q0 = np.array([0.1, 0.2, 0.0]), np.array([0.99875, 0.0, 0.0499792, 0.0])
    p1, q1 = np.array([0.3, 0.1, 0.05]), np.array([1.0, 0.0, 0.0, 0.0])
    host.slide_old(p0, q0, p1, q1)
    pair.apply(jdt.pt_slide_old, tdt.pt_slide_old, p0, q0, p1, q1)
    pair.check()
    _assert_matches_host(host, pair.t)

    ids, obs, vel = _rand_frame(rng, pool[20:50], 16)
    host.add_frame(NW - 1, ids, obs, vel)
    fid, (fobs, fvel), val = _pad(ids, (obs, vel), CFG.max_features)
    pair.apply(jdt.pt_add_frame, tdt.pt_add_frame, NW - 1, fid, fobs, fvel, val)
    host.slide_new()
    pair.apply(jdt.pt_slide_new, tdt.pt_slide_new)
    pair.check()
    _assert_matches_host(host, pair.t)

    # removeFailures / removeOutlier drops
    dead = np.zeros(CFG.max_features, bool)
    dead[[1, 5, 9]] = True
    pair.apply(jdt._pt_clear_where, tdt._pt_clear_where, dead)
    pair.check()
    assert (pair.t.ids.numpy()[dead] == -1).all()


def test_point_table_overflow_drops_new():
    rng = np.random.default_rng(5)
    host = PointTable(CFG)
    pair = Pair(jdt.empty_point_table(CFG.max_features, NW, jnp.float64),
                tdt.empty_point_table(CFG.max_features, NW, torch.float64))
    ids = np.arange(40)  # more than the capacity of 24
    obs = rng.standard_normal((40, 2))
    host.add_frame(0, ids, obs, np.zeros((40, 2)))
    pair.apply(jdt.pt_add_frame, tdt.pt_add_frame, 0, ids.astype(np.int32), obs,
               np.zeros((40, 2)), np.ones(40, bool))
    pair.check()
    assert int((pair.t.ids >= 0).sum()) == CFG.max_features
    _assert_matches_host(host, pair.t)


def test_line_add_and_slides_match_jax_and_host():
    rng = np.random.default_rng(7)
    host = LineTable(CFG)
    pair = Pair(jdt.empty_line_table(CFG.max_line_feats, NW, jnp.float64),
                tdt.empty_line_table(CFG.max_line_feats, NW, torch.float64))
    pool = np.arange(30)
    cap = CFG.max_line_feats
    for fc in range(NW):
        ids = rng.choice(pool[fc: fc + 14], size=8, replace=False)
        segs = rng.standard_normal((8, 4)) * 0.3
        host.add_frame(fc, ids, segs)
        fid, (fsg,), val = _pad(ids, (segs,), cap)
        pair.apply(jdt.ln_add_frame, tdt.ln_add_frame, fc, fid, fsg, val)
        pair.check()
    _assert_matches_host(host, pair.t, with_vel=False)
    host.slide_old()
    pair.apply(jdt.ln_slide_old, tdt.ln_slide_old)
    pair.check()
    _assert_matches_host(host, pair.t, with_vel=False)
    host.slide_new()
    pair.apply(jdt.ln_slide_new, tdt.ln_slide_new)
    pair.check()
    _assert_matches_host(host, pair.t, with_vel=False)
    dead = np.zeros(cap, bool)
    dead[[0, 3]] = True
    pair.apply(jdt._ln_clear_where, tdt._ln_clear_where, dead)
    pair.check()


def test_host_round_trip():
    """`from_host_*` then `to_host_*` gives the host tables back."""
    rng = np.random.default_rng(11)
    pts, lns = PointTable(CFG), LineTable(CFG)
    for fc in range(4):
        ids, obs, vel = _rand_frame(rng, np.arange(fc, fc + 30), 18)
        pts.add_frame(fc, ids, obs, vel)
        lns.add_frame(fc, rng.choice(np.arange(fc, fc + 14), 8, replace=False),
                      rng.standard_normal((8, 4)))
    pts.inv_depth[pts.ids >= 0] = rng.uniform(0.1, 1.0, int((pts.ids >= 0).sum()))
    lns.solved[:4] = True
    line_w = rng.standard_normal((CFG.max_line_feats, 6))
    dp = tdt.from_host_point_table(pts, torch.float64)
    dl = tdt.from_host_line_table(lns, line_w, torch.float64)
    assert dp.ids.dtype == dl.ids.dtype == dp.start.dtype == torch.int32
    pts2, lns2 = PointTable(CFG), LineTable(CFG)
    tdt.to_host_point_table(pts2, tdt.DevPointTable(*[t.numpy() for t in dp]))
    lw2 = tdt.to_host_line_table(lns2, tdt.DevLineTable(*[t.numpy() for t in dl]))
    for name in ("ids", "start", "obs", "vel", "mask", "inv_depth"):
        np.testing.assert_array_equal(getattr(pts2, name), getattr(pts, name), err_msg=name)
    for name in ("ids", "start", "obs", "mask", "solved"):
        np.testing.assert_array_equal(getattr(lns2, name), getattr(lns, name), err_msg=name)
    np.testing.assert_array_equal(lw2, line_w)
