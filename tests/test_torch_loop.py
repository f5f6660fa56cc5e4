"""Port parity, slice D on the CPU: the keyframe database (Shi-Tomasi + BRIEF,
the global descriptor, the Hamming search, PnP RANSAC, the temporally
consistent query), the 4-DoF pose-graph solvers, a `PoseGraph` replay in
which loops fire and the PGO runs, and map files carried both ways.

Tolerances:
  * descriptors: every packed word equal, except that a BRIEF bit may
    differ where its two samples tie within 1e-5 (a float32 comparison);
    the fixtures here have no such tie, and the test reports the count;
  * global descriptors 1e-5 (float32; the projections sum integers);
  * Hamming distances, inlier masks, query returns, stats outcomes and
    matched ids exact; PnP poses 1e-9 (both numpy, same draws);
  * the 4-DoF solvers (float32 in both packages, other summation orders)
    1e-4 m and 1e-5 rad; PCG against dense 2e-3, as the JAX test holds it;
  * the replay's edges and optimized poses 1e-4.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from plslam.config import LoopConfig
from plslam.models import keyframe_db as jkdb
from plslam.models import pose_graph as jpg
from plslam.ops.cameras import PinholeRadTan as JCam
from plslam.utils import quat_np as jqnp
import loop_scene
from loop_scene import F, H, W
from plslam_torch.models import keyframe_db as tkdb
from plslam_torch.models import pose_graph as tpg
from test_frontend import smooth_texture
from test_pose_graph import make_drifting_loop


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _window_points(rng, n):
    """n window points in the 240×320 texture, the first ones within 15 px
    of the borders and corners."""
    uv = rng.uniform([0.0, 0.0], [320.0, 240.0], (n, 2))
    edge = np.array([[0.5, 0.5], [319.2, 1.0], [2.0, 239.5], [318.0, 236.0], [14.0, 120.0],
                     [160.0, 3.0], [306.0, 100.0], [40.0, 226.0]])
    m = min(n, len(edge))
    uv[:m] = edge[:m]
    return uv


@pytest.mark.parametrize("n_window", [0, 40, 100, 150])
def test_keyframe_features_match_jax(n_window):
    """`extract_keyframe_features` (corners, BRIEF, global descriptor) with
    no window points, ≤ 64 (the MAX_KP/4 bucket), ≤ 128 (MAX_KP/2) and more
    than 128 (capped), corners within 15 px of the border included."""
    rng = np.random.default_rng(7 + n_window)
    img = smooth_texture(rng)
    extra = _window_points(rng, n_window) if n_window else None
    juv, jvalid, jdesc, jg = jkdb.extract_keyframe_features(jnp.asarray(img), extra_uv=extra)
    jdesc = np.asarray(jdesc)  # uint64 words under x64: the same values
    assert jdesc.max() < 2 ** 32
    jdesc = jdesc.astype(np.uint32)
    tuv, tvalid, tdesc, tg = tkdb.extract_keyframe_features(torch.as_tensor(img), extra_uv=extra)
    np.testing.assert_array_equal(tuv, np.asarray(juv))
    np.testing.assert_array_equal(tvalid, np.asarray(jvalid))
    assert tdesc.dtype == np.uint32 and tdesc.shape == (tkdb.MAX_KP, tkdb.N_BRIEF_WORDS)
    # bits that differ must be ties of their two samples (float32 order)
    va, vb = tkdb._brief_tests(torch.as_tensor(img), torch.as_tensor(tuv))
    tbits = np.unpackbits(tdesc.view(np.uint8), bitorder="little").reshape(-1, 256)
    jbits = np.unpackbits(jdesc.view(np.uint8), bitorder="little").reshape(-1, 256)
    diff = tbits != jbits
    ties = (va - vb).abs().numpy() < 1e-5
    assert not (diff & ~ties).any()
    print(f"BRIEF bits differing at ties: {int(diff.sum())}")
    if not (ties & tvalid[:, None]).any():
        np.testing.assert_array_equal(tdesc, jdesc)
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=0, atol=1e-5)
    assert int(tvalid.sum()) > 100


def test_hamming_matrix_matches_jax_at_the_search_shape():
    """The BRIEF search's 128 × 256, exact: int32 words carrying the uint32 bits."""
    rng = np.random.default_rng(3)
    d1 = rng.integers(0, 2 ** 32, (128, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.integers(0, 2 ** 32, (256, 8), dtype=np.uint64).astype(np.uint32)
    d1[0] = 0xFFFFFFFF
    d2[0] = 0
    d2[1] = d1[1]
    want = np.asarray(jkdb.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    got = tkdb.hamming_matrix(tkdb.desc_tensor(d1), tkdb.desc_tensor(d2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tkdb.desc_words(tkdb.desc_tensor(d1)), d1)


@pytest.mark.parametrize("n_bad", [8, 20])
def test_pnp_ransac_matches_jax(n_bad):
    """The `test_pnp_ransac_with_outliers` scene (and one with more
    outliers): the same 128 draws, the same inliers and pose."""
    rng = np.random.default_rng(4)
    n = 40
    pts_w = rng.uniform(-2, 2, (n, 3)) + [0, 0, 6]
    R_gt = jqnp.ypr_to_rot(np.array([0.3, 0.1, -0.05]))
    t_gt = np.array([0.5, -0.2, 0.3])
    pc = pts_w @ R_gt.T + t_gt
    obs = pc[:, :2] / pc[:, 2:3]
    bad = rng.choice(n, n_bad, replace=False)
    obs[bad] += rng.uniform(0.05, 0.15, (n_bad, 2)) * rng.choice([-1, 1], (n_bad, 2))
    for kw in (dict(min_inliers=12), dict(min_inliers=30, return_best=True)):
        want = jkdb.pnp_ransac(pts_w, obs, **kw)
        got = tkdb.pnp_ransac(pts_w, obs, **kw)
        assert (want is None) == (got is None)
        R, t, inl = got
        np.testing.assert_array_equal(inl, want[2])
        np.testing.assert_allclose(R, want[0], rtol=0, atol=1e-9)
        np.testing.assert_allclose(t, want[1], rtol=0, atol=1e-9)
    assert tkdb.pnp_ransac(pts_w[:5], obs[:5]) is None


def _gd(place):
    """A place descriptor of `test_temporal_consistency_rejects_transient_alias`:
    distinct places near-orthogonal, neighbouring places correlated."""
    v = np.zeros(tkdb.GDESC_DIM, np.float32)
    v[place % tkdb.GDESC_DIM] = 1.0
    v[(place + 1) % tkdb.GDESC_DIM] = 0.6
    v += 0.05 * np.asarray(np.random.default_rng(place).normal(size=tkdb.GDESC_DIM), np.float32)
    return v / np.linalg.norm(v)


def test_query_sequence_matches_jax():
    """The JAX alias test's query sequence (a transient alias, a miss, a
    stale re-hit, a sustained revisit), then single-shot queries and a
    loaded-map prefix, through both databases: the same returns, `recent`
    and `last_candidates` after every query."""
    queries = [(3, dict(consistency=2)), (100, dict(consistency=2)), (3, dict(consistency=2)),
               (18, dict(consistency=2)), (18, dict(consistency=2)), (3, dict(consistency=1)),
               (25, dict(consistency=2, always_include=8)), (5, dict(consistency=2, always_include=8)),
               (7, dict(consistency=3, consistency_gap=1))]
    jdb, tdb = jkdb.KeyframeDB(64), tkdb.KeyframeDB(64)
    for s in range(30):
        jdb.add({}, _gd(s))
        tdb.add({}, _gd(s))
    returns = []
    for k, (place, kw) in enumerate(queries):
        want = jdb.query(_gd(place), exclude_last=10, **kw)
        assert tdb.query(_gd(place), exclude_last=10, **kw) == want, k
        assert tdb.recent == jdb.recent and tdb.last_candidates == jdb.last_candidates, k
        returns.append(want)
    assert returns[:6] == [None, None, None, None, 18, 3]
    assert returns[7] == 5  # a loaded-map candidate skips the consistency check


def _loop_graph(n, cap, loops, yaw_drift_total=0.15):
    """`test_pose_graph.py`'s drifting circle through both packages'
    `PoseGraph.add_keyframe`, with ground-truth loop edges (i, j) added."""
    gt_p, gt_yaw, vio_p, vio_yaw = make_drifting_loop(n, yaw_drift_total=yaw_drift_total)
    jg = jpg.PoseGraph(LoopConfig(max_keyframes=cap))
    tg = tpg.PoseGraph(LoopConfig(max_keyframes=cap), device="cpu")
    for k in range(n):
        q = jqnp.rot_to_quat(jqnp.ypr_to_rot(np.array([vio_yaw[k], 0.0, 0.0])))
        jg.add_keyframe(float(k), vio_p[k], q)
        tg.add_keyframe(float(k), vio_p[k], q)
    for i, j in loops:
        Ri = jqnp.ypr_to_rot(np.array([gt_yaw[i], 0.0, 0.0]))
        e = dict(i=i, j=j, t=Ri.T @ (gt_p[j] - gt_p[i]), yaw=gt_yaw[j] - gt_yaw[i], w=2.0, loop=1)
        jg.edges.append(dict(e))
        tg.edges.append(dict(e))
    return jg, tg


def _jax_inputs(args):
    """The port's solver inputs as the JAX solver's arrays (int32 indices)."""
    return [jnp.asarray(a.numpy().astype(np.int32) if a.dtype == torch.int64 else a.numpy())
            for a in args]


@pytest.mark.parametrize("n,cap,loops", [(40, 64, [(0, 39)]), (80, 128, [(0, 39), (5, 79)])])
def test_optimize_4dof_matches_jax(n, cap, loops):
    """The dense solver on the JAX tests' loop graphs (float32 in both)."""
    jg, tg = _loop_graph(n, cap, loops, yaw_drift_total=0.2 if n == 80 else 0.15)
    assert len(tg.edges) == len(jg.edges)
    for a, b in zip(tg.edges, jg.edges):
        assert (a["i"], a["j"], a["w"], a["loop"]) == (b["i"], b["j"], b["w"], b["loop"])
        np.testing.assert_allclose(a["t"], b["t"], rtol=0, atol=1e-12)
    K = max(64, 1 << (n - 1).bit_length())
    args = tg.pgo_inputs(K, 1 << (len(tg.edges) - 1).bit_length())
    xyz, yaw, costs = tpg.optimize_4dof(*args, iters=25)
    jxyz, jyaw, jcosts = jpg.optimize_4dof(*_jax_inputs(args), iters=25)
    np.testing.assert_allclose(xyz.numpy()[:n], np.asarray(jxyz)[:n], rtol=0, atol=1e-4)
    np.testing.assert_allclose(yaw.numpy()[:n], np.asarray(jyaw)[:n], rtol=0, atol=1e-5)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-3, atol=1e-6)
    # through `PoseGraph.optimize` (its buckets, float32), then the drift
    jg.optimize(iters=25)
    tg.optimize(iters=25)
    np.testing.assert_allclose(tg.opt_p[:n], jg.opt_p[:n], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tg.opt_yaw[:n], jg.opt_yaw[:n], rtol=0, atol=1e-5)
    p, q = tg.correct(np.array([1.0, 2.0, 0.5]), np.array([1.0, 0, 0, 0]))
    jp, jq = jg.correct(np.array([1.0, 2.0, 0.5]), np.array([1.0, 0, 0, 0]))
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-5)


@pytest.mark.parametrize("base", [0, 20])
def test_capacity_eviction_matches_jax(base):
    """Past capacity (100 keyframes into 64 slots, with an early loop edge
    and, for base 20, a loaded-map prefix) both graphs evict the same
    keyframes and rebuild the same edges (`test_capacity_eviction_keeps_
    closing_loops`, `test_eviction_preserves_loaded_map_edges`)."""
    n, cap = 100, 64
    gt_p, gt_yaw, vio_p, vio_yaw = make_drifting_loop(n)
    graphs = (jpg.PoseGraph(LoopConfig(max_keyframes=cap)),
              tpg.PoseGraph(LoopConfig(max_keyframes=cap), device="cpu"))
    for k in range(n):
        q = jqnp.rot_to_quat(jqnp.ypr_to_rot(np.array([vio_yaw[k], 0.0, 0.0])))
        for g in graphs:
            g.add_keyframe(float(k), vio_p[k], q)
            if k == 40:
                Ri = jqnp.ypr_to_rot(np.array([gt_yaw[2], 0.0, 0.0]))
                g.edges.append(dict(i=2, j=40, t=Ri.T @ (gt_p[40] - gt_p[2]),
                                    yaw=gt_yaw[40] - gt_yaw[2], w=2.0, loop=1))
            if k == base - 1:
                g.base_n = base
    jg, tg = graphs
    assert tg.n == jg.n <= cap
    np.testing.assert_array_equal(tg.t_kf[: tg.n], jg.t_kf[: jg.n])
    assert [(e["i"], e["j"], e["w"], e["loop"]) for e in tg.edges] == \
        [(e["i"], e["j"], e["w"], e["loop"]) for e in jg.edges]
    for a, b in zip(tg.edges, jg.edges):
        np.testing.assert_allclose(a["t"], b["t"], rtol=0, atol=1e-12)
    jg.optimize(iters=10)
    tg.optimize(iters=10)
    np.testing.assert_allclose(tg.opt_p[: tg.n], jg.opt_p[: jg.n], rtol=0, atol=1e-4)


def test_misaligned_db_warns_and_drops_as_jax():
    """A DB with entries for only some keyframes cannot be evicted: at
    capacity both graphs drop the new keyframe, warn and count it."""
    cap = 32
    _, _, vio_p, vio_yaw = make_drifting_loop(cap + 4)
    for g in (jpg.PoseGraph(LoopConfig(max_keyframes=cap)),
              tpg.PoseGraph(LoopConfig(max_keyframes=cap), device="cpu")):
        for k in range(cap + 1):
            q = jqnp.rot_to_quat(jqnp.ypr_to_rot(np.array([vio_yaw[k], 0.0, 0.0])))
            if k == cap:
                g.db.n, g.db.entries = 10, [{} for _ in range(10)]
                with pytest.warns(RuntimeWarning, match="misaligned"):
                    assert g.add_keyframe(float(k), vio_p[k], q) is None
            else:
                g.add_keyframe(float(k), vio_p[k], q)
        assert g.n == cap and g.evict_fallbacks == 1


def test_optimize_4dof_pcg_matches_jax_and_dense():
    """`test_pcg_matches_dense_pgo`'s graph (120 keyframes in 128 slots):
    the PCG solver against the JAX PCG solver and against the dense one."""
    n = 120
    _, tg = _loop_graph(n, 128, [(0, n - 1)])
    args = tg.pgo_inputs(128, 1 << (len(tg.edges) - 1).bit_length())
    xyz, yaw, _ = tpg.optimize_4dof_pcg(*args, iters=15, cg_iters=128)
    jxyz, jyaw, _ = jpg.optimize_4dof_pcg(*_jax_inputs(args), iters=15, cg_iters=128)
    np.testing.assert_allclose(xyz.numpy()[:n], np.asarray(jxyz)[:n], rtol=0, atol=1e-4)
    np.testing.assert_allclose(yaw.numpy()[:n], np.asarray(jyaw)[:n], rtol=0, atol=1e-5)
    dxyz, dyaw, _ = tpg.optimize_4dof(*args, iters=15)
    np.testing.assert_allclose(xyz.numpy()[:n], dxyz.numpy()[:n], rtol=0, atol=2e-3)
    np.testing.assert_allclose(yaw.numpy()[:n], dyaw.numpy()[:n], rtol=0, atol=2e-3)


def test_optimize_4dof_rejects_a_failed_factorization():
    """A system whose factorization fails (NaN measurements: the Cholesky
    of a non-finite matrix): JAX's Cholesky returns NaNs and every step is
    rejected; the port's `cholesky_ex` path does the same without raising."""
    _, tg = _loop_graph(40, 64, [(0, 39)])
    args = list(tg.pgo_inputs(64, 256))
    args[8] = torch.full_like(args[8], float("nan"))  # NaN yaw measurements: H is NaN
    xyz, yaw, costs = tpg.optimize_4dof(*args, iters=3)
    jxyz, jyaw, _ = jpg.optimize_4dof(*_jax_inputs(args), iters=3)
    np.testing.assert_array_equal(xyz.numpy(), args[0].numpy())
    np.testing.assert_array_equal(np.asarray(jxyz), args[0].numpy())
    assert not torch.isfinite(costs).any()


# ------------------------------------------------------------ PoseGraph replay
@pytest.fixture(scope="module")
def replay():
    """`loop_scene`'s keyframes (the `kf_inputs` recipe of
    `test_relocalize_against_saved_map`, drifted along one circle) fed to
    both packages' `PoseGraph`; the PGO runs whenever a loop is pending, as
    `run_euroc` runs it."""
    seq, cam = loop_scene.sequence(), loop_scene.camera()
    R_bc, p_bc = loop_scene.extrinsic(seq)
    cfg = LoopConfig(loop_closure=True, min_loop_gap=40, max_keyframes=128)
    jg = jpg.PoseGraph(cfg, focal=F, R_bc=R_bc, p_bc=p_bc)
    tg = tpg.PoseGraph(cfg, focal=F, R_bc=R_bc, p_bc=p_bc, device="cpu")
    jg.keep_images = tg.keep_images = True  # the match_image payload
    jcam = JCam.create(F, F, W / 2, H / 2)
    loops, matches = [], []
    for t, p, q, img, uv, ids, pts in loop_scene.keyframes(seq, cam):
        out = []
        for g, c in ((jg, jcam), (tg, cam)):
            out.append(g.add_keyframe(t, p, q, img=img, cam=c, win_uv=uv, win_pts3d=pts,
                                      win_ids=ids))
            if g._pending_opt:
                g.optimize()
        loops.append(out)
        matches.append((jg.last_match, tg.last_match))
    return seq, jg, tg, loops, matches


def test_pose_graph_replay_matches_jax(replay):
    """Loops fire and the PGO runs: the same candidates and outcomes, the
    same edges, matched ids, optimized poses and drift correction."""
    seq, jg, tg, loops, matches = replay
    assert tg.n == jg.n == tg.db.n == jg.db.n
    assert [(r["i"], r["j"], r["outcome"], r["matches"], r["inliers"]) for r in tg.stats] == \
        [(r["i"], r["j"], r["outcome"], r["matches"], r["inliers"]) for r in jg.stats]
    assert tg.loop_count == jg.loop_count >= 5
    assert sum(r["outcome"] == "pnp_failed" for r in tg.stats) > 10  # rejected candidates too
    for (jl, tl) in loops:
        assert (jl is None) == (tl is None)
    assert len(tg.edges) == len(jg.edges)
    for a, b in zip(tg.edges, jg.edges):
        assert (a["i"], a["j"], a["w"], a["loop"]) == (b["i"], b["j"], b["w"], b["loop"])
        np.testing.assert_allclose(a["t"], b["t"], rtol=0, atol=1e-4)
        assert abs(a["yaw"] - b["yaw"]) < 1e-4
    for jm, tm in matches:
        assert (jm is None) == (tm is None)
        if tm is not None:
            np.testing.assert_array_equal(tm["ids"], jm["ids"])
            np.testing.assert_allclose(tm["obs_old"], jm["obs_old"], rtol=0, atol=1e-6)
            np.testing.assert_allclose(tm["p_old"], jm["p_old"], rtol=0, atol=1e-4)
    n = tg.n
    np.testing.assert_allclose(tg.opt_p[:n], jg.opt_p[:n], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tg.opt_yaw[:n], jg.opt_yaw[:n], rtol=0, atol=1e-4)
    p, q = tg.correct(seq.gt_p[100].numpy(), seq.gt_q[100].numpy())
    jp, jq = jg.correct(seq.gt_p[100].numpy(), seq.gt_q[100].numpy())
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-4)
    assert abs(tg.yaw_drift) > 0.05  # the PGO took the drift out


def test_match_image_payload_matches_jax(replay):
    """With `keep_images` each keyframe keeps its image and every accepted
    loop's `last_match` carries the `match_image` payload: the matched
    window pixels, the old keyframe's pixels (1e-6 px, as `obs_old`) and its
    image (exact); the drawn match images then agree within the pixels of
    those matches."""
    from plslam.eval import viz as jviz
    from plslam_torch.eval import viz as tviz

    _, jg, tg, _, matches = replay
    assert all(e["img"] is not None for e in tg.db.entries)
    found = [(jm, tm) for jm, tm in matches if tm is not None]
    assert len(found) >= 5
    for jm, tm in found:
        np.testing.assert_array_equal(tm["uv_cur"], jm["uv_cur"])
        np.testing.assert_allclose(tm["uv_old"], jm["uv_old"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tm["old_img"], jm["old_img"])
        assert tm["old_img"] is tg.db.entries[tm["old_idx"]]["img"]
        cur = tg.db.entries[tm["cur_idx"]]["img"]
        a = tviz.draw_match_image(cur, tm["uv_cur"], tm["old_img"], tm["uv_old"])
        b = jviz.draw_match_image(cur, jm["uv_cur"], jm["old_img"], jm["uv_old"])
        assert a.shape == (H, 2 * W) and np.mean(a != b) < 1e-3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_map_files_cross_packages(replay, writer, tmp_path):
    """A map saved by one package loads into the other: every array, the
    edges, the entries (descriptors as uint32) and the camera."""
    _, jg, tg, _, _ = replay
    path = str(tmp_path / "map.npz")
    src, dst = (jg, tpg.PoseGraph(tg.cfg, device="cpu")) if writer == "jax" else \
        (tg, jpg.PoseGraph(jg.cfg))
    src.save(path)
    dst.load(path)
    n = src.n
    assert dst.n == dst.base_n == n and dst.db.n == src.db.n
    for name in ("vio_p", "vio_q", "vio_yaw", "opt_p", "opt_yaw", "pitch", "roll", "t_kf"):
        np.testing.assert_array_equal(getattr(dst, name)[:n], getattr(src, name)[:n], err_msg=name)
    np.testing.assert_array_equal(dst.db.gdescs[:n], src.db.gdescs[:n])
    assert [(e["i"], e["j"], e["loop"]) for e in dst.edges] == \
        [(e["i"], e["j"], e["loop"]) for e in src.edges]
    for a, b in zip(dst.db.entries, src.db.entries):
        assert np.asarray(a["desc"]).dtype == np.uint32
        np.testing.assert_array_equal(a["desc"], np.asarray(b["desc"]).astype(np.uint32))
        np.testing.assert_array_equal(a["valid"], b["valid"])
        for key in ("win_ids", "win_desc"):
            if b[key] is None:
                assert a[key] is None
            else:
                np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]).astype(
                    np.asarray(a[key]).dtype))
    np.testing.assert_allclose(np.asarray(list(dst.db.entries[0]["cam"]), np.float64),
                               np.asarray(list(src.db.entries[0]["cam"]), np.float64))


def test_relocalize_against_a_jax_map(replay, tmp_path):
    """`test_relocalize_against_saved_map` across packages: the JAX map
    (the replay's first 12 keyframes) loads into both packages' graphs;
    a session in a rotated, shifted world revisits it, both confirm the
    same loop into the loaded map, and `fast_relocalize` snaps the drift
    to the same corrected pose, near ground truth."""
    seq, jg, _, _, _ = replay
    cfg = LoopConfig(loop_closure=True, min_loop_gap=40, max_keyframes=128,
                     fast_relocalization=True)
    gA = jpg.PoseGraph(cfg, focal=F, R_bc=jg.R_bc, p_bc=jg.p_bc)
    gA.n = 12  # the circle's start, where the drift is smallest
    for name in ("vio_p", "vio_q", "vio_yaw", "opt_p", "opt_yaw", "pitch", "roll", "t_kf"):
        getattr(gA, name)[:12] = getattr(jg, name)[:12]
    gA.edges = [dict(e) for e in jg.edges if e["j"] < 12]
    for k in range(12):
        gA.db.add(jg.db.entries[k], jg.db.gdescs[k])
    path = str(tmp_path / "map.npz")
    gA.save(path)
    cam, jcam = loop_scene.camera(), JCam.create(F, F, W / 2, H / 2)
    Rz = jqnp.ypr_to_rot(np.array([np.deg2rad(4.0), 0.0, 0.0]))
    t_d = np.array([0.35, -0.2, 0.1])
    j = 12 + int(2 * np.pi / 0.5 * 20)  # one period later: a revisit of frame 12
    img, uv, ids, pts = loop_scene.window_inputs(seq, cam, j)
    p_B = Rz @ seq.gt_p[j].numpy() + t_d
    q_B = jqnp.quat_mul(jqnp.rot_to_quat(Rz), seq.gt_q[j].numpy())
    kw = dict(win_uv=uv, win_pts3d=pts @ Rz.T + t_d, win_ids=ids)
    out = []
    for g, c in ((jpg.PoseGraph(cfg, focal=F, R_bc=jg.R_bc, p_bc=jg.p_bc), jcam),
                 (tpg.PoseGraph(cfg, focal=F, R_bc=jg.R_bc, p_bc=jg.p_bc, device="cpu"), cam)):
        g.load(path)
        loop = g.add_keyframe(float(seq.frame_t[j]), p_B, q_B, img=img, cam=c, **kw)
        assert loop is not None and loop["i"] < g.base_n, g.stats
        g.fast_relocalize(loop)
        out.append((loop, g.correct(p_B, q_B), g.stats))
    (jl, (jp, jq), jstats), (tl, (tp, tq), tstats) = out
    assert (tl["i"], tl["j"]) == (jl["i"], jl["j"])
    assert [r["outcome"] for r in tstats] == [r["outcome"] for r in jstats]
    np.testing.assert_allclose(tl["t"], jl["t"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-4)
    assert np.linalg.norm(tp - seq.gt_p[j].numpy()) < 0.15
