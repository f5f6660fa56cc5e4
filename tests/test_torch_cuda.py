"""Port tests that need the card: the LK and Hamming kernels against their
plain versions, the CUDA-graph LM solve against the eager one (also
replayed with relo factors), the line frontend's tick, the synthetic
runner (points only and with lines), the keyframe features and a
`PoseGraph` replay with loops (its BRIEF searches counted as Hamming
launches) on the card against the CPU, and an estimator checkpoint saved
and resumed on the card. No JAX here (the machine with the card has none);
run them there with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

On a host without CUDA every test skips.

Tolerances: LK 1e-3 px, both formulations (float32, summation order);
Hamming distances exact; CUDA-graph replays run the eager calls' kernels: states 1e-5
absolute and prior information 1e-4 of its scale in float32 (the library
may choose other reduction orders under capture); the line tick in float64
on both devices: ids exact, segments 1e-8 (sums in another order); CPU vs
card run_synthetic 1e-6 m in float64; keyframe descriptors equal but at
BRIEF ties, global descriptors 1e-5; the float32 pose graph's edges and
optimized poses 1e-4; a checkpoint's tensors and the resumed run bit for
bit; the marginalization's queued eigendecompositions: the card still busy
behind a 100-ms sleep when both marginalizations return, their priors bit
for bit with `torch.linalg.eigh`'s, a planted NaN raising at `finalize`.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.set_num_threads(1)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("formulation,h,w", [("fast", 240, 320), ("pallas", 240, 320),
                                              ("pallas", 100, 160)])
def test_lk_kernel_matches_plain(dev, formulation, h, w):
    """One launch tracks all levels; positions 1e-3 px where both track,
    status equal away from the err gate. At 100×160 the coarsest level
    (25×40) is smaller than `fast`'s 30×30 search window: `pallas`, which
    has no window, tracks there as its plain version and the JAX Pallas
    kernel do, and `fast` refuses the pyramid on both devices."""
    from plslam_torch.models.frontend_points import build_pyramid
    from plslam_torch.ops.kernels import lk

    rng = np.random.default_rng(0)
    img = rng.random((h, w)).astype(np.float32)
    k = np.ones(7) / 7.0
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.ascontiguousarray(np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img),
                               np.float32)
    img2 = np.roll(img, (2, -3), axis=(0, 1))
    pyr1 = build_pyramid(torch.as_tensor(img, device=dev), 3)
    pyr2 = build_pyramid(torch.as_tensor(img2, device=dev), 3)
    pts = torch.as_tensor(rng.uniform([2, 2], [w - 2, h - 2], (64, 2)), dtype=torch.float32,
                          device=dev)
    valid = torch.ones(64, dtype=torch.bool, device=dev)
    n0 = lk.LAUNCHES
    ko, ks, ke = lk.lk_track(pyr1, pyr2, pts, valid, formulation=formulation)
    assert lk.LAUNCHES == n0 + 1
    plain = lk.lk_track_fast_torch if formulation == "fast" else lk.lk_track_torch
    po, ps, pe = plain(pyr1, pyr2, pts, valid)
    torch.cuda.synchronize()
    both = ks & ps
    assert both.sum() > 20
    assert float((ko - po)[both].abs().max()) < 1e-3
    near_gate = (pe - 0.12).abs() < 1e-4
    assert torch.equal(ks[~near_gate], ps[~near_gate])
    if min(pyr1[-1].shape) < lk.S_C:
        for args in ((pyr1, pyr2, pts, valid),
                     ([p.cpu() for p in pyr1], [p.cpu() for p in pyr2], pts.cpu(), valid.cpu())):
            with pytest.raises(ValueError, match="search window"):
                lk.lk_track(*args, formulation="fast")


def test_cuda_graphs_match_eager(dev):
    """The window solve and the marginalization replayed from CUDA graphs
    against their eager runs on the same inputs."""
    from plslam_torch.config import PLSlamConfig, SolverConfig
    from plslam_torch.io import synthetic
    from plslam_torch.models import marginalization, solver
    from plslam_torch.runner import run_synthetic
    from plslam_torch.utils.cuda_graph import CudaGraph

    seq = synthetic.make_sequence(duration=2.0, n_points=80, n_lines=16, seed=3)
    cfg = PLSlamConfig(solver=SolverConfig(max_features=48, max_line_feats=8))
    _, _, _, est = run_synthetic(seq, cfg, oracle_init=True, max_frames=14, device=dev)
    st, f = est._device_state(), est._factors()
    eager, eager_stats = solver.optimize_window(st, f, est.lay, est.cfg)
    graph = CudaGraph(lambda s, f_: solver.optimize_window(s, f_, est.lay, est.cfg), st, f)
    for _ in range(2):  # replays are repeatable
        out, stats = graph(st, f)
        for a, b in zip(out, eager):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        assert int(stats.accepted) == int(eager_stats.accepted)
    p_eager = marginalization.marginalize_old(eager, f, est.lay, est.cfg, groups=eager_stats.groups)
    graphs = {}
    for _ in range(2):
        p_graph = marginalization.marginalize_old(eager, f, est.lay, est.cfg,
                                                  groups=eager_stats.groups, graphs=graphs)
        H_e, H_g = p_eager.J.T @ p_eager.J, p_graph.J.T @ p_graph.J
        torch.testing.assert_close(H_g, H_e, rtol=0, atol=1e-4 * float(H_e.abs().max()))
    assert [k[0] for k in graphs] == ["marginalize_old"]
    # a replay never casts or broadcasts an input that differs from the recording
    with pytest.raises(ValueError, match="recorded"):
        graph(st._replace(p=st.p.double()), f)
    with pytest.raises(ValueError, match="recorded"):
        graph(st._replace(p=st.p[:1]), f)


def test_run_synthetic_card_matches_cpu(dev):
    from plslam_torch.config import PLSlamConfig, SolverConfig
    from plslam_torch.io import synthetic
    from plslam_torch.runner import run_synthetic

    seq = synthetic.make_sequence(duration=3.0, n_points=100, n_lines=16, seed=11)
    cfg = PLSlamConfig(solver=SolverConfig(max_features=48, max_line_feats=8, dtype="float64"))
    cpu = run_synthetic(seq, cfg, oracle_init=True, use_lines=False, device="cpu")
    gpu = run_synthetic(seq, cfg, oracle_init=True, use_lines=False, device=dev)
    assert gpu[3].initialized and len(gpu[0]) > 5
    np.testing.assert_array_equal(gpu[0], cpu[0])
    np.testing.assert_allclose(gpu[1], cpu[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("n1,n2,misaligned", [
    (64, 64, False), (128, 256, False), (150, 90, False), (1000, 1000, False), (1, 1, False),
    (17, 300, False), (64, 301, False), (128, 301, True)])
def test_hamming_kernel_matches_plain(dev, n1, n2, misaligned):
    """One launch, bit-exact with the plain version, on inputs with the
    extreme rows (every bit set, every bit clear, equal descriptors). An odd
    n2 (301) takes the kernel's 4-B stores, an even one its 8-B stores;
    `misaligned` passes both inputs as contiguous views one word past an
    aligned base, which the kernel reads a word at a time."""
    from plslam_torch.ops.kernels import hamming
    from plslam_torch.utils import measure

    a, b = measure.hamming_inputs(np.random.default_rng(n1 + n2), n1, n2, dev)
    if misaligned:
        a, b = measure.misaligned(a), measure.misaligned(b)
        assert a.data_ptr() % 16 and b.data_ptr() % 16
    n0 = hamming.LAUNCHES
    out = hamming.hamming_matrix(a, b)
    assert hamming.LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    ref = hamming.hamming_matrix_torch(a, b)
    assert out.dtype == torch.int32 and out.shape == (n1, n2)
    assert torch.equal(out, ref)
    assert out[0, 0] == 0 and (n1 < 2 or out[1, 0] == 256) and (n1 < 3 or n2 < 2 or out[2, 1] == 0)
    with pytest.raises(ValueError, match="int32"):
        hamming.hamming_matrix(a.to(torch.int64), b.to(torch.int64))


def _line_scenes():
    rng = np.random.default_rng(3)
    img = np.full((240, 320), 0.25, np.float32)
    ys, xs = np.meshgrid(np.arange(240.0), np.arange(320.0), indexing="ij")
    for (x0, y0, x1, y1) in [(40, 40, 200, 60), (260, 30, 250, 200), (60, 180, 280, 150)]:
        d = np.array([x1 - x0, y1 - y0], np.float64)
        u = d / np.linalg.norm(d)
        tproj = (xs - x0) * u[0] + (ys - y0) * u[1]
        dperp = np.abs(-(xs - x0) * u[1] + (ys - y0) * u[0])
        img[(tproj > 0) & (tproj < np.linalg.norm(d)) & (dperp < 1.2)] = 0.9
    img = img + rng.standard_normal(img.shape).astype(np.float32) * 0.01
    return img, np.roll(img, (2, 4), axis=(0, 1))


def test_line_tick_card_matches_cpu(dev):
    """Two binary-LBD line ticks in float64 on the card and on the CPU; the
    card's go through the Hamming kernel once per tick."""
    from plslam_torch.models.frontend_lines import FrontendLines
    from plslam_torch.ops.cameras import PinholeRadTan
    from plslam_torch.ops.kernels import hamming

    cam = PinholeRadTan.create(300.0, 300.0, 160.0, 120.0, dtype=torch.float64)
    kw = dict(max_lines=32, dtype=torch.float64, binary_desc=True)
    on_card, on_cpu = FrontendLines(cam, device=dev, **kw), FrontendLines(cam, device="cpu", **kw)
    for k, img in enumerate(_line_scenes()):
        n0 = hamming.LAUNCHES
        g = on_card.process(img, 0.05 * k)
        assert hamming.LAUNCHES == n0 + 1
        c = on_cpu.process(img, 0.05 * k)
        np.testing.assert_array_equal(g[0], c[0])
        np.testing.assert_allclose(g[1], c[1], rtol=0, atol=1e-8)
        assert len(g[0]) >= 3


def test_run_synthetic_lines_card_matches_cpu(dev):
    """`run_synthetic(use_lines=True)`, CUDA graphs on (the card's default)."""
    from plslam_torch.config import PLSlamConfig, SolverConfig
    from plslam_torch.io import synthetic
    from plslam_torch.runner import run_synthetic

    seq = synthetic.make_sequence(duration=3.0, n_points=100, n_lines=24, seed=11)
    cfg = PLSlamConfig(solver=SolverConfig(max_features=48, max_line_feats=16, dtype="float64"))
    cpu = run_synthetic(seq, cfg, oracle_init=True, use_lines=True, device="cpu")
    gpu = run_synthetic(seq, cfg, oracle_init=True, use_lines=True, device=dev)
    assert gpu[3]._graphs and gpu[3].initialized and len(gpu[0]) > 5
    assert max(m.get("n_lines", 0) for m in gpu[3].metrics) > 0
    np.testing.assert_array_equal(gpu[0], cpu[0])
    np.testing.assert_allclose(gpu[1], cpu[1], rtol=0, atol=1e-6)


def test_keyframe_features_card_matches_cpu(dev):
    """Shi-Tomasi + BRIEF + the global descriptor on the card against the
    CPU: the same corners, words equal except at BRIEF ties (|va − vb| <
    1e-5), global descriptors within 1e-5."""
    from plslam_torch.models import keyframe_db as kdb
    from plslam_torch.utils import measure

    rng = np.random.default_rng(5)
    img = measure.shifted_texture(rng, 240, 320, 0.0, 0.0)[0]
    extra = rng.uniform([0, 0], [320, 240], (100, 2))
    extra[:3] = [[1.0, 1.0], [318.5, 2.0], [3.0, 238.0]]
    g = kdb.extract_keyframe_features(torch.as_tensor(img, device=dev), extra_uv=extra)
    c = kdb.extract_keyframe_features(torch.as_tensor(img), extra_uv=extra)
    np.testing.assert_array_equal(g[0], c[0])
    np.testing.assert_array_equal(g[1], c[1])
    va, vb = kdb._brief_tests(torch.as_tensor(img), torch.as_tensor(c[0]))
    ties = ((va - vb).abs() < 1e-5).numpy()
    bits = lambda d: np.unpackbits(d.view(np.uint8), bitorder="little").reshape(-1, 256)  # noqa: E731
    assert not ((bits(g[2]) != bits(c[2])) & ~ties).any()
    np.testing.assert_allclose(g[3], c[3], rtol=0, atol=1e-5)


def test_pose_graph_replay_card_matches_cpu(dev):
    """`tests/loop_scene.py`'s keyframes through `PoseGraph` on the card and
    on the CPU: the same candidates and outcomes; edges, optimized poses and
    drift within 1e-4 (float32 PGO, other summation orders); the card's
    BRIEF searches are Hamming launches, one for every candidate that
    reached the descriptor match, and the PGO runs as often on both."""
    import loop_scene
    from plslam_torch.config import LoopConfig
    from plslam_torch.models.pose_graph import PoseGraph
    from plslam_torch.ops.kernels import hamming

    seq, cam = loop_scene.sequence(), loop_scene.camera()
    R_bc, p_bc = loop_scene.extrinsic(seq)
    cfg = LoopConfig(loop_closure=True, min_loop_gap=40, max_keyframes=128)
    graphs = {d: PoseGraph(cfg, focal=loop_scene.F, R_bc=R_bc, p_bc=p_bc, device=d)
              for d in (dev, "cpu")}
    n0 = hamming.LAUNCHES
    for t, p, q, img, uv, ids, pts in loop_scene.keyframes(seq, cam):
        for g in graphs.values():
            g.add_keyframe(t, p, q, img=img, cam=cam, win_uv=uv, win_pts3d=pts, win_ids=ids)
            if g._pending_opt:
                g.optimize()
    gg, gc = graphs[dev], graphs["cpu"]
    searched = [r for r in gg.stats if r["outcome"] not in ("no_window_points", "no_descriptors")]
    assert hamming.LAUNCHES - n0 == len(searched) > 20
    assert gg.loop_count == gc.loop_count >= 5
    assert [(r["i"], r["j"], r["outcome"]) for r in gg.stats] == \
        [(r["i"], r["j"], r["outcome"]) for r in gc.stats]
    for a, b in zip(gg.edges, gc.edges):
        assert (a["i"], a["j"], a["loop"]) == (b["i"], b["j"], b["loop"])
        np.testing.assert_allclose(a["t"], b["t"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(gg.opt_p[: gg.n], gc.opt_p[: gc.n], rtol=0, atol=1e-4)
    np.testing.assert_allclose(gg.opt_yaw[: gg.n], gc.opt_yaw[: gc.n], rtol=0, atol=1e-4)
    assert abs(gg.yaw_drift - gc.yaw_drift) < 1e-4
    assert len(gg.times["optimize"]) == len(gc.times["optimize"]) >= gg.loop_count


def test_lm_graph_with_relo_matches_eager(dev):
    """The LM's CUDA graph, recorded on a frame without relo factors
    (`relo_valid` = 0), replayed on one with them (`relo_valid` = 1, a
    perturbed old-keyframe pose): equal to the eager solve (1e-5, float32),
    and the relo pose moves, so the factors took part in the replay."""
    from plslam_torch.config import PLSlamConfig, SolverConfig
    from plslam_torch.io import synthetic
    from plslam_torch.models import solver
    from plslam_torch.runner import run_synthetic
    from plslam_torch.utils.cuda_graph import CudaGraph

    seq = synthetic.make_sequence(duration=2.0, n_points=80, n_lines=16, seed=3)
    cfg = PLSlamConfig(solver=SolverConfig(max_features=48, max_line_feats=8))
    _, _, _, est = run_synthetic(seq, cfg, oracle_init=True, max_frames=14, device=dev)
    st, f = est._device_state(), est._factors()
    assert float(f.relo_valid) == 0.0
    graph = CudaGraph(lambda s, f_: solver.optimize_window(s, f_, est.lay, est.cfg), st, f)
    # the old keyframe: window slot 0, which saw every feature that starts there
    first = (f.pt_start == 0).to(f.pt_mask.dtype) * f.pt_mask[:, 0]
    f_relo = f._replace(relo_obs=f.pt_obs[:, 0].clone(), relo_mask=first,
                        relo_valid=torch.ones_like(f.relo_valid))
    st_relo = st._replace(relo_p=st.p[0] + torch.tensor([0.03, -0.02, 0.01], device=dev),
                          relo_q=st.q[0].clone())
    assert float(first.sum()) >= 8
    eager, eager_stats = solver.optimize_window(st_relo, f_relo, est.lay, est.cfg)
    out, stats = graph(st_relo, f_relo)
    for a, b in zip(out, eager):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert int(stats.accepted) == int(eager_stats.accepted)
    assert float((out.relo_p - st_relo.relo_p).norm()) > 1e-3
    plain, _ = graph(st, f)  # and back: the same graph without relo factors
    torch.testing.assert_close(plain.relo_p, st.relo_p, rtol=0, atol=0)


def _drive(est, seq, k0, k1, stride=2):
    """Published frames [k0, k1) of a synthetic sequence with index-determined
    IMU dts and oracle initialization (`test_io._run_frames`)."""
    imu_t = np.asarray(seq.imu_t)
    frame_t = np.asarray(seq.frame_t)[::stride]
    obs, valid = np.asarray(seq.obs)[::stride], np.asarray(seq.obs_valid)[::stride]
    gt = [np.asarray(a)[::stride] for a in (seq.gt_p, seq.gt_q, seq.gt_v)]
    for k in range(k0, k1):
        lo = frame_t[k - 1] if k > 0 else -np.inf
        for i in np.nonzero((imu_t > lo + 1e-9) & (imu_t <= frame_t[k] + 1e-9))[0]:
            dt = imu_t[i] - imu_t[i - 1] if i > 0 else 0.005
            est.process_imu(dt, np.asarray(seq.imu_acc[i]), np.asarray(seq.imu_gyr[i]))
        vis = np.nonzero(valid[k])[0]
        est.process_frame(float(frame_t[k]), vis, obs[k, vis], None, None, None,
                          oracle_state={"p": gt[0][k], "q": gt[1][k], "v": gt[2][k]})
    return est


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A float32 estimator on the card saved and loaded: the prior and the
    preintegrations come back on the card in float32, bit for bit; a CPU
    estimator reads the same file; the resumed run equals the uninterrupted
    one bit for bit (both replay their own recorded CUDA graphs)."""
    from plslam_torch.config import PLSlamConfig, SolverConfig
    from plslam_torch.io import synthetic
    from plslam_torch.io.checkpoint import load_estimator, save_estimator
    from plslam_torch.models.estimator import Estimator

    seq = synthetic.make_sequence(duration=3.0, n_points=100, n_lines=8, seed=5)
    cfg = PLSlamConfig(solver=SolverConfig(max_features=48, max_line_feats=8, dtype="float32"))
    full = _drive(Estimator(cfg, device=dev), seq, 0, 24)
    half = _drive(Estimator(cfg, device=dev), seq, 0, 16)
    assert half.prior is not None and half._graphs
    path = str(tmp_path / "ck.npz")
    save_estimator(half, path)
    est = load_estimator(Estimator(cfg, device=dev), path)
    for a, b in zip(est.prior, half.prior):
        assert a.is_cuda and a.dtype == torch.float32 and torch.equal(a, b)
    for pa, pb in zip(est.pres, half.pres):
        assert (pa is None) == (pb is None)
        assert pa is None or all(pa[k].is_cuda and torch.equal(pa[k], pb[k]) for k in pa)
    cpu = load_estimator(Estimator(cfg, dtype=torch.float32, device="cpu"), path)
    for a, b in zip(cpu.prior, half.prior):
        assert torch.equal(a, b.cpu())
    _drive(est, seq, 16, 24)
    for name in ("p", "q", "v", "ba", "bg"):
        np.testing.assert_array_equal(getattr(est, name), getattr(full, name), err_msg=name)


def _marg_window(dev, dtype):
    """A window at the benchmark cells' widths (window 10, 192 feature
    slots, 64 line slots) packed from the simulator, its first prior from
    `marginalize_old` installed for `marginalize_second_new`, and a dict of
    CUDA graphs warmed with both, as the estimator runs them."""
    from plslam_torch.config import SolverConfig
    from plslam_torch.io import synthetic
    from plslam_torch.models import marginalization as marg
    from plslam_torch.models import packing
    from plslam_torch.models import residuals as res
    from plslam_torch.models.state import layout

    cfg = SolverConfig(max_features=192, max_line_feats=64, window_size=10)
    lay = layout(cfg)
    seq = synthetic.make_sequence(duration=6.0, n_points=420, n_lines=160, seed=3)
    st, f = packing.factors_from_synthetic(seq, list(range(0, 55, 5)), cfg, lay, dtype=dtype,
                                           device=dev)
    groups = res.residual_groups(st, f, lay, cfg.focal_length, cfg.line_param)
    graphs = {}
    for _ in range(2):
        f2 = marg.install_prior(f, marg.marginalize_old(st, f, lay, cfg, groups=groups,
                                                        graphs=graphs))
        marg.marginalize_second_new(st, f2, lay, cfg)
    return cfg, lay, st, f, f2, groups, graphs


def test_marginalization_queues_behind_a_busy_card(dev):
    """With the card held 100 ms by `torch.cuda._sleep`, `marginalize_old`
    and `marginalize_second_new` return while the card is still busy with
    the sleep, well inside it: their eigendecompositions (3 and 2, counted
    by the tracer) queue without a host wait; their flags read 0 once the
    card is done. The host time left is launches (an H100 host: 5.0-7.7 ms
    for `marginalize_old`, 3.4-4.6 ms for `marginalize_second_new`, the same
    on an idle card), held under a fifth of the sleep."""
    from plslam_torch.models import marginalization as marg
    from plslam_torch.utils import timers
    from plslam_torch.utils.measure import host_ms_behind_busy_card

    cfg, lay, st, f, f2, groups, graphs = _marg_window(dev, torch.float32)
    calls = {"old": lambda infos: marg.marginalize_old(st, f, lay, cfg, groups=groups,
                                                       graphs=graphs, infos=infos),
             "new": lambda infos: marg.marginalize_second_new(st, f2, lay, cfg, infos=infos)}
    for mode, fn in calls.items():
        infos = []
        timers.enable()
        try:
            ms, busy = host_ms_behind_busy_card(lambda: fn(infos), 100.0)
            n = sum(c.n for c in timers.records()["counts"] if c.name == "backend.eigh_queued")
        finally:
            timers.disable()
            timers.reset()
        assert busy and ms < 20.0, (mode, ms, busy)
        assert n == len(infos) == {"old": 3, "new": 2}[mode]
        assert int(marg.eigh_failed(infos, st.p)) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_queued_prior_matches_library_eigh(dev, dtype):
    """The priors of both marginalizations with their decompositions queued
    (`cusolverDnXsyevBatched`) against `torch.linalg.eigh`'s (`syevd` for one
    matrix, the same batched driver for the line blocks): J and r0 bit for
    bit, the decompositions in float64 as before; JᵀJ and Jᵀr0 within 1e-9
    of JᵀJ's widest entry is the bound where the bits would part."""
    from unittest import mock

    from plslam_torch.models import marginalization as marg

    cfg, lay, st, f, f2, groups, graphs = _marg_window(dev, dtype)

    def library(M, infos=None):
        w, V = torch.linalg.eigh((0.5 * (M + M.transpose(-1, -2))).to(torch.float64))
        return w.to(M.dtype), V.to(M.dtype)

    for fn in (lambda: marg.marginalize_old(st, f, lay, cfg, groups=groups, graphs=graphs,
                                            infos=[]),
               lambda: marg.marginalize_second_new(st, f2, lay, cfg, infos=[])):
        queued = fn()
        with mock.patch.object(marg, "_eigh_sym", library):
            ref = fn()
        H, Hr = queued.J.T @ queued.J, ref.J.T @ ref.J
        tol = 1e-9 * float(Hr.abs().max())
        torch.testing.assert_close(H, Hr, rtol=0, atol=tol)
        torch.testing.assert_close(queued.J.T @ queued.r0, ref.J.T @ ref.r0, rtol=0, atol=tol)
        assert torch.equal(queued.J, ref.J) and torch.equal(queued.r0, ref.r0)


def test_failed_decomposition_raises_at_finalize(dev):
    """A non-finite prior planted in a backend tick's factors: the tick's
    eigh flag reads 1 without the tick waiting on it, and the estimator's
    `finalize` raises `LinAlgError` at the bundle's readback."""
    from plslam_torch.config import PLSlamConfig
    from plslam_torch.models.estimator import (MARGIN_SECOND_NEW, Estimator, backend_tick,
                                               pack_bundle)
    from plslam_torch.utils.device import HostCopy

    cfg, lay, st, f, f2, _, _ = _marg_window(dev, torch.float32)
    bad = f2._replace(prior_J=f2.prior_J.clone().fill_(float("nan")))
    zeros = lambda n: torch.zeros(n, dtype=st.p.dtype, device=dev)  # noqa: E731
    st_out, stats, prior, aux = backend_tick(
        st, bad, f.pt_valid, zeros(lay.max_f), zeros(lay.max_f), zeros(lay.max_l), f.ln_valid,
        lay, cfg, ee=False, etd=False, iters=2, marg_mode="new")
    assert float(aux["eigh_failed"]) == 1.0
    est = Estimator(PLSlamConfig(solver=cfg), device=dev)
    est._pending = dict(bundle=HostCopy(pack_bundle(st_out, stats, aux)), prior=prior,
                        mode="new", marg_flag=MARGIN_SECOND_NEW, m={"t": 0.0}, relo=None)
    with pytest.raises(torch.linalg.LinAlgError):
        est.finalize()
