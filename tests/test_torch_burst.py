"""Port burst replay (`run_euroc(burst=8)`, `plslam_torch/models/burst.py`)
against the port's own streaming `run_euroc` on one rendered 320×240 set with
binary lines.

Bounds: `tests/test_burst.py::test_burst_matches_streaming`'s — the same
published timestamps, max |Δp| < 0.1 m, median < 1e-2 m, the last 8 < 2e-2 m,
|ΔATE| < 5e-3 m, the per-slot timestamps of the handed-back estimator equal
to streaming's, and `latest_pose()` equal to the last emitted pose (1e-9).
At least two chunks must run in burst. Beyond those bounds the poses must
agree within 1e-9 m: the step computes what streaming computes, what the
host does in float64 with the host's formulas. (The JAX package's own test
fails on its 752×480 set at max |Δp| 0.1140 m on a CPU.)

The steps must read nothing back but their keyframe flags: while a chunk
runs, no other tensor value is read on the host (`item`, `bool`, `float`,
`int`, `numpy`, ..., or a 0-dim integer tensor used as an index), no tensor
is made from host data and no element is set from a Python number (on the
card each waits for the device's queue). The plain versions of the
kernels, which run only on the CPU, are exempt. (The library's linalg
`info` checks, which wait on the card, do not show on the CPU.)
"""
import contextlib
import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from plslam_torch.convert import config_from_jax
from plslam_torch.eval.metrics import ate_rmse
from plslam_torch.models import burst as burst_mod
from plslam_torch.runner import run_euroc
from test_torch_slice import small_config, small_dataset

DURATION = 3.2  # 64 camera frames, 32 published: init, 7 streamed solves, 2 chunks, a tail
B = 8
_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__", "__int__", "__index__",
          "__array__")
_MAKERS = ("tensor", "as_tensor", "from_numpy")
_KERNELS = os.path.join("plslam_torch", "ops", "kernels")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def binary_jax_config(seq):
    """The slice tests' 320×240 configuration (the JAX package's) with binary
    lines and a smaller window (7 states, 48 point slots), which initializes
    sooner and solves faster."""
    cfg = small_config(seq)
    return dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, line_desc="binary"),
        solver=dataclasses.replace(cfg.solver, window_size=6, max_features=48))


def binary_config(seq):
    return config_from_jax(binary_jax_config(seq))


@contextlib.contextmanager
def host_reads():
    """Record (in the yielded list) every read of a tensor's value on the
    host and every tensor made from host data by this thread while the
    block runs (the runner's decode thread uploads the next chunk meanwhile,
    through pinned memory, which waits for nothing)."""
    hits = []
    me = threading.get_ident()
    saved = {name: getattr(torch.Tensor, name) for name in _READS}
    saved_makers = {name: getattr(torch, name) for name in _MAKERS}

    def read(name, orig):
        def f(self, *args, **kwargs):
            if threading.get_ident() == me:
                hits.append(name)
            return orig(self, *args, **kwargs)
        return f

    def make(name, orig):
        def f(data, *args, **kwargs):
            caller = os.path.normpath(sys._getframe(1).f_code.co_filename)
            if (threading.get_ident() == me and not isinstance(data, torch.Tensor)
                    and _KERNELS not in caller):
                hits.append(name)
            return orig(data, *args, **kwargs)
        return f

    get, put = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def getitem(self, index):
        # a 0-dim integer tensor as an index is read back (in C++)
        parts = index if isinstance(index, tuple) else (index,)
        if threading.get_ident() == me and any(
                isinstance(i, torch.Tensor) and i.ndim == 0 and not i.is_floating_point()
                and i.dtype != torch.bool for i in parts):
            hits.append("getitem of a 0-dim index")
        return get(self, index)

    def setitem(self, index, value):
        # an element set from a Python number copies it to the card
        parts = index if isinstance(index, tuple) else (index,)
        if (threading.get_ident() == me and isinstance(value, (int, float))
                and any(isinstance(i, int) for i in parts)):
            hits.append("setitem of a number")
        return put(self, index, value)

    try:
        torch.Tensor.__getitem__, torch.Tensor.__setitem__ = getitem, setitem
        for name, orig in saved.items():
            setattr(torch.Tensor, name, read(name, orig))
        for name, orig in saved_makers.items():
            setattr(torch, name, make(name, orig))
        yield hits
    finally:
        torch.Tensor.__getitem__, torch.Tensor.__setitem__ = get, put
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)
        for name, orig in saved_makers.items():
            setattr(torch, name, orig)


def guarded_burst(path, cfg):
    """`run_euroc(burst=8)` with every chunk's steps run under `host_reads`.
    Returns (outputs, burst_log, reads during the steps, steps run, the
    handbacks' (last camera time handed, the point frontend's prev_t))."""
    reads, steps, handbacks = [], [0], []
    run_chunk, step, sync_back = (burst_mod.BurstStep.run_chunk, burst_mod.BurstStep.step,
                                  burst_mod.sync_back)

    def guarded_chunk(self, *args):
        with host_reads() as hits:
            out = run_chunk(self, *args)
        reads.extend(hits)
        return out

    def counted_step(self, *args):
        steps[0] += 1
        return step(self, *args)

    def recorded_sync_back(est, fp, fl, carry, ts_win, last_cam_t):
        sync_back(est, fp, fl, carry, ts_win, last_cam_t)
        handbacks.append((last_cam_t, fp.prev_t))

    log = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(burst_mod.BurstStep, "run_chunk", guarded_chunk)
        mp.setattr(burst_mod.BurstStep, "step", counted_step)
        mp.setattr(burst_mod, "sync_back", recorded_sync_back)
        out = run_euroc(str(path), cfg, burst=B, burst_log=log, device="cpu")
    return out, log, reads, steps[0], handbacks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)  # a module fixture runs before the function-scoped one
    path = tmp_path_factory.mktemp("burst_render")
    seq = small_dataset(path, DURATION)
    cfg = binary_config(seq)
    streaming = run_euroc(str(path), cfg, device="cpu")
    return seq, path, streaming, guarded_burst(path, cfg)


def test_burst_matches_streaming(runs):
    seq, _, (ts_s, ps_s, _, est_s, _), burst = runs
    (ts_b, ps_b, _, est_b, _), log, _, _, _ = burst
    assert est_s.initialized and est_b.initialized
    chunks = [e for e in log if "fallback" not in e]
    assert len(chunks) >= 2 and all(e["frames"] == B for e in chunks), log
    n_burst = sum(1 for m in est_b.metrics if m.get("burst"))
    assert n_burst == B * len(chunks) >= 16, n_burst
    np.testing.assert_allclose(ts_b, ts_s, atol=1e-9)
    dp = np.linalg.norm(ps_b - ps_s, axis=1)
    # the step computes what streaming computes, the host's float64 parts
    # with the host's formulas: the same poses to the last bit here
    assert dp.max() < 1e-9, f"burst vs streaming max |Δp| {dp.max():.4g} m"
    assert dp.max() < 0.1, f"burst vs streaming max |Δp| {dp.max():.4g} m"
    assert np.median(dp) < 1e-2, f"burst vs streaming median |Δp| {np.median(dp):.4g} m"
    assert dp[-8:].max() < 2e-2, f"burst vs streaming did not re-converge: {dp[-8:]}"
    gt_t, gt_p = seq.frame_t.numpy(), seq.gt_p.numpy()
    ate_s = ate_rmse(ts_s, ps_s, gt_t, gt_p, align="yaw")
    ate_b = ate_rmse(ts_b, ps_b, gt_t, gt_p, align="yaw")
    assert abs(ate_b - ate_s) < 5e-3, (ate_b, ate_s)
    _, p_last, _ = est_b.latest_pose()
    np.testing.assert_allclose(p_last, ps_b[-1], atol=1e-9)
    np.testing.assert_allclose(est_b.timestamps, est_s.timestamps, atol=1e-9)
    # the only fallback: the frames left over for less than a chunk
    assert [e["fallback"] for e in log if "fallback" in e] == ["fewer frames left than a chunk"]


def test_burst_steps_read_nothing_back(runs):
    """Nothing but each step's keyframe flag."""
    _, _, _, burst = runs
    _, _, reads, steps, _ = burst
    assert steps >= 16
    assert reads == ["__bool__"] * steps, reads[:20]


def test_handback_restores_the_frontend_clock(runs):
    """The point frontend's velocity reference after a handback is the last
    camera frame it tracked (a light tick's), not the last published one."""
    _, path, _, burst = runs
    _, log, _, _, handbacks = burst
    from plslam_torch.io.euroc import EurocSequence

    cam_t = np.asarray(EurocSequence.load(str(path)).cam_t, np.float64)
    chunks = [e for e in log if "fallback" not in e]
    last_k = chunks[-1]["k"] + B * 2  # the camera frame after the last chunk (stride 2)
    assert len(handbacks) == 1
    handed, prev_t = handbacks[0]
    assert handed == prev_t == cam_t[last_k - 1]


def test_burst_readback_raises_on_the_eigh_flag(monkeypatch):
    """A chunk whose second step's marginalization flag is set (the steps
    leave it on the card): the chunk's one readback in `runner._burst_tail`
    raises `LinAlgError` before it emits a pose. The steps, the carry and
    the IMU packer are stand-ins; only the readback runs."""
    import types

    from plslam_torch import runner

    W, B, stride = 4, 2, 2

    class Step:
        OUTPUTS = burst_mod.BurstStep.OUTPUTS

        def __init__(self, *a):
            pass

        def run_chunk(self, carry, imgs, *a):
            outs = {name: torch.zeros(B) for name in self.OUTPUTS}
            outs["eigh_failed"][1] = 1.0
            return carry, outs

    class Packer:
        def __init__(self, *a):
            pass

        def interval(self, t, td):
            return np.zeros((3, 3)), np.zeros((3, 3)), np.zeros(2), 2

    monkeypatch.setattr(burst_mod, "make_carry", lambda *a: None)
    monkeypatch.setattr(burst_mod, "BurstStep", Step)
    monkeypatch.setattr(burst_mod, "ImuChunkPacker", Packer)
    monkeypatch.setattr(burst_mod, "sync_back", lambda *a, **kw: None)
    seq = types.SimpleNamespace(cam_t=0.05 * np.arange(16), imu_t=None, imu_acc=None,
                                imu_gyr=None)
    est = types.SimpleNamespace(device=torch.device("cpu"), timestamps=np.zeros(W + 1), td=0.0,
                                cfg=types.SimpleNamespace(window_size=W))
    feeder = types.SimpleNamespace(i=0, prev_t=0.0, prev_acc=None, prev_gyr=None)
    ts_out = []
    with pytest.raises(torch.linalg.LinAlgError):
        runner._burst_tail(seq, None, est, None, None, feeder, 4, stride, B,
                           lambda k: np.zeros((4, 4), np.float32), ts_out, [], [], 0, 100,
                           False, None, None, [])
    assert ts_out == []
