"""Port parity, packing: `plslam_torch/models/packing.py` and
`io/synthetic.imu_between` against `plslam/models/packing.py` on the same
simulator sequence (the port's, carried to JAX as numpy; the two simulators
agree to 1e-12, `test_torch_slice.py`).

Tolerance: every float field within 1e-10 (relative, and absolute 1e-10
near zero; the IMU whitening holds entries up to ~1e5), float64 in both
packages; integer fields exact and int64 in the port.

The helpers here (`jax_sequence`, `to_jax`, `port_config`) serve the other
slice-F parity files too.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.config import SolverConfig
from plslam.io import synthetic as jsyn
from plslam.models import packing as jpack
from plslam.models.state import layout as jlayout
from plslam_torch.config import SolverConfig as TSolverConfig
from plslam_torch.convert import _INT_FIELDS
from plslam_torch.io import synthetic as tsyn
from plslam_torch.models import packing as tpack
from plslam_torch.models.state import layout as tlayout

CFG = SolverConfig(max_features=48, max_line_feats=16)  # tests/test_distributed.py's
FRAMES = list(range(0, 55, 5))
TOL = 1e-10


def port_config(cfg) -> TSolverConfig:
    return TSolverConfig(**dataclasses.asdict(cfg))


def jax_sequence(seq):
    """The JAX package's `SyntheticSequence` holding the port's arrays."""
    return jsyn.SyntheticSequence(*[jnp.asarray(x.numpy()) for x in seq])


def to_jax(nt, cls):
    """A JAX NamedTuple of `cls` from the port's (field by field, via numpy)."""
    return cls(*[jnp.asarray(x.detach().cpu().numpy()) for x in nt])


def assert_same(port, ref, tol=TOL):
    for name in port._fields:
        a, b = getattr(port, name), np.asarray(getattr(ref, name))
        if name in _INT_FIELDS:
            assert a.dtype == torch.int64, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            assert a.dtype == torch.float64, name
            np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol, err_msg=name)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def seqs():
    torch.set_num_threads(1)
    t = tsyn.make_sequence(duration=6.0, n_points=120, n_lines=40, seed=3)
    return t, jax_sequence(t)


def test_imu_between_matches_jax(seqs):
    tseq, jseq = seqs
    for t0, t1 in ((0.0, 0.25), (1.05, 1.3), (2.0, 2.5)):
        for a, b in zip(tsyn.imu_between(tseq, t0, t1), jsyn.imu_between(jseq, t0, t1)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-15)


@pytest.mark.parametrize("with_lines", [True, False])
def test_factors_from_synthetic_matches_jax(seqs, with_lines):
    tseq, jseq = seqs
    jst, jf = jpack.factors_from_synthetic(jseq, FRAMES, CFG, jlayout(CFG), with_lines=with_lines)
    tcfg = port_config(CFG)
    tst, tf = tpack.factors_from_synthetic(tseq, FRAMES, tcfg, tlayout(tcfg),
                                           with_lines=with_lines, device="cpu")
    assert float(tf.pt_valid.sum()) > 20 and (not with_lines or float(tf.ln_valid.sum()) > 4)
    assert_same(tst, jst)
    assert_same(tf, jf)


def test_factors_from_synthetic_dtype():
    """float32 output: every float field float32, the integer fields int64."""
    tcfg = port_config(CFG)
    seq = tsyn.make_sequence(duration=3.0, n_points=60, n_lines=20, seed=3)
    st, f = tpack.factors_from_synthetic(seq, list(range(0, 22, 2)), tcfg, tlayout(tcfg),
                                         dtype=torch.float32, device="cpu")
    for nt in (st, f):
        for name, a in zip(nt._fields, nt):
            assert a.dtype == (torch.int64 if name in _INT_FIELDS else torch.float32), name


def _tracks(seq, frames, rng):
    """Frontend-like tracks from the simulator: each keyframe's visible
    landmark ids (shuffled, a tenth dropped) and their observations."""
    ids, obs = [], []
    for k in frames:
        vis = np.nonzero(seq.obs_valid[k].numpy())[0]
        vis = rng.permutation(vis)[: int(0.9 * len(vis))]
        ids.append(vis.astype(np.int64))
        obs.append(seq.obs[k].numpy()[vis])
    return ids, obs


def test_factors_from_tracks_matches_jax(seqs):
    tseq, _ = seqs
    rng = np.random.default_rng(2)
    ids, obs = _tracks(tseq, FRAMES, rng)
    # keyframe stamps off the IMU grid: both boundaries interpolate
    kf_t = tseq.frame_t.numpy()[FRAMES] + 0.0013
    imu = [x.numpy() for x in (tseq.imu_t, tseq.imu_acc, tseq.imu_gyr)]
    ba, bg = np.array([0.02, -0.01, 0.03]), np.array([1e-3, -2e-3, 5e-4])
    jf = jpack.factors_from_tracks(kf_t, ids, obs, *imu, CFG, jlayout(CFG), ba, bg, g_norm=9.8)
    tcfg = port_config(CFG)
    tf = tpack.factors_from_tracks(kf_t, ids, obs, *imu, tcfg, tlayout(tcfg), ba, bg, g_norm=9.8,
                                   device="cpu")
    assert float(tf.pt_valid.sum()) == CFG.max_features  # the capacity is full
    assert_same(tf, jf)


@pytest.mark.parametrize("packer", ["gt_window_state", "factors_from_synthetic",
                                    "factors_from_tracks"])
def test_packers_default_to_the_card(seqs, packer):
    """`device=None` is the card: without one the packer raises, with one its
    output lies there; nothing falls back to the CPU."""
    tseq, _ = seqs
    tcfg = port_config(CFG)
    lay = tlayout(tcfg)
    if packer == "factors_from_tracks":
        ids, obs = _tracks(tseq, FRAMES, np.random.default_rng(2))
        imu = [x.numpy() for x in (tseq.imu_t, tseq.imu_acc, tseq.imu_gyr)]
        call = lambda: tpack.factors_from_tracks(  # noqa: E731
            tseq.frame_t.numpy()[FRAMES], ids, obs, *imu, tcfg, lay, np.zeros(3), np.zeros(3))
    elif packer == "factors_from_synthetic":
        call = lambda: tpack.factors_from_synthetic(tseq, FRAMES, tcfg, lay)[1]  # noqa: E731
    else:
        call = lambda: tpack.gt_window_state(tseq, FRAMES, tcfg)  # noqa: E731
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    else:
        assert all(a.is_cuda for a in call())
