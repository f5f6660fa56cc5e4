"""The copied roofline arithmetic against hand counts."""
import torch

from plbench import bounds


def test_hamming_bound_by_hand():
    # 64 x 64: bytes 4 * (512 + 512 + 4096) = 20480; 2 * 256 * 4096 operations
    b = bounds.hamming_bound_s(64, 64)
    assert abs(b - 20480 / 3.35e12) < 1e-18
    assert 2 * 256 * 64 * 64 / 1979e12 < b  # the bytes bound it


def test_lk_bound_by_hand():
    """One point in the middle of a one-level 64 x 64 image: its 24 x 24
    template window and 30 x 30 search window, and the operation count."""
    img = torch.rand(64, 64, dtype=torch.float64)
    pts = torch.tensor([[32.0, 32.0]], dtype=torch.float64)
    valid = torch.ones(1, dtype=torch.bool)
    b = bounds.lk_bound_s([img], [img], pts, valid)
    n_bytes = 22 + 4 * (24 * 24 + 30 * 30)
    n_ops = 7 * 23 ** 2 + 10 * 21 ** 2 + 12 * 10 * 21 ** 2 + 9 * 21 ** 2
    assert abs(b - max(n_bytes / 3.35e12, n_ops / 67e12)) < 1e-18
