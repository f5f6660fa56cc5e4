"""Peaks of the card and the least time of each kernel's work, from its
shapes and inputs: the roofline arithmetic of the port's kernel checks,
copied here so that the yardstick does not move with the program.

Peaks: one NVIDIA H100 SXM (data sheet, dense, at the 700 W power limit):
3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor cores, and for the
Hamming matrix the dense INT8 tensor-core rate of 1,979 TOP/s (the data
sheet gives no 1-bit rate) at 2 x 256 operations an output.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12


def bound_s(n_bytes, n_ops, ops_per_s=OPS_PER_S) -> float:
    """Least seconds for the work: the larger of bytes over the memory rate
    and operations over the compute rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def hamming_bound_s(n1: int, n2: int) -> float:
    """[n1,8] x [n2,8] packed 32-bit words → [n1,n2] int32: inputs read once,
    the output written once."""
    return bound_s(4 * (8 * n1 + 8 * n2 + n1 * n2), 2 * 256 * n1 * n2, INT8_OPS_PER_S)


def _distinct(shape, rows, cols) -> int:
    mask = torch.zeros(shape, dtype=torch.bool)
    mask[rows[:, :, None], cols[:, None, :]] = True
    return int(mask.sum())


def _fast_windows(shape, tl_f, side):
    h, w = shape
    r = torch.arange(side)
    tl = torch.clamp(torch.floor(tl_f).long(), min=0)
    tl = torch.minimum(tl, torch.tensor([w - side, h - side]))
    return tl[:, 1:2] + r, tl[:, 0:1] + r


def lk_bound_s(pyr_prev, pyr_cur, pts, valid, iters: int = 10) -> float:
    """Least seconds of one "fast" LK track of `pts` through the pyramids in
    one launch. Bytes: the points and valid flags read, the positions,
    status and err written once, and per level the distinct float32 pixels
    of the 24x24 template windows (previous level, at the point) and of the
    30x30 search windows (current level, at the level's initial guess), each
    pixel once. Operations a level and feature: the 23x23 bilinear template
    samples (7 each), gradients and Hessian over 21x21 (10 each), `iters`
    Gauss-Newton steps over 21x21 (12 each) and the final |I - T| (9 each)."""
    from plbench.reference import lk

    win, half, n, levels = lk.WIN, lk.HALF, pts.shape[0], len(pyr_prev)
    n_bytes = n * (8 + 1 + 8 + 1 + 4)
    for level in range(levels - 1, -1, -1):
        p = pts / 2.0 ** level
        shape = tuple(pyr_prev[level].shape)
        if level == levels - 1:
            g = p
        else:
            sub = 2.0 ** (level + 1)
            g = 2.0 * lk.track(pyr_prev[level + 1:], pyr_cur[level + 1:], pts / sub, valid,
                               iters=iters)[0]
        n_bytes += 4 * (_distinct(shape, *_fast_windows(shape, p - half - 1, lk.S_T))
                        + _distinct(shape, *_fast_windows(shape, g - half - lk.LK_MARGIN, lk.S_C)))
    n_ops = levels * n * (7 * (win + 2) ** 2 + 10 * win ** 2 + 12 * iters * win ** 2
                          + 9 * win ** 2)
    return bound_s(n_bytes, n_ops)
