"""Packed-bit Hamming distance matrix: the hand-written Hopper kernel
(`plslam_torch/csrc/hamming.cu`) and its plain PyTorch version.

Both compute what the TPU kernel `hamming_matrix_pallas`
(`plslam/ops/kernels/hamming.py`) computes: for 256-bit descriptors packed
into 8 words, `out[i, j] = Σ_w popcount(d1[i, w] ^ d2[j, w])`, [N1,8] ×
[N2,8] → [N1,N2] int32. Descriptors are int32 tensors carrying the uint32 bit
patterns (torch's uint32 lacks most operations); the kernel reads the same
bits as uint32.

The kernel computes popcount(a) + popcount(b) − 2·popcount(a ∧ b) with the
tensor cores' 1-bit product (`mma … .b1.b1.s32.and.popc`); the plain version
popcounts the xor. `hamming_matrix` dispatches on the device of its inputs:
CPU tensors take the plain version, CUDA tensors the kernel (or an error —
there is no fallback). `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from plslam_torch.ops.kernels import _build

WORDS = 8  # 256 bits
LAUNCHES = 0  # kernel launches (plain-version calls do not count)
_MAX_ROWS = 65535 * 32  # the kernel's grid.y limit (32-row tiles), in descriptors of d1
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)
_FN = None  # the bound C entry, after the first launch


# ---------------------------------------------------------------- plain torch
def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32). (torch has no popcount;
    the words are widened and masked first because `>>` on a negative int32
    is an arithmetic shift.)"""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix_torch(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[N1,8] × [N2,8] 32-bit words → [N1,N2] int32 Hamming distances, on any device."""
    a = d1.to(torch.int64) & 0xFFFFFFFF
    b = d2.to(torch.int64) & 0xFFFFFFFF
    return popcount32(a[:, None, :] ^ b[None, :, :]).sum(dim=-1).to(torch.int32)


# --------------------------------------------------------------- CUDA kernel
def _check(t, name):
    if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous int32 CUDA tensor, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if t.ndim != 2 or t.shape[1] != WORDS:
        raise ValueError(f"{name}: expected shape [N,{WORDS}], got {tuple(t.shape)}")


def hamming_matrix_cuda(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[N1,8] × [N2,8] int32 words on the card → [N1,N2] int32, through
    `plslam_hamming_u32x8`. The host path is the call's pace at the line
    matcher's 64×64 (a launch takes ~1.3 µs of device time), so it makes no
    object it does not need: device indices, not `torch.device`s; the raw
    handle of PyTorch's current stream, not a `Stream`; the C entry bound
    once."""
    global LAUNCHES, _FN
    _check(d1, "d1")
    _check(d2, "d2")
    dev = d1.get_device()
    if d2.get_device() != dev:
        raise ValueError(f"d1 and d2 must be on one device, got {d1.device} and {d2.device}")
    n1, n2 = d1.size(0), d2.size(0)
    if n1 > _MAX_ROWS:
        raise ValueError(f"d1: at most {_MAX_ROWS} descriptors, got {n1}")
    out = d1.new_empty((n1, n2))  # int32 on d1's device
    if n1 == 0 or n2 == 0:
        return out
    if _FN is None:
        _FN = _build.bind("plslam_hamming_u32x8", _ARGTYPES)
    rc = _FN(d1.data_ptr(), d2.data_ptr(), out.data_ptr(), n1, n2,
             torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"hamming kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if d1.is_cuda:
        return hamming_matrix_cuda(d1, d2)
    if d1.device.type != "cpu":
        raise ValueError(f"hamming_matrix: unsupported device {d1.device}")
    return hamming_matrix_torch(d1, d2)
