"""Hamming distances of packed 256-bit descriptors in NumPy: popcount of
the xor, word by word."""
from __future__ import annotations

import numpy as np

_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


def hamming_matrix(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """[n1, words] × [n2, words] of 32-bit words → [n1, n2] int64 distances."""
    a = np.ascontiguousarray(d1).view(np.uint32)
    b = np.ascontiguousarray(d2).view(np.uint32)
    x = (a[:, None, :] ^ b[None, :, :]).view(np.uint8)
    return _POP8[x].sum(axis=-1)
