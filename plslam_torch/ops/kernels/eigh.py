"""Symmetric eigendecompositions in float64, queued on the card without a
host wait (`plslam_torch/csrc/eigh.cu`).

`torch.linalg.eigh` on a CUDA tensor runs one matrix through cuSOLVER's
`syevd`, which copies to pageable host memory inside the call, and reads
LAPACK's `info` back to the host after every call to raise on a failure:
each call waits for all the work queued before it. `eigh_queued` calls
`cusolverDnXsyevBatched`, the driver torch takes for a batch, which stays on
the card for a batch of one too and gives torch's bits at the
marginalization's sizes, and returns `info` as a device tensor that nothing
here reads; the caller folds it into a flag that reaches the host with a
readback it makes anyway (`marginalization.eigh_failed`). It replaces no
TPU kernel (XLA's eigh raises nothing); the plain version, which the CPU
takes, is `torch.linalg.eigh`. `info` is the one torch's own check reads: a
NaN planted in the marginalization's matrices gives a nonzero `info` for
each single matrix and for some of a batch (`scripts/marg_eigh_time.py`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from plslam_torch.ops.kernels import _build

_FN = None  # the bound C entries (decompose, workspace sizes), after the first call
_WORKSPACE: dict = {}  # (device, n, batch) -> (device bytes, host bytes, host buffer or None)


def _bind():
    global _FN
    if _FN is None:
        p, i, lg, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_size_t
        _FN = (_build.bind("plslam_eigh_f64", (i, p, p, lg, lg, p, sz, p, sz, p, p)),
               _build.bind("plslam_eigh_f64_workspace", (i, lg, lg, p, p, p, p)))
    return _FN


def eigh_queued(M: torch.Tensor):
    """(w [..., n], V [..., n, n], info [batch] int32) of the symmetric float64
    CUDA matrices M [..., n, n], as `torch.linalg.eigh(M)` gives (w, V):
    eigenvalues ascending, eigenvectors in V's columns (V is a transposed
    view, as torch's). Only the lower triangle is read. `info` is 0 where a
    decomposition succeeded; it stays on the device."""
    if not M.is_cuda or M.dtype != torch.float64:
        raise ValueError(f"eigh_queued: need a float64 CUDA tensor, got {M.dtype} on {M.device}")
    if M.ndim < 2 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"eigh_queued: expected [..., n, n], got {tuple(M.shape)}")
    n, lead = M.shape[-1], M.shape[:-2]
    batch = math.prod(lead)
    dev = M.get_device()
    a = M.reshape(batch, n, n).clone(memory_format=torch.contiguous_format)
    w = a.new_empty((batch, n))
    info = torch.empty((batch,), dtype=torch.int32, device=M.device)
    if batch and n:
        run, size = _bind()
        key = (dev, n, batch)
        if key not in _WORKSPACE:
            d_bytes, h_bytes = ctypes.c_size_t(0), ctypes.c_size_t(0)
            rc = size(dev, n, batch, a.data_ptr(), w.data_ptr(), ctypes.addressof(d_bytes),
                      ctypes.addressof(h_bytes))
            if rc != 0:
                raise RuntimeError(f"eigh workspace query (n={n}, batch={batch}) failed: "
                                   f"status {rc}")
            # none at the marginalization's sizes; kept for the process where one is asked for
            host = (torch.empty((h_bytes.value,), dtype=torch.uint8, pin_memory=True)
                    if h_bytes.value else None)
            _WORKSPACE[key] = (d_bytes.value, h_bytes.value, host)
        d_bytes, h_bytes, host = _WORKSPACE[key]
        work = torch.empty((max(d_bytes, 1),), dtype=torch.uint8, device=M.device)
        rc = run(dev, a.data_ptr(), w.data_ptr(), n, batch, work.data_ptr(), d_bytes,
                 host.data_ptr() if host is not None else None, h_bytes, info.data_ptr(),
                 torch._C._cuda_getCurrentRawStream(dev))
        if rc != 0:
            raise RuntimeError(f"eigh (n={n}, batch={batch}) failed to queue: status {rc}")
    # row j of the result is eigenvector j: V = aᵀ
    return w.reshape(*lead, n), a.transpose(-1, -2).reshape(*lead, n, n), info
