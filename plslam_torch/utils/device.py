"""Device policy of the port: true fp32 matmuls, cuSOLVER for small
factorizations, and host arrays copied before they become tensors.

* TF32 is off for matmuls and for cuDNN, set once when this module is
  imported. The estimator's whitened residual stacks, JᵀJ/Schur assembly and
  covariance propagation lose about three decimal digits in TF32, which
  compounds through the window solve: the JAX reference measured ATE 0.761 m
  with reduced-precision matmuls against 0.301 m in true f32 on the same
  rendered sequence (`plslam/utils/device.py::highest_matmul_precision`).
* `torch.from_numpy` ALIASES host memory. The estimator mutates its host
  tables in place between a solve and the marginalization; an aliased tensor
  would then see the post-mutation values. `astensor` always copies first
  (the same trap `plslam/utils/device.py::asdev` fixed).
"""
from __future__ import annotations

import numpy as np
import torch

from plslam_torch.utils import timers

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if torch.cuda.is_available():
    # small batched Cholesky factor/solve through cuSOLVER, never MAGMA:
    # cuSOLVER runs on the current stream without host synchronisation, so
    # the LM solve can be captured as a CUDA graph
    torch.backends.cuda.preferred_linalg_library("cusolver")


def astensor(x, dtype=None, device=None) -> torch.Tensor:
    """A tensor that owns its memory: host data is copied before conversion."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype or x.dtype, device=device or x.device).clone()
    arr = np.array(x)  # copy
    t = torch.from_numpy(arr)
    return t.to(dtype=dtype or t.dtype, device=device)


class HostCopy:
    """Device tensors on their way to the host: each is copied to pinned
    memory without blocking, on the current stream, and one event marks the
    end of them all; `get()` waits for that event and returns
    `unpack(*arrays)` (the numpy arrays themselves without `unpack`). CPU
    tensors are taken as they are. Each `get()` and `get_joint()` counts one
    `host_wait` in the tracer."""

    def __init__(self, *tensors: torch.Tensor, unpack=None):
        self._unpack = unpack
        self._event = None
        if tensors[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = list(tensors)

    def get(self):
        timers.count("host_wait")
        if self._event is not None:
            self._event.synchronize()
        return self._arrays()

    def _arrays(self):
        arrays = [h.numpy() for h in self._host]
        return self._unpack(*arrays) if self._unpack is not None else arrays

    @staticmethod
    def get_joint(*handles: "HostCopy") -> list:
        """`get()` of several handles made in this order on one stream, with
        one wait: the last handle's event follows every earlier copy."""
        timers.count("host_wait")
        if handles[-1]._event is not None:
            handles[-1]._event.synchronize()
        return [h._arrays() for h in handles]


def resolve_device(device) -> torch.device:
    """`device=None` means the card (`cuda`); anything else is taken as
    given. There is no fallback: without CUDA, `None` raises, and a caller
    that wants the CPU says `device="cpu"`."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by default; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda")
