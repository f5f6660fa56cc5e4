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


def resolve_device(device) -> torch.device:
    """`device=None` means the CPU; anything else is taken as given."""
    return torch.device("cpu" if device is None else device)
