"""Carry state across from the JAX package: there are no weights, so what
moves between the two packages is solver state and configuration.

Each function takes the JAX package's NamedTuple converted field by field
with `np.asarray` (any object with the same field names works) and returns
the port's tensors, so a test can hand a mid-run JAX estimator's exact state
to the port.
"""
from __future__ import annotations

import dataclasses

import torch

from plslam_torch.config import PLSlamConfig
from plslam_torch.models.marginalization import Prior
from plslam_torch.models.residuals import WindowFactors
from plslam_torch.models.state import WindowState
from plslam_torch.ops.cameras import cam_from_params
from plslam_torch.utils.device import astensor

_INT_FIELDS = ("pt_start", "ln_start")


def _convert(cls, src, dtype, device):
    return cls(*[astensor(getattr(src, name), torch.int64 if name in _INT_FIELDS else dtype, device)
                 for name in cls._fields])


def window_state_from_numpy(state, dtype=torch.float64, device=None) -> WindowState:
    return _convert(WindowState, state, dtype, device)


def factors_from_numpy(factors, dtype=torch.float64, device=None) -> WindowFactors:
    return _convert(WindowFactors, factors, dtype, device)


def prior_from_numpy(prior, dtype=torch.float64, device=None) -> Prior:
    return _convert(Prior, prior, dtype, device)


def config_from_jax(cfg) -> PLSlamConfig:
    """The port's `PLSlamConfig` with the values of the JAX package's one
    (or of any dataclass tree with the same field names), field by field
    through `dataclasses.asdict`."""
    sections = {f.name: type(f.default) for f in dataclasses.fields(PLSlamConfig)}
    return PLSlamConfig(**{name: sections[name](**value) if isinstance(value, dict) else value
                           for name, value in dataclasses.asdict(cfg).items()})


def camera_from_params(kind, params, dtype=torch.float32, device=None):
    """A camera from `plslam.ops.cameras.cam_to_params(cam)`'s (kind, float64[9])."""
    return cam_from_params(kind, params, dtype=dtype, device=device)
