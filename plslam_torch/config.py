"""The system's configuration, shared with the JAX package.

`plslam/config.py` holds plain frozen dataclasses and imports no JAX, so the
port uses those classes as they are: one definition keeps the two packages'
settings and defaults equal. Code of the port (and `chip_smoke.py`) imports
them from here, so that this module is the one place where the port reaches
into `plslam`'s configuration.
"""
from plslam.config import (CameraConfig, ExtrinsicConfig, ImuConfig, LoopConfig, PLSlamConfig,
                           SolverConfig, TemporalConfig, TrackerConfig)

__all__ = ["CameraConfig", "ExtrinsicConfig", "ImuConfig", "LoopConfig", "PLSlamConfig",
           "SolverConfig", "TemporalConfig", "TrackerConfig"]
