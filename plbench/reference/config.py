"""The solver settings the frozen solver stack reads (a copy of the port's
`SolverConfig` fields)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SolverConfig:
    window_size: int = 10
    max_num_iterations: int = 8
    max_solver_time: float = 0.04
    keyframe_parallax: float = 10.0
    focal_length: float = 460.0
    max_features: int = 192
    max_line_feats: int = 64
    cauchy_c: float = 1.0
    lm_lambda_init: float = 1e-4
    lm_lambda_min: float = 1e-9
    lm_lambda_max: float = 1e2
    eig_eps: float = 1e-8
    dtype: str = "float32"
    line_param: str = "world"
