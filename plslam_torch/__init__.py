"""plslam_torch — the PyTorch / CUDA port of plslam for one NVIDIA H100.

Mirrors `plslam/`'s layout and names (`plslam_torch/utils/geometry.py` ↔
`plslam/utils/geometry.py`, ...). It imports torch and never JAX; it shares
only the JAX-free host modules `plslam.config` (through `plslam_torch.config`),
`plslam.models.feature_table`, `plslam.io.euroc` and `plslam.io.native` (with
`native/`). `utils/quat_np.py` and the ATE of `eval/metrics.py` are copies.

The slice ported so far is the points-only streaming EuRoC pipeline
(`runner.run_euroc(use_lines=False, loop_closure=False)`) and the synthetic
runner; the pyramidal LK tracker is a hand-written Hopper kernel
(`csrc/lk.cu`, wrapper `ops/kernels/lk.py`).
"""

__version__ = "0.1.0"
