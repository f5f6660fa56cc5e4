"""plslam_torch — the PyTorch / CUDA port of plslam for one NVIDIA H100.

Mirrors `plslam/`'s layout and names (`plslam_torch/utils/geometry.py` ↔
`plslam/utils/geometry.py`, ...). It imports torch and never JAX, and
shares nothing with `plslam`: the JAX-free modules it needs (`config.py`,
`models/feature_table.py`, `io/euroc.py`, `io/native.py`,
`utils/quat_np.py`, the ATE of `eval/metrics.py`) are its own copies.

The slices ported so far are the streaming EuRoC pipeline with points and
lines, its loop closure (keyframe DB, BRIEF search, 4-DoF pose graph and
the relocalization round trip; `runner.run_euroc` runs it when
`config.loop.loop_closure` is set, the default) and the synthetic runner.
Burst mode (`run_euroc(burst>0)`) is not ported.
Its entry points run on the card unless given `device="cpu"`. The TPU
kernels are hand-written Hopper kernels: the pyramidal LK tracker
(`csrc/lk.cu`, wrapper `ops/kernels/lk.py`) and the packed-bit Hamming
matcher (`csrc/hamming.cu`, wrapper `ops/kernels/hamming.py`) of the
binary line descriptors and of the loop search's BRIEF descriptors,
built by `ops/kernels/_build.py`.
"""

__version__ = "0.2.0"
