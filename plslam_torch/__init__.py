"""plslam_torch — the PyTorch / CUDA port of plslam for one NVIDIA H100.

Mirrors `plslam/`'s layout and names (`plslam_torch/utils/geometry.py` ↔
`plslam/utils/geometry.py`, ...). It imports torch and never JAX, and
shares nothing with `plslam`: the JAX-free modules it needs (`config.py`,
`models/feature_table.py`, `io/euroc.py`, `io/native.py`,
`utils/quat_np.py`, `eval/metrics.py`, `eval/viz.py`, the host half of
`ops/calibration.py`) are its own copies.

The slices ported so far:
  A. the math core and the sliding-window estimator (`run_synthetic`);
  B. the visual-inertial initializer;
  C. the point and line frontends, and the streaming EuRoC pipeline
     `runner.run_euroc`;
  D. loop closure: keyframe DB, BRIEF search, 4-DoF pose graph and the
     relocalization round trip (on when `config.loop.loop_closure` is set,
     the default);
  E. offline burst replay (`run_euroc(burst=B)`);
  G. the tools around `run_euroc`: the command line
     (`python -m plslam_torch run|eval|parity`), estimator checkpoints in
     the JAX package's npz format (`io/checkpoint.py`), intrinsic
     calibration (`ops/calibration.py`), the track and loop-match
     visualizer (`eval/viz.py`, `tracker.show_track`), ATE / RPE and TUM
     files (`eval/metrics.py`), timers and the JSONL metrics log (`utils/`);
  F. the parallel solvers (`parallel/`: batched window solves, landmark-
     sharded BA, keyframe-partitioned consensus, the (kf_part, lmk) grid,
     the process group over `torch.distributed`), the window packers
     (`models/packing.py`) and the large-window runners
     (`runner.run_synthetic_large_window`, `run_euroc_large_window`);
  H. the structured normal-equation assembly (`models/assembly.py`,
     `solver.optimize_window(structured=True)`: per-factor local jacobians
     and one scatter-add per factor type) and the last helpers
     (`cameras.pixel_to_normalized`, `lines.trim_line_to_segment`,
     `imu.preintegrate_sequential`, `geometry.so3_log`,
     `Estimator.imu_rate_pose`).
The port has a counterpart of every function, class and method of
`plslam/`, apart from the TPU-only code and the Pallas kernels that
`tests/test_torch_coverage.py` lists with their stand-ins.
Its entry points run on the card unless given `device="cpu"`. The TPU
kernels are hand-written Hopper kernels: the pyramidal LK tracker
(`csrc/lk.cu`, wrapper `ops/kernels/lk.py`) and the packed-bit Hamming
matcher (`csrc/hamming.cu`, wrapper `ops/kernels/hamming.py`) of the
binary line descriptors and of the loop search's BRIEF descriptors,
built by `ops/kernels/_build.py`.
"""

__version__ = "0.4.0"
