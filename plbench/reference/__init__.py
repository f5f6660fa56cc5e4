"""The plain reference the benchmark holds the port against.

Plain PyTorch and NumPy, no kernel, no CUDA graph, run in float64 on the
CPU once the measured window has closed. It imports neither JAX nor the JAX
package nor anything of the port (`plslam_torch`): the solver stack
(`geometry`, `lines`, `imu`, `state`, `residuals`, `solver`,
`triangulate`, `marginalization`) is a frozen copy of the port's plain torch
code as it stood when the benchmark was defined, with its imports pointed
here and the CUDA-graph path taken out; `backend.py` is a frozen copy of the
estimator's per-frame backend tick. `lk.py`, `hamming.py` and `pgo.py` are
the plain versions of the two kernels and of the 4-DoF pose-graph solve.
"""
