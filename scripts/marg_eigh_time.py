"""The marginalization's eigendecompositions on the card: in float64, as
`plslam_torch/models/marginalization.py` runs them on float32 inputs,
against float32, as the port ran them before (`torch.linalg.eigh` of the
input's symmetric part in its own dtype), at the smoke's matrix sizes.

The smoke's solver capacities (window 10, 192 features, 64 line slots;
`chip_smoke.smoke_config`) give a 178-wide camera block. `marginalize_old`
(every keyframe) then decomposes, through `_pinv_psd` and
`_sqrt_refactor`: the 64 lines' 4×4 blocks (one batched call), frame 0's
15×15 pose + speedbias block, and the kept 163×163 system;
`marginalize_second_new` (a published frame that is not a keyframe) a
6×6 block and the kept 172×172 system. The inputs are float32, Jacobi-scaled (unit
diagonal) and rank-deficient like the marginalization's: half the line
blocks zero (unobserved slots) and 87 zero rows in the 163×163 system, from
a seed. Each set of calls is timed by CUDA events (the mean over 50 sets
after 5), float64 and float32 in turns (64, 32, 32, 64), and the two
paths' results are compared.

Run from the repository root on a machine with the card:

    python3 scripts/marg_eigh_time.py
"""
import json
import os
import sys
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _scaled_psd(rng, n, rank, zero=0):
    """An n×n float64 PSD matrix of the given rank on the rows it keeps,
    Jacobi-scaled, with `zero` all-zero rows and columns."""
    k = n - zero
    A = rng.standard_normal((k, rank))
    B = A @ A.T
    d = np.sqrt(np.diag(B))
    M = np.zeros((n, n))
    idx = np.sort(rng.choice(n, k, replace=False))
    M[np.ix_(idx, idx)] = B / d[:, None] / d[None, :]
    return M


def main():
    import torch

    from plslam_torch.config import SolverConfig
    from plslam_torch.models import marginalization as marg
    from plslam_torch.models.state import layout
    from plslam_torch.utils.measure import card_info, cuda_time_ms

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    dev = torch.device("cuda", 0)
    print(card_info(), flush=True)
    lay = layout(SolverConfig(max_features=192, max_line_feats=64, window_size=10))
    DC, ML = lay.dim_cam, lay.max_l
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    Cb = np.stack([_scaled_psd(rng, 4, 4) if j % 2 == 0 else np.zeros((4, 4)) for j in range(ML)])
    old = dict(Cb=f32(Cb), H_dd=f32(_scaled_psd(rng, 15, 15)),
               H_k=f32(_scaled_psd(rng, DC - 15, (DC - 15 - 87) // 2, zero=87)),
               b_k=f32(rng.standard_normal(DC - 15)))
    new = dict(H_dd=f32(_scaled_psd(rng, 6, 6)), H_k=f32(_scaled_psd(rng, DC - 6, 120)),
               b_k=f32(rng.standard_normal(DC - 6)))
    eps = marg._eps(SolverConfig(), torch.float32)

    def marginalize_old():
        return (marg._pinv_psd(old["Cb"], eps), marg._pinv_psd(old["H_dd"], eps),
                *marg._sqrt_refactor(old["H_k"], old["b_k"], eps))

    def marginalize_second_new():
        return (marg._pinv_psd(new["H_dd"], eps), *marg._sqrt_refactor(new["H_k"], new["b_k"], eps))

    def in_float32(M):  # the decomposition as it was before it moved to float64
        return torch.linalg.eigh(0.5 * (M + M.transpose(-1, -2)))

    results = {}
    for name, fn in (("marginalize_old", marginalize_old),
                     ("marginalize_second_new", marginalize_second_new)):
        ref = fn()
        with mock.patch.object(marg, "_eigh_sym", in_float32):
            low = fn()
        torch.cuda.synchronize()
        # J's rows are eigenvectors (sign and order free): compare what they
        # mean, the pseudo-inverses and JᵀJ / Jᵀr
        pairs = [(a, b) for a, b in zip(ref[:-2], low[:-2])]
        (J, r), (Jl, rl) = ref[-2:], low[-2:]
        pairs += [(J.T @ J, Jl.T @ Jl), (J.T @ r, Jl.T @ rl)]
        rel = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30) for a, b in pairs)
        times = {"float64": [], "float32": []}
        for path in ("float64", "float32", "float32", "float64"):
            if path == "float64":
                ms = cuda_time_ms(fn)
            else:
                with mock.patch.object(marg, "_eigh_sym", in_float32):
                    ms = cuda_time_ms(fn)
            times[path].append(ms)
            print(f"{name}: decompositions in {path}: {ms:.4f} ms a set by CUDA events", flush=True)
        print(f"{name}: float32 against float64 results, largest difference {rel:.2e} of their "
              f"scale", flush=True)
        results[name] = {**{f"{p}_ms": v for p, v in times.items()}, "max_rel_diff": rel}
    print(json.dumps(results))


if __name__ == "__main__":
    main()
