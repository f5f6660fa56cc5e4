"""The marginalization's eigendecompositions on the card, three ways: queued
in float64 with cuSOLVER's `info` left on the card (the port's path,
`plslam_torch/ops/kernels/eigh.py`), in float64 through `torch.linalg.eigh`
(which reads `info` back to the host after every call, so each call waits
for the work queued before it), and in float32 through `torch.linalg.eigh`
(the port's path before the decompositions moved to float64).

The smoke's solver capacities (window 10, 192 features, 64 line slots;
`chip_smoke.smoke_config`) give a 178-wide camera block. `marginalize_old`
(every keyframe) then decomposes, through `_pinv_psd` and
`_sqrt_refactor`: the 64 lines' 4×4 blocks (one batched call), frame 0's
15×15 pose + speedbias block, and the kept 163×163 system;
`marginalize_second_new` (a published frame that is not a keyframe) a
6×6 block and the kept 172×172 system. The inputs are float32, Jacobi-scaled (unit
diagonal) and rank-deficient like the marginalization's: half the line
blocks zero (unobserved slots) and 87 zero rows in the 163×163 system, from
a seed.

Part 1, each of those matrices in float64, queued (`eigh.eigh_queued`) and
through `torch.linalg.eigh`: the host ms of one call queued behind a card
kept busy for 100 ms (`measure.host_ms_behind_busy_card`; a call that waits
takes ~100 ms and finds the card idle), the device ms by CUDA events and the
device kernels that the profiler names (torch's tell which driver it took);
for the queued path whether it gives `torch.linalg.eigh`'s eigenvalues and
eigenvectors bit for bit, the widest eigenvalue gap, the widest entry of
V diag(w) Vᵀ − M and of VᵀV − I and the `info` of the matrix with a NaN
planted; for torch's, what it does with that matrix.
Part 2, the sets of each marginalization: host ms behind the busy card
and device ms by CUDA events (the mean over 50 sets after 5), the three
paths in turns (queued, float64, float32, float32, float64, queued), and
the paths' results against the float64 library path's.

Run from the repository root on a machine with the card:

    python3 scripts/marg_eigh_time.py
"""
import json
import os
import sys
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUSY_MS = 100.0


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


def _kernel_names(fn):
    """The distinct device kernels that one call of `fn` launches, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA})
    return [n[:60] for n in names]


def drivers(mats):
    """Part 1: {matrix: {path: readings}}."""
    import torch

    from plslam_torch.ops.kernels import eigh as ek
    from plslam_torch.utils.measure import cuda_time_ms, host_ms_behind_busy_card

    out = {}
    for name, M in mats.items():
        n, batch = M.shape[-1], (M.shape[0] if M.ndim == 3 else 1)
        bad = M.clone()
        bad[..., 0, 0] = float("nan")
        wt, Vt = torch.linalg.eigh(M)
        row = {}
        for path, fn in (("queued", lambda: ek.eigh_queued(M)),
                         ("torch.linalg.eigh", lambda: torch.linalg.eigh(M))):
            fn()
            host_ms, busy = host_ms_behind_busy_card(fn, BUSY_MS)
            r = {"host_ms": round(host_ms, 4), "card_still_busy": busy,
                 "device_ms": round(cuda_time_ms(fn, reps=20, warmup=2), 4),
                 "kernels": _kernel_names(fn)}
            if path == "torch.linalg.eigh":
                try:
                    wb, _ = torch.linalg.eigh(bad)
                    r["nan_input"] = f"returned, eigenvalues finite: {bool(torch.isfinite(wb).all())}"
                except Exception as e:  # noqa: BLE001  (what torch does is the reading)
                    r["nan_input"] = f"raised {type(e).__name__}"
            else:
                w, V, _ = ek.eigh_queued(M)
                wb, _, info = ek.eigh_queued(bad)
                eye = torch.eye(n, dtype=M.dtype, device=M.device)
                r.update(same_as_torch=bool(torch.equal(w, wt) and torch.equal(V, Vt)),
                         eigenvalue_gap=float((w - wt).abs().max()),
                         residual=float(((V * w[..., None, :]) @ V.mT - M).abs().max()),
                         orthogonality=float((V.mT @ V - eye).abs().max()),
                         nan_info=sorted(set(info.tolist())))
            row[path] = r
            print(f"{name} [{batch}×{n}×{n}] {path}: {json.dumps(r)}", flush=True)
        out[name] = row
    return out


def main():
    import torch

    from plslam_torch.config import SolverConfig
    from plslam_torch.models import marginalization as marg
    from plslam_torch.models.state import layout
    from plslam_torch.utils.measure import card_info, cuda_time_ms, host_ms_behind_busy_card

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    dev = torch.device("cuda", 0)
    print(card_info(), torch.__version__, torch.version.cuda, flush=True)
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
    sym64 = lambda M: (0.5 * (M + M.transpose(-1, -2))).to(torch.float64)  # noqa: E731
    results = {"drivers": drivers({
        "old.Cb": sym64(old["Cb"]), "old.H_dd": sym64(old["H_dd"]), "old.H_k": sym64(old["H_k"]),
        "new.H_dd": sym64(new["H_dd"]), "new.H_k": sym64(new["H_k"])})}

    def marginalize_old(infos):
        return (marg._pinv_psd(old["Cb"], eps, infos), marg._pinv_psd(old["H_dd"], eps, infos),
                *marg._sqrt_refactor(old["H_k"], old["b_k"], eps, infos))

    def marginalize_second_new(infos):
        return (marg._pinv_psd(new["H_dd"], eps, infos),
                *marg._sqrt_refactor(new["H_k"], new["b_k"], eps, infos))

    def library(dtype):
        def eigh_sym(M, infos=None):  # `_eigh_sym` through torch.linalg.eigh in `dtype`
            w, V = torch.linalg.eigh((0.5 * (M + M.transpose(-1, -2))).to(dtype))
            return w.to(M.dtype), V.to(M.dtype)
        return eigh_sym

    paths = {"queued": None, "float64": library(torch.float64), "float32": library(torch.float32)}

    def run(path, fn):
        if paths[path] is None:
            return fn([])
        with mock.patch.object(marg, "_eigh_sym", paths[path]):
            return fn(None)

    for name, fn in (("marginalize_old", marginalize_old),
                     ("marginalize_second_new", marginalize_second_new)):
        ref = run("float64", fn)
        times = {p: {"host_ms": [], "device_ms": []} for p in paths}
        rel = {}
        for path in paths:
            out = run(path, fn)
            torch.cuda.synchronize()
            # J's rows are eigenvectors (sign and order free): compare what they
            # mean, the pseudo-inverses and JᵀJ / Jᵀr
            pairs = list(zip(ref[:-2], out[:-2]))
            (J, r), (Jo, ro) = ref[-2:], out[-2:]
            pairs += [(J.T @ J, Jo.T @ Jo), (J.T @ r, Jo.T @ ro)]
            rel[path] = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
                            for a, b in pairs)
        for path in (*paths, *reversed(paths)):
            host_ms, busy = host_ms_behind_busy_card(lambda: run(path, fn), BUSY_MS)
            ms = cuda_time_ms(lambda: run(path, fn))
            times[path]["host_ms"].append(round(host_ms, 4))
            times[path]["device_ms"].append(round(ms, 4))
            print(f"{name}: {path}: {host_ms:.4f} ms host behind a busy card (still busy: {busy}), "
                  f"{ms:.4f} ms a set by CUDA events", flush=True)
        print(f"{name}: largest difference from the float64 library path, of its scale: "
              f"{json.dumps(rel)}", flush=True)
        results[name] = {**times, "max_rel_diff": rel}
    print(json.dumps(results))


if __name__ == "__main__":
    main()
