"""Where an LK track's time goes on the card, for both formulations, at the
main path's shapes (the inputs of `chip_smoke.py`'s phase 3: 752×480,
4 levels, 150 features).

Per formulation: the kernel against its plain version (positions 1e-3 px
where both track), the time per track by CUDA events over 200 tracks and
the device time per launch by torch.profiler, twice; then the device time
with 0, 1, 5 and 10 Gauss-Newton steps a level, which splits a track into
the steps and the rest (windows, template, residual, launch). Prints the
card, `ptxas`'s registers and shared memory of each instantiation, one line
per timing, and a JSON line of the results.

Run from the repository root on a machine with the card:

    python3 scripts/lk_steps.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POS_TOL_PX = 1e-3


def main():
    import torch

    from plslam_torch.ops.kernels import _build, lk
    from plslam_torch.utils.measure import card_info, cuda_time_ms, device_us, lk_inputs

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    dev = torch.device("cuda", 0)
    print(card_info(), flush=True)
    so = _build.build()
    with open(so + ".log") as fh:
        for line in fh:
            if "lk_track_kernel" in line or "registers" in line:
                print("ptxas:", line.rstrip())
    pyr1, pyr2, pts, valid, _ = lk_inputs(dev)
    args = (pyr1, pyr2, pts, valid)
    results = {}
    for formulation in lk.FORMULATIONS:
        plain = lk.lk_track_fast_torch if formulation == "fast" else lk.lk_track_torch
        p_out, p_st, _ = plain(*args)
        k_out, k_st, _ = lk.lk_track_cuda(*args, formulation=formulation)
        torch.cuda.synchronize()
        diff = float((k_out - p_out).abs().amax(dim=1)[k_st & p_st].max())
        if diff > POS_TOL_PX:
            raise AssertionError(f"{formulation}: max |Δpos| {diff:.3e} px")
        for rep in range(2):
            def run(iters=10):
                return lk.lk_track_cuda(*args, iters=iters, formulation=formulation)

            ms = cuda_time_ms(run, reps=200)
            us = device_us(run, "lk_track_kernel")
            print(f"{formulation} (run {rep + 1}): {ms:.5f} ms a track by CUDA events, "
                  f"{us:.2f} µs device time; max |Δpos| {diff:.2e} px", flush=True)
            results.setdefault(f"{formulation}/ms", []).append(ms)
            results.setdefault(f"{formulation}/device_us", []).append(us)
        for iters in (0, 1, 5, 10):
            us = device_us(lambda: run(iters), "lk_track_kernel")
            print(f"{formulation}, {iters} steps a level: {us:.2f} µs device time", flush=True)
            results[f"{formulation}/{iters} steps device_us"] = us
    print(json.dumps(results))


if __name__ == "__main__":
    main()
