"""The Hamming kernel's times on the card, for one source tree, at the shapes
its callers run: 64×64 (the line matcher, once per published frame),
128×256 (the loop-closure search: at most MAX_KP // 2 window descriptors
against MAX_KP corners), 150×90 (ragged edges), and 1000×1000 and
2000×2000 (throughput: their difference is the time of 12 MB more output).

Per shape: the kernel against its plain version, bit for bit, on inputs
with the extreme rows; the device time per launch (torch.profiler, 50
launches); the host time per wrapper call (`time.perf_counter` over 2,000
calls with no synchronize, the fastest of 3 rounds); and by CUDA events
the time per call of the kernel and of the two PyTorch library calls that
compute the same function once the bits are unpacked (checked bit for bit;
the unpacking timed apart), 5 rounds of 200 back-to-back calls taken in
turns: the mean over the rounds and the fastest round. Prints the card,
`ptxas`'s lines for the Hamming kernel, one line per shape and a JSON line
of the results.

`--root DIR` imports `plslam_torch` (the kernel, its wrapper and its build)
from another checkout, such as the parent commit unpacked with `git
archive`; the measuring helpers always come from this script's own tree, so
two trees are timed by the same code. Run from the repository root on a
machine with the card, the two trees in turns:

    python3 scripts/hamming_time.py --root PARENT --label parent
    python3 scripts/hamming_time.py --label change
"""
import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((64, 64), (128, 256), (150, 90), (1000, 1000), (2000, 2000))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose plslam_torch is timed")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    from plslam_torch.ops.kernels import _build, hamming

    spec = importlib.util.spec_from_file_location(
        "hamming_time_measure", os.path.join(HERE, "plslam_torch", "utils", "measure.py"))
    measure = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(measure)

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    if not os.path.samefile(os.path.dirname(hamming.__file__),
                            os.path.join(args.root, "plslam_torch", "ops", "kernels")):
        raise RuntimeError(f"imported {hamming.__file__}, not the tree under {args.root}")
    dev = torch.device("cuda", 0)
    print(f"{args.label}: {measure.card_info()}; torch {torch.__version__}", flush=True)
    so = _build.build()
    source = None
    with open(so + ".log") as fh:
        for line in fh:
            if line.startswith("[") and line.rstrip().endswith(".cu]"):
                source = line.strip()
            elif source == "[hamming.cu]" and ("registers" in line or "hamming_kernel" in line):
                print(f"{args.label} ptxas: {line.strip()}", flush=True)
    rng = np.random.default_rng(5)
    results = {"label": args.label, "card": measure.card_info()}
    for n1, n2 in SHAPES:
        a, b = measure.hamming_inputs(rng, n1, n2, dev)
        k = hamming.hamming_matrix_cuda(a, b)
        torch.cuda.synchronize()
        if not torch.equal(k, hamming.hamming_matrix_torch(a, b)):
            raise AssertionError(f"{args.label}: kernel disagrees with its plain version at {n1}×{n2}")

        def call():
            return hamming.hamming_matrix_cuda(a, b)

        us = measure.device_us(call, "hamming_kernel")
        host = measure.host_us(call)
        calls, unpack_ms = measure.hamming_library(a, b)
        rounds = measure.ms_in_turns({"kernel": call, **calls})
        mean = {name: sum(r) / len(r) for name, r in rounds.items()}
        fastest = {name: min(r) for name, r in rounds.items()}
        results[f"{n1}x{n2}"] = {"device_us": us, "host_us": host, "unpack_ms": unpack_ms,
                                 "event_ms_mean": mean, "event_ms_fastest": fastest}
        print(f"{args.label} {n1}×{n2}: bit-exact; {us:.3f} µs device time, {host:.2f} µs host "
              f"time a call; by CUDA events (mean | fastest round) "
              + ", ".join(f"{name} {mean[name]:.5f} | {fastest[name]:.5f} ms" for name in rounds)
              + f" (unpacking {unpack_ms:.5f} ms)", flush=True)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
