"""Wall time of building the port's kernels from scratch, two ways, alternated.

`parallel`: `plslam_torch.ops.kernels._build.build()` as the port builds
(one nvcc per `csrc/*.cu`, all started together, then one link).
`single`: one `nvcc -shared` call over all sources with the same flags.
Each build goes into a fresh temporary directory, so nothing is reused.

Run from the repository root on a machine with the CUDA toolkit:

    python3 scripts/kernel_build_time.py [ROUNDS]
"""
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from plslam_torch.ops.kernels import _build  # noqa: E402


def parallel(tmp):
    _build.BUILD_DIR = tmp
    _build.build()


def single(tmp):
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    os.path.join(tmp, "lib.so"), *_build.sources(), *_build.LINK_FLAGS], check=True,
                   capture_output=True)


def main(rounds):
    times = {"parallel": [], "single": []}
    for i in range(rounds):
        order = ("parallel", "single") if i % 2 == 0 else ("single", "parallel")
        for name in order:
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                {"parallel": parallel, "single": single}[name](tmp)
                times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        print(f"{name}: {' '.join(f'{t:.3f}' for t in ts)} s over {len(_build.sources())} sources")
    print(json.dumps(times))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 3)
