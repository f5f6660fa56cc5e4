"""Timing and profiling utilities.

Counterpart of `plslam/utils/timers.py` (the reference's `TicToc` stopwatch
and `printStatistics()`). Device work is asynchronous, so a timed section
that launched work on the card synchronizes that card before its clock
stops (`timed(name, sync=...)`, the counterpart of `jax.block_until_ready`);
`profiler_trace` wraps `torch.profiler` around a section and writes a Chrome
trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.utils import _pytree as pytree


def _synchronize(sync):
    """Wait for every CUDA device that holds a tensor of `sync` (a tensor or
    a nested tuple / list / dict / NamedTuple of them)."""
    devices = {t.device for t in pytree.tree_leaves(sync)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class Timers:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def timed(self, name: str, sync=None):
        """Time a section; the devices of the tensors in `sync` (optional) are
        synchronized before the clock stops, so their work is included."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _synchronize(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> dict:
        return {
            k: {"total_s": round(self.totals[k], 4), "n": self.counts[k],
                "mean_ms": round(1e3 * self.totals[k] / max(self.counts[k], 1), 3)}
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        """`printStatistics` equivalent."""
        return "\n".join(f"{k:28s} n={v['n']:5d} mean={v['mean_ms']:8.3f} ms total={v['total_s']:8.3f} s"
                         for k, v in self.summary().items())


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Capture a torch.profiler trace of a section (host and, with a card,
    device activity) into `<logdir>/trace.json` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
