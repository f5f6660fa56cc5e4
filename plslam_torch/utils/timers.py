"""Timing and profiling utilities, and the port's tracer.

Counterpart of `plslam/utils/timers.py` (the reference's `TicToc` stopwatch
and `printStatistics()`). Device work is asynchronous, so a timed section
that launched work on the card synchronizes that card before its clock
stops (`timed(name, sync=...)`, the counterpart of `jax.block_until_ready`);
`profiler_trace` wraps `torch.profiler` around a section and writes a Chrome
trace.

The tracer: the port opens `span("layer.stage")` around each stage of its
run path and `count(name)` where it reads the card back (`host_wait`) or
where an event worth counting happens. Both do nothing until `enable()`:
`span` then reads one flag and returns a shared object that does nothing.
Enabled, a span stamps `time.perf_counter_ns()` at entry and exit and keeps
its name, its parent span on the same thread, its thread and its frame (the
camera frame's time set by `frame(t)`, or the one the caller gives, or its
parent's). While a torch profiler runs, each span also opens
`torch.profiler.record_function("plslam.<name>")`, so that a profile (and
the Chrome trace of `profiler_trace`) shows the program's ranges on the
profiler's own clock, beside the device work they launched. `records()`
returns what was kept; `reset()` drops it.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils import _pytree as pytree


class SpanRecord(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns() at entry
    end_ns: int  # and at exit
    id: int  # in the order the spans were entered
    parent: Optional[int]  # id of the enclosing span on the same thread
    thread: int  # threading.get_ident()
    frame: Optional[float]  # the frame's time


class CountRecord(NamedTuple):
    name: str
    t_ns: int  # time.perf_counter_ns() at the count
    n: int
    thread: int
    frame: Optional[float]


_on = False  # the one flag a disabled span reads
_frame: Optional[float] = None
_spans: list = []
_counts: list = []
_ids = itertools.count()
_local = threading.local()  # .stack: the open spans of this thread


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "frame", "id", "parent", "start", "_rf")

    def __init__(self, name, frame):
        self.name, self.frame = name, frame

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer is not None else None
        if self.frame is None:
            self.frame = outer.frame if outer is not None else _frame
        self.id = next(_ids)
        stack.append(self)
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function("plslam." + self.name)
            self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _local.stack.pop()
        _spans.append(SpanRecord(self.name, self.start, end, self.id, self.parent,
                                 threading.get_ident(), self.frame))
        return False


def span(name: str, frame: Optional[float] = None):
    """A context manager around one stage, named `layer.stage`. Recorded only
    while the tracer is enabled; `frame` defaults to the enclosing span's
    frame on this thread, else to the one `frame()` set."""
    if not _on:
        return _NO_SPAN
    return _Span(name, frame)


def count(name: str, n: int = 1):
    """Add `n` to the counter `name`, tagged with the innermost open span's
    frame on this thread (else the one `frame()` set). Only while enabled."""
    if not _on:
        return
    stack = getattr(_local, "stack", None)
    fr = stack[-1].frame if stack else _frame
    _counts.append(CountRecord(name, time.perf_counter_ns(), n, threading.get_ident(), fr))


def frame(t: float):
    """The frame whose work follows: the spans and counts that name no frame
    and have no enclosing span carry its time."""
    global _frame
    _frame = float(t)


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def reset():
    """Drop every record and the current frame (the flag stays as it is)."""
    global _frame, _ids
    _frame = None
    _spans.clear()
    _counts.clear()
    _ids = itertools.count()


def records() -> dict:
    """{"spans": [SpanRecord] in the order they were entered, "counts":
    [CountRecord] in the order they were made}."""
    return {"spans": sorted(_spans, key=lambda s: s.id), "counts": list(_counts)}


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
        synchronized before the clock stops, so their work is included. The
        section is also a tracer span of the same name."""
        with span(name):
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
    device activity) into `<logdir>/trace.json` (Chrome trace format). With
    the tracer enabled the trace holds the program's spans as `plslam.*`
    ranges."""
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
