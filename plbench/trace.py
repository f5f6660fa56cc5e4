"""What a traced run reads from torch.profiler's device trace.

The profiler runs over the first `trace_s` seconds of the window with CPU
and CUDA activity; the harness's spans (`plbench.<layer>`) are
record_function ranges around the calls into each layer, which may nest
(a burst step's frontends inside its solve). A device operation belongs to
the innermost span that was open on the launching thread when its launch
(the CUDA runtime call with the same correlation id) was made;
kernels replayed from a CUDA graph belong to the span of the graph's
launch. The raw events are summed here: `key_averages()` builds a tree of
every event first, which takes minutes for a window's million events.
"""
from __future__ import annotations

import bisect
from collections import defaultdict


def summarize(prof, window_s: float) -> dict:
    """busy_s, window_s, device seconds by span and by operation name, the
    launch counts of each operation, and the idle gaps by what the host's
    main thread was in."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, launches, spans = [], {}, defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith("plbench."):
                continue  # the spans' own marks on the device timeline, no work
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                        e.linked_correlation_id() or e.correlation_id()))
        elif name.startswith("plbench."):
            spans[e.start_thread_id()].append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                               name[len("plbench."):]))
        elif name.startswith(("cuda", "cu")) and e.correlation_id():
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    span_at = innermost(spans)

    by_span, by_name, count = defaultdict(float), defaultdict(float), defaultdict(int)
    for s, e, name, cid in dev:
        d = 1e-9 * (e - s)
        by_name[name] += d
        count[name] += 1
        at = launches.get(cid)
        by_span[(span_at(*at) if at else None) or "other"] += d
    # busy time: the union of the device intervals
    dev.sort()
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e, _, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    # idle gaps by the span the main thread (the one with most spans) was in
    main = max(spans, key=lambda k: len(spans[k])) if spans else None
    idle = defaultdict(float)
    for s, e in gaps:
        idle["host: " + (span_at(s, main) or "runner")] += 1e-9 * (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": 1e-9 * busy, "window_s": window_s, "by_span": dict(by_span),
            "by_name": dict(by_name), "count": dict(count),
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in
                                        sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}}


def innermost(spans: dict):
    """`span_at(t, tid)`: the name of the innermost span open at `t` on
    thread `tid`, or None; `spans` maps a thread to its (start, end, name)
    ranges, which nest as a thread's context managers do."""
    parents, starts = {}, {}
    for tid, v in spans.items():
        v.sort(key=lambda r: (r[0], -r[1]))  # an outer range before one it holds
        par, open_ = [], []
        for s, _, _ in v:
            while open_ and v[open_[-1]][1] <= s:
                open_.pop()
            par.append(open_[-1] if open_ else -1)
            open_.append(len(par) - 1)
        parents[tid], starts[tid] = par, [r[0] for r in v]

    def span_at(t, tid):
        v = spans.get(tid)
        if not v:
            return None
        # the last range to start by `t`, or the innermost of its enclosing
        # ones that `t` still falls in
        i = bisect.bisect_right(starts[tid], t) - 1
        while i >= 0 and not v[i][0] <= t < v[i][1]:
            i = parents[tid][i]
        return v[i][2] if i >= 0 else None

    return span_at


def kernel(summary: dict, key: str) -> tuple[float, int]:
    """(device seconds, launches) of the operations whose name holds `key`."""
    s = sum(v for n, v in summary["by_name"].items() if key in n)
    c = sum(v for n, v in summary["count"].items() if key in n)
    return s, c
