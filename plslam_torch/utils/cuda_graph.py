"""Record a fixed-shape computation once as a CUDA graph and replay it.

The estimator's LM solve and marginalization run tens of thousands of small
eager ops per frame (forward-mode jacobians over ~180 tangent directions),
so on a GPU they are bound by launch overhead, not by the card. Their shapes
are fixed by the window layout and nothing in them reads a value back to the
host, so each is recorded once and replayed per frame.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from plslam_torch.utils import timers


class CudaGraph:
    """`fn(*args)` over (nested tuples / NamedTuples of) CUDA tensors, recorded
    once. A call copies its inputs into the graph's static buffers, replays
    the recorded kernels and returns clones of the outputs, so results never
    alias the graph's memory. A call whose inputs differ from the recorded
    ones in structure, shape, dtype or device raises."""

    def __init__(self, fn, *args):
        leaves, self._spec = pytree.tree_flatten(args)
        self._inputs = [t.clone() for t in leaves]
        static = pytree.tree_unflatten(self._inputs, self._spec)
        dev = leaves[0].device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # warm-up: library handles and workspaces
            for _ in range(2):
                fn(*static)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            out = fn(*static)
        self._outputs, self._out_spec = pytree.tree_flatten(out)

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        if spec != self._spec:
            raise ValueError("CudaGraph called with another input structure than it recorded")
        for i, (dst, src) in enumerate(zip(self._inputs, leaves)):
            if (src.shape, src.dtype, src.device) != (dst.shape, dst.dtype, dst.device):
                raise ValueError(f"CudaGraph input {i}: recorded {tuple(dst.shape)} {dst.dtype} on "
                                 f"{dst.device}, got {tuple(src.shape)} {src.dtype} on {src.device}")
        for dst, src in zip(self._inputs, leaves):
            dst.copy_(src)
        self._graph.replay()
        return pytree.tree_unflatten([t.clone() for t in self._outputs], self._out_spec)


def run(graphs: dict | None, key: tuple, fn, *args):
    """`fn(*args)`; through the CUDA graph `graphs[key]` (recorded at the
    first call) when a dict of graphs is given. `key` must hold every
    setting that `fn` closes over, so that other settings record another
    graph instead of replaying a stale one. A recording is the tracer's
    `graph.capture` span and counter."""
    if graphs is None:
        return fn(*args)
    if key not in graphs:
        timers.count("graph.capture")
        with timers.span("graph.capture"):
            graphs[key] = CudaGraph(fn, *args)
    return graphs[key](*args)
