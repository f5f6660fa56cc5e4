"""Structured per-frame metrics logging (JSONL).

Counterpart of `plslam/utils/metrics_log.py`: every `process_frame` metrics
dict (track counts, solver costs, accepted iterations, keyframe flag,
timings) appends a line to a JSONL file for offline analysis. Values that
JSON cannot hold become numbers (numpy scalars, 0-d tensors), lists
(tensors of any other shape, read back to the host) or strings.
"""
from __future__ import annotations

import json
import os

import torch


class MetricsLogger:
    def __init__(self, path: str | None):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, record: dict):
        if self._fh:
            self._fh.write(json.dumps({k: _js(v) for k, v in record.items()}) + "\n")

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def _js(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().tolist()
    try:
        json.dumps(v)
        return v
    except TypeError:
        return float(v) if hasattr(v, "__float__") else str(v)


def read_jsonl(path: str):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]
