"""A cell by name: its entry in BENCHMARK.json, its configuration file and
its traffic mix, and the port's configuration object built from them."""
from __future__ import annotations

import dataclasses
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

# configuration-file keys that describe the deployment and are not fields of
# the port's config sections
_NOT_FIELDS = {"camera": {"model", "rate_hz", "width", "height"}, "imu": {"rate_hz"}}


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    with open(path) as fh:
        return json.load(fh)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


class Cell:
    """One workload: `bench` entry, `config` file, `traffic` file."""

    def __init__(self, name: str, root: str = ROOT):
        bench = load_benchmark(root)
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(by_name)}")
        self.bench = bench
        self.entry = by_name[name]
        self.name = name
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(root, conf["file"])
        self.traffic = load_json(HERE, "traffic", self.entry["traffic"] + ".json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if "workloads" not in m or name in m["workloads"]]
        self.per_layer = [m for m in bench["per_layer"]
                          if "workloads" not in m or name in m["workloads"]]

    def recipe(self) -> dict:
        """What the scene generator reads: the mix's scene and the camera."""
        c = self.config["camera"]
        return {"scene": self.traffic["scene"],
                "camera": {"width": c["width"], "height": c["height"], "fx": c["fx"],
                           "cx": c["cx"], "cy": c["cy"]}}


def port_config(conf: dict):
    """The port's `PLSlamConfig` of a configuration file."""
    from plslam_torch.config import (CameraConfig, ExtrinsicConfig, ImuConfig, LoopConfig,
                                     PLSlamConfig, SolverConfig, TrackerConfig)

    def section(cls, key):
        vals = {k: v for k, v in conf[key].items() if k not in _NOT_FIELDS.get(key, ())}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in vals.items()})

    cam = conf["camera"]
    camera = dataclasses.replace(section(CameraConfig, "camera"), image_width=cam["width"],
                                 image_height=cam["height"])
    return PLSlamConfig(camera=camera, imu=section(ImuConfig, "imu"),
                        tracker=section(TrackerConfig, "tracker"),
                        solver=section(SolverConfig, "solver"),
                        extrinsic=section(ExtrinsicConfig, "extrinsic"),
                        loop=section(LoopConfig, "loop"))
