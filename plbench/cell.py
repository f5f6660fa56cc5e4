"""A cell by name: its entry in BENCHMARK.json, its configuration file and
its traffic mix, and the port's configuration object built from them."""
from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

# configuration-file keys that describe the deployment and are not fields of
# the port's config sections
_NOT_FIELDS = {"camera": {"model", "rate_hz", "width", "height"}, "imu": {"rate_hz"}}
# the camera's `model`, as the port's `CameraConfig.model_type` names it, and
# the lens coefficients each model takes (radial-tangential; the
# Kannala-Brandt θ-polynomial); the scene generator draws these two alone
MODELS = {"pinhole": ("PINHOLE", ("k1", "k2", "p1", "p2")),
          "kannala_brandt": ("KANNALA_BRANDT", ("kb2", "kb3", "kb4", "kb5"))}
_INTRINSICS = ("fx", "fy", "cx", "cy")
# the port's config sections a configuration file may hold, and the
# top-level keys that describe the deployment
_SECTIONS = ("camera", "imu", "tracker", "solver", "extrinsic", "temporal", "loop")
_ABOUT = {"deployment", "source", "use_lines", "guarantees", "assumed"}


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
        """What the scene generator reads: the mix's scene and the camera
        (`camera`)."""
        return {"scene": self.traffic["scene"], "camera": camera(self.config)}


def check_config(conf: dict):
    """Raise ValueError on what `port_config` would drop or make up: a
    top-level section it does not read, a camera model the generator cannot
    draw, a camera key that neither the port nor the generator reads, an
    intrinsic left out (the port has its own defaults), or a lens
    coefficient that the camera's model does not use."""
    extra = set(conf) - set(_SECTIONS) - _ABOUT
    if extra:
        raise ValueError(f"configuration sections that would be dropped: {sorted(extra)}")
    cam = conf["camera"]
    model = cam.get("model")
    if model not in MODELS:
        raise ValueError(f"camera model {model!r} is not one the scene generator draws: "
                         f"{sorted(MODELS)}")
    lens = {k for m in MODELS.values() for k in m[1]}
    known = _NOT_FIELDS["camera"] | set(_INTRINSICS) | lens
    if set(cam) - known:
        raise ValueError(f"camera keys that would be dropped: {sorted(set(cam) - known)}")
    missing = [k for k in ("width", "height", *_INTRINSICS) if k not in cam]
    if missing:
        raise ValueError(f"camera keys missing: {missing}")
    unused = [k for k in sorted(lens - set(MODELS[model][1])) if cam.get(k, 0.0) != 0.0]
    if unused:
        raise ValueError(f"lens coefficients that the {model} model does not use: {unused}")


def camera(conf: dict) -> dict:
    """The camera of a configuration file (`check_config` first): its model,
    size, intrinsics and every lens coefficient of the two models, 0 where
    the file gives none."""
    check_config(conf)
    cam = conf["camera"]
    lens = [k for m in MODELS.values() for k in m[1]]
    return {"model": cam["model"], "width": cam["width"], "height": cam["height"],
            **{k: cam[k] for k in _INTRINSICS}, **{k: cam.get(k, 0.0) for k in lens}}


def port_config(conf: dict):
    """The port's `PLSlamConfig` of a configuration file: the camera
    (`camera`) with its `model` as the port's `model_type`, and each section,
    the optional `temporal` one included."""
    from plslam_torch.config import (CameraConfig, ExtrinsicConfig, ImuConfig, LoopConfig,
                                     PLSlamConfig, SolverConfig, TemporalConfig, TrackerConfig)

    def section(cls, key):
        vals = conf.get(key, {})
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in vals.items()
                      if k not in _NOT_FIELDS.get(key, ())})

    cam = camera(conf)
    cam_cfg = CameraConfig(model_type=MODELS[cam.pop("model")][0],
                           image_width=cam.pop("width"), image_height=cam.pop("height"), **cam)
    return PLSlamConfig(camera=cam_cfg, imu=section(ImuConfig, "imu"),
                        tracker=section(TrackerConfig, "tracker"),
                        solver=section(SolverConfig, "solver"),
                        extrinsic=section(ExtrinsicConfig, "extrinsic"),
                        temporal=section(TemporalConfig, "temporal"),
                        loop=section(LoopConfig, "loop"))
