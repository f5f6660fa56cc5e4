"""BENCHMARK.json against the benchmark's contract, and the files it names."""
import json
import os
import re

import pytest

from plbench import cell, run

ROOT = cell.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cell.load_benchmark()


def test_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert bench["paths"] == ["plbench"]
    assert bench["command"] == ["python3", "plbench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_configs_and_cells(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("plbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert os.path.exists(os.path.join(cell.HERE, "limits", c["name"] + ".json"))
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(cell.HERE, "traffic", w["traffic"] + ".json"))


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = run.reader(m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read)
    for w in cells:
        c = cell.Cell(w)
        assert len(c.end_to_end) >= 2 and c.per_layer


def test_limits_cover_the_numbers():
    for name in os.listdir(os.path.join(cell.HERE, "limits")):
        lim = json.load(open(os.path.join(cell.HERE, "limits", name)))
        assert set(lim["required"]) <= set(lim["limits"])
        assert lim["limits"]["hamming_mismatch"] == 0
        # the marginalization's prior is compared in every cell
        assert "marg_gap" in lim["required"]
    # the keyframe search's distances are exact where a cell drives the pose graph
    for c in cell.load_benchmark()["configs"]:
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        lim = json.load(open(os.path.join(cell.HERE, "limits", c["name"] + ".json")))
        assert (lim["limits"].get("search_mismatch") == 0) == bool(conf["loop"]["loop_closure"])
