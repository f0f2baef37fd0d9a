"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, limits and the time a full check takes."""
from __future__ import annotations

import json
import os
import re

import pytest

from cpu_cells import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = os.path.join(ROOT, "BENCHMARK.json")


@pytest.fixture(scope="module")
def bench():
    with open(BENCH) as f:
        return json.load(f)


def test_top_level_keys_and_size(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(BENCH) <= 64 * 1024
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells, each run with its allowance, fits in 43200 seconds
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16 and len(bench["command"]) <= 32
    for p in bench["paths"]:
        assert PATH.match(p) and ".." not in p.split("/") and not p.startswith("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word.split("/")
    assert bench["command"][1].startswith(bench["paths"][0] + "/")


def test_every_name_and_unit(bench):
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind if kind in ("configs", "workloads") else "metric", e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_metrics_cover_every_cell(bench):
    from benchmark import spec

    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        mine = {m["name"] for m in spec.cell_metrics(bench, w["name"], "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        layer = spec.cell_metrics(bench, w["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        if "%" == m["unit"]:  # a share; a class of cells may follow the dot
            assert m["name"].split(".")[0].endswith("_roofline") or "share" in m["name"]


def test_every_piece_is_found_by_name(bench):
    from benchmark import spec

    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"]
        for fn in ("step", "jac", "start"):
            assert callable(getattr(spec.config_model(c["name"]), fn))
    for w in bench["workloads"]:
        traffic = spec.traffic(w["traffic"])
        assert callable(spec.runner(traffic["mode"]).run)
        assert spec.limits(w["name"])
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
