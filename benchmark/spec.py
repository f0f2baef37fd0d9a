"""Where the harness finds what a cell is made of, by name alone:

 * ``BENCHMARK.json`` at the root: the cells (``workloads``), their
   configuration and traffic names, the metrics;
 * ``benchmark/configs/<config>.json``: the configuration's sizes, and
   ``benchmark/configs/<config>.py`` beside it: its plain reference model
   (``step``, ``jac``, ``start``);
 * ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters; its
   ``mode`` names its runner, ``benchmark/drive/<mode>.py``;
 * ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric;
 * ``benchmark/limits/<workload>.json``: the limits of the cell's compared
   numbers.

A new cell, configuration, traffic mix or metric is new files and a new
entry in BENCHMARK.json; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def module(path: str, name: str):
    """The Python file at ``path``, loaded as a module named ``name``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", name + ".json"))


def config_model(name: str):
    return module(os.path.join(HERE, "configs", name + ".py"), f"benchmark_config_{name}")


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", name + ".json"))


def runner(mode: str):
    return module(os.path.join(HERE, "drive", mode + ".py"), f"benchmark_drive_{mode}")


def limits(workload_name: str) -> dict:
    return load_json(os.path.join(HERE, "limits", workload_name + ".json"))


def metric_reader(name: str):
    return module(os.path.join(HERE, "metrics", name + ".py"),
                  "benchmark_metric_" + name.replace(".", "_"))


def cell_metrics(bench: dict, workload_name: str, kind: str):
    """The metrics of ``kind`` ("end_to_end" or "per_layer") the cell
    reports: those with no ``workloads`` key, and those that list it."""
    return [m for m in bench[kind] if workload_name in m.get("workloads", [workload_name])]
