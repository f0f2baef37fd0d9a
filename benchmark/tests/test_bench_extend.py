"""A cell, configuration, traffic mix and metric added as new files is found
by the harness with no edit to a file it already has."""
from __future__ import annotations

import json
import os
import shutil

from cpu_cells import ROOT


def test_new_cell_is_files_only(tmp_path):
    from benchmark import spec

    copy = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "benchmark"), copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*") if p.is_file()}

    b = copy / "benchmark"
    (b / "configs" / "cartpole_long.json").write_text(
        json.dumps(dict(spec.config("cartpole"), name="cartpole_long", T=40)))
    shutil.copy(b / "configs" / "cartpole.py", b / "configs" / "cartpole_long.py")
    (b / "traffic" / "mpc_loop.b4096.json").write_text(
        json.dumps(dict(spec.traffic("mpc_loop.b65536"), batch=4096)))
    (b / "limits" / "cartpole_long.mpc_loop.b4096.json").write_text(
        json.dumps(spec.limits("cartpole.mpc_loop.b65536")))
    (b / "metrics" / "steps_per_window.py").write_text(
        "def read(ctx):\n    return float(ctx.outcome.solves)\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="cartpole_long",
                                 file="benchmark/configs/cartpole_long.json"))
    bench["workloads"].append({"name": "cartpole_long.mpc_loop.b4096", "config": "cartpole_long",
                               "traffic": "mpc_loop.b4096", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "examples_per_s":
            m["workloads"].append("cartpole_long.mpc_loop.b4096")
    bench["per_layer"].append({"name": "steps_per_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "entry", "moves": "examples_per_s",
                               "workloads": ["cartpole_long.mpc_loop.b4096"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    # the copy's own spec.py, pointed at the copy by where it lies
    s = spec.module(str(b / "spec.py"), "benchmark_spec_copy")
    nb = s.benchmark()
    wl = s.workload(nb, "cartpole_long.mpc_loop.b4096")
    assert s.config(wl["config"])["T"] == 40
    assert s.traffic(wl["traffic"])["batch"] == 4096
    assert s.limits(wl["name"]) == spec.limits("cartpole.mpc_loop.b65536")
    assert callable(s.config_model(wl["config"]).step)
    assert callable(s.runner(s.traffic(wl["traffic"])["mode"]).run)
    names = [m["name"] for m in s.cell_metrics(nb, wl["name"], "per_layer")]
    assert names == ["steps_per_window"]
    assert "examples_per_s" in [m["name"] for m in s.cell_metrics(nb, wl["name"], "end_to_end")]

    class Out:
        solves = 7

    class Ctx:
        outcome = Out()

    assert s.metric_reader("steps_per_window").read(Ctx()) == 7.0
    after = {p: p.read_bytes() for p in before}
    assert after == before
