"""What a run refuses: no card, a directory without the program, a module of
JAX or of the JAX package in the process; and what it loads."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

import cpu_cells
from cpu_cells import ROOT


def _env(**kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="", **kw)
    return env


def test_no_card_exits_nonzero_and_prints_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cartpole.mpc_loop.b65536", "--seed", "4294967311", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout and "correct" not in p.stdout
    assert "no CUDA card" in p.stderr


def test_directory_with_only_the_benchmark_exits_nonzero(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    code = ("import sys, time; sys.path.insert(0, '.'); from benchmark import run, spec; "
            "b = spec.benchmark(); run.run_cell(b, spec.workload(b, "
            "'cartpole.plan_batch.b131072'), 1, 1.0, False, 'cpu', time.perf_counter())")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "dilqr_tpu_torch" in p.stderr
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cartpole.plan_batch.b131072", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout


def test_module_names_are_compared_whole():
    code = ("import sys, types; sys.path.insert(0, '.'); import dilqr_tpu_torch; "
            "from benchmark import run; assert run.forbidden_modules() == [], "
            "run.forbidden_modules(); sys.modules['dilqr_tpu.core'] = types.ModuleType('x'); "
            "assert run.forbidden_modules() == ['dilqr_tpu']")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(), capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'benchmark/tests'); import cpu_cells; "
            "r = cpu_cells.run_small('cartpole.plan_batch.b131072'); "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'dilqr_tpu'}); print(bad, r['correct']); "
            "assert bad == [] and r['correct'] is True")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(), capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr[-2000:]


def test_a_jax_module_refuses_the_run(monkeypatch):
    import types

    from benchmark import run

    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    try:
        cpu_cells.run_small("cartpole.plan_batch.b131072", seconds=4.0)
    except run.Refused as e:
        assert e.code == 3 and "jaxlib" in str(e)
    else:
        raise AssertionError("the run went on with jaxlib loaded")


@pytest.mark.parametrize("where", ["reference", "judge"])
def test_a_jax_module_loaded_after_the_window_refuses_the_run(monkeypatch, where):
    """A stub ``jax`` imported by the reference, or by the check as it
    judges, once the window has closed: the run prints no result."""
    import types

    from benchmark import check, run
    from benchmark.problem import Problem

    def planting(fn):
        def wrapped(*a, **kw):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return fn(*a, **kw)
        return wrapped

    if where == "reference":
        monkeypatch.setattr(Problem, "solve_reference", planting(Problem.solve_reference))
    else:
        monkeypatch.setattr(check, "judge", planting(check.judge))
    with pytest.raises(run.Refused) as e:
        cpu_cells.run_small("cartpole.plan_batch.b131072")
    assert e.value.code == 3 and "jax" in str(e.value)
