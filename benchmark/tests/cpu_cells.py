"""Small CPU runs of the harness for its tests: one tile (1024 examples)
and short windows, with the program's plain loop standing in for the card."""
from __future__ import annotations

import contextlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {
    "mpc_loop": {"batch": 1024, "samples": 1, "episode_steps": 2, "start_pool": 1},
    "plan_batch": {"batch": 1024, "samples": 1, "pool": 1, "warmup_calls": 1},
}


@contextlib.contextmanager
def cpu_run():
    """Around a small CPU run: the cores shared over pytest-xdist's workers
    (more threads than cores slow each step past the window), and the check
    on the window's first calls (a loaded CPU can run the window slower than
    its set-up and stop before the calls the harness would draw)."""
    import torch

    from benchmark import drive

    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // workers)))
    drawn = drive.sample_indices
    drive.sample_indices = lambda seed, k, seconds, call_s: set(range(k))
    try:
        yield
    finally:
        drive.sample_indices = drawn


def run_small(workload: str, seed: int = 123456789012, seconds: float = 20.0, program=None):
    """The result object of one small CPU run of ``workload``."""
    from benchmark import run, spec

    bench = spec.benchmark()
    wl = spec.workload(bench, workload)
    mode = spec.traffic(wl["traffic"])["mode"]
    with cpu_run():
        return run.run_cell(bench, wl, seed, seconds, False, "cpu", time.perf_counter(),
                            traffic_override=SMALL[mode], program=program)
