"""On the card, at each cell's own size: the sampled solves of a short
window pass the cell's limits and the TF32 control in the program's place
fails them. Skips without a card; on the card:

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""
from __future__ import annotations

import pytest

import cpu_cells  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see the module docstring)")
    return "cuda"


def _workloads():
    from benchmark import spec

    return [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("workload", _workloads())
def test_cell_passes_and_its_control_fails(card, workload):
    from benchmark import calibrate, check, spec

    wl = spec.workload(spec.benchmark(), workload)
    rows, failed = calibrate.readings(wl, 4100000007, 2.0, True, card)
    limits = spec.limits(workload)
    prog = [n for k, n in rows if k == "program"]
    ctl = [n for k, n in rows if k == "control"]
    assert prog and ctl
    assert check.judge(check.worst(prog), limits, failed)[0] is True
    assert check.judge(check.worst(ctl), limits, failed)[0] is False
