"""The work model (benchmark/work/ilqr.py) against counts made by hand at a
small shape."""
from __future__ import annotations

import cpu_cells  # noqa: F401  (puts the repo on the path)

from benchmark.work import ilqr as work

CFG = {"n_state": 1, "n_ctrl": 1, "T": 2, "params": [1.0],
       "work": {"step_flops": 1, "jac_flops": 2, "qp_flops": 1}}


def test_riccati_objective_and_trial_counts():
    # nx = nu = 1, n = 2: V^T F 4, F^T (V F) 8 + C 4, C tau + c 8 + 4,
    # F^T v 4 + 2, K 2, M 2, V 2 + 2 + 3, v 4 + 4 + 2
    assert work.riccati_flops(1, 1) == 4 + 12 + 12 + 6 + 2 + 2 + 7 + 10
    assert work.objective_flops(2) == 8 + 6
    # K dx 2, the control and its clamp 4, the objective 14, the step 1
    assert work.trial_flops(1, 1, 1) == 21


def test_solve_flops_reads_each_examples_iterations():
    # per example: first rollout 2 (1 + 14); each iteration 2 (2 + 55 + 1);
    # each line-search rollout 2 * 21
    assert work.solve_flops(CFG, [1, 2], [1, 1]) == 2 * 30 + 3 * 116 + 2 * 42
    assert work.solve_flops(CFG, [0, 0], [0, 0]) == 60


def test_bytes_read_once_and_written_once():
    # reads: x_init 2, warm start 4, C 4, c 2, params 1, bounds 2;
    # writes: x and u 8, costs and step norms 4; 4 bytes each
    assert work.solve_bytes(CFG, 2, warm=True) == 4 * (15 + 12)
    assert work.solve_bytes(CFG, 2, warm=False) == 4 * (11 + 12)


def test_least_time_names_its_bound():
    s, by = work.least_seconds(67e12, 1.0)
    assert by == "operations" and abs(s - 1.0) < 1e-12
    s, by = work.least_seconds(1.0, 3.35e12)
    assert by == "bytes" and abs(s - 1.0) < 1e-12
