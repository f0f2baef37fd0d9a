"""The port's examples (dilqr_tpu_torch/examples/), each main() run on the CPU
at its smallest flags (a few steps, a small batch) and its returned
numbers checked; cost_sweep's vmapped sweep against its own loop of
per-candidate solves (rtol 1e-6: the same solves, the batched reductions
aside)."""
import math
import os

import torch

from dilqr_tpu_torch.diff import modes as M
from dilqr_tpu_torch.examples import (closed_loop, cost_sweep, external_plant, mismatch_loop,
                                      rocket_landing, sysid_pendulum)

CPU = ["--device", "cpu"]


def _finite(*vals):
    return all(math.isfinite(v) for v in vals)


def test_cost_sweep_is_its_per_candidate_loop():
    M.VMAP_STATS.update(dict.fromkeys(M.VMAP_STATS, 0))
    out = cost_sweep.main(CPU + ["--batch", "4", "--candidates", "2", "--lqr-iter", "3"])
    assert M.VMAP_STATS == {"vmap_merged": 0, "vmap_mapped": 1, "bwd_merged": 0, "bwd_mapped": 0}
    weights, one = cost_sweep.sweep(torch.device("cpu"), 4, 2, 3)
    loop = [one(w) for w in weights]
    torch.testing.assert_close(torch.tensor(out["tracking"]), torch.stack([t for t, _ in loop]),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(torch.tensor(out["effort"]), torch.stack([e for _, e in loop]),
                               rtol=1e-6, atol=0)
    assert out["weights"] == weights.tolist()
    assert out["best"] == min(range(2), key=lambda i: out["tracking"][i])


def test_closed_loop():
    out = closed_loop.main(CPU + ["--steps", "3", "--T", "5"])
    assert _finite(out["theta"], out["dtheta"], out["plan_cost"])
    assert out["ok"] == out["upright"]


def test_mismatch_loop():
    out = mismatch_loop.main(CPU + ["--steps", "3", "--T", "5"])
    assert len(out["final_cos"]) == 4
    assert _finite(*out["final_cos"], *out["final_dtheta"], out["closed_1mcos"],
                   out["open_1mcos"])


def test_rocket_landing_plots(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = rocket_landing.main(CPU + ["--batch", "2", "--steps", "1", "--horizon", "3",
                                     "--lqr-iter", "1", "--plot"])
    assert _finite(out["final_altitude"], out["final_speed"], out["plans_per_s"])
    assert os.path.getsize(tmp_path / out["plot"]) > 0


def test_sysid_pendulum_moves_the_params(tmp_path):
    out = sysid_pendulum.main(CPU + ["--epochs", "1", "--n-train", "4", "--work",
                                     str(tmp_path)])
    assert _finite(out["best_val"], *out["learned"], *out["rel_err"])
    assert out["rel_err"] != out["rel_err_init"]


def test_external_plant():
    out = external_plant.main(CPU + ["--steps", "3", "--batch", "1"])
    assert _finite(out["closed_cost"], out["open_cost"], out["ms_per_step"])
    assert len(out["iters"]) == 3 and all(1 <= i <= 10 for i in out["iters"])
