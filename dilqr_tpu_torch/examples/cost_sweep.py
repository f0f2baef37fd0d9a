"""Candidate cost-weight sweep with torch.func.vmap over the solver (the
port of examples/cost_sweep.py).

The controls-engineering workflow the reference supports only by
hand-batching (mpc.py solves one batch per call): try S candidate cost
weightings over the same initial states and pick the best closed-loop
candidate. Here it is literally ``torch.func.vmap(solve)``: on the card the
solve's vmap rule folds the sweep into the example batch, so the whole
S x B sweep is ONE launch of the whole-solve kernel (diff/modes.py,
``_SolveWithGrad.vmap``); on the CPU it runs one plain-loop solve a
candidate.

    python -m dilqr_tpu_torch.examples.cost_sweep [--device cpu] [--batch 64]
        [--candidates 8] [--lqr-iter 15]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.solver import solve
from ..models import pendulum
from ..types import ILQRConfig, QuadCost


def sweep(device, B: int = 64, n_cand: int = 8, lqr_iter: int = 15):
    """(the candidate control-effort weights [S], a function w -> (tracking
    error, mean |u|) of one candidate, the problem's starts)."""
    dyn = pendulum.make()
    params = pendulum.default_params(device=device)
    q, p = pendulum.get_true_obj(device=device)
    rng = np.random.RandomState(0)
    th = torch.from_numpy(rng.uniform(-np.pi, np.pi, B).astype(np.float32)).to(device)
    x_init = torch.stack([th.cos(), th.sin(), torch.zeros_like(th)], 1)
    cfg = ILQRConfig(
        n_state=3, n_ctrl=1, T=20, lqr_iter=lqr_iter, eps=1e-4,
        linesearch_decay=dyn.linesearch_decay,
        max_linesearch_iter=dyn.max_linesearch_iter,
        exit_unconverged=False, detach_unconverged=False, backprop=False,
    )
    # candidate control-effort weights (the last diagonal entry of q)
    ctrl_weights = torch.logspace(-3, 0, n_cand, device=device)

    def solve_candidate(w):
        qw = torch.cat([q[:-1], w[None]])
        res = solve(cfg, x_init, QuadCost(torch.diag(qw), p), dyn,
                    params=params, u_lower=dyn.lower, u_upper=dyn.upper)
        # judge candidates on the TRUE objective (fixed weights), not
        # their own: swing-up tracking error across the batch
        err = (res.x[:, :, 0] - 1.0) ** 2 + res.x[:, :, 1] ** 2
        return err.mean(), res.u.abs().mean()

    return ctrl_weights, solve_candidate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--candidates", type=int, default=8)
    ap.add_argument("--lqr-iter", type=int, default=15)
    args = ap.parse_args(argv)

    ctrl_weights, solve_candidate = sweep(torch.device(args.device), args.batch,
                                          args.candidates, args.lqr_iter)
    track, effort = torch.func.vmap(solve_candidate)(ctrl_weights)
    best = int(track.argmin())
    for i, w in enumerate(ctrl_weights.tolist()):
        star = " <-- best tracking" if i == best else ""
        print(f"w_u={w:8.4f}  tracking={float(track[i]):.4f}  "
              f"mean|u|={float(effort[i]):.3f}{star}")
    return {"weights": ctrl_weights.tolist(), "tracking": track.tolist(),
            "effort": effort.tolist(), "best": best}


if __name__ == "__main__":
    main()
