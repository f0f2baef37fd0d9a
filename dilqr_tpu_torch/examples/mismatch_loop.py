"""Closed-loop MPC against a plant the controller did NOT model (the port
of examples/mismatch_loop.py).

This is the scenario the reference's gym demo exercises
(test_mpc.py:29,95-113: plan with the analytic pendulum model, step
`gym.make('Pendulum-v1')`): the true plant differs from the planning
model, and receding-horizon feedback absorbs the mismatch. Here the
plant is the 5-parameter "complex" pendulum (damping, gravity bias,
heavier and shorter arm -- reference pendulum.py:45) while the
controller plans with the nominal 3-parameter simple model; the episode
is control.receding_horizon, one solve a step.

For contrast the script also executes the first solve's plan OPEN-LOOP
on the true plant: without replanning the mismatch accumulates and the
pendulum droops; with feedback it stabilizes upright.

    python -m dilqr_tpu_torch.examples.mismatch_loop [--steps 80] [--T 16]
        [--damping 0.4] [--bias 0.05] [--mass 1.25] [--length 0.9] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..control import open_loop_rollout, receding_horizon
from ..core.solver import solve
from ..models import pendulum
from ..types import ILQRConfig, QuadCost


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--T", type=int, default=16)
    ap.add_argument("--damping", type=float, default=0.4)
    ap.add_argument("--bias", type=float, default=0.05)
    ap.add_argument("--mass", type=float, default=1.25)
    ap.add_argument("--length", type=float, default=0.9)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    model = pendulum.make()                                # what the controller plans with
    model_params = pendulum.default_params(device=dev)     # nominal (10, 1, 1)
    plant = pendulum.make(simple=False)                    # what the world actually does
    plant_params = torch.tensor([10.0, args.mass, args.length, args.damping, args.bias],
                                device=dev)

    q, p = pendulum.get_true_obj(device=dev)
    B = 4
    rng = np.random.RandomState(0)
    th = -1.2 + 2.4 * rng.rand(B)
    tht = torch.from_numpy(th.astype(np.float32)).to(dev)
    x0 = torch.stack([tht.cos(), tht.sin(), torch.zeros_like(tht)], 1)
    cfg = ILQRConfig(
        n_state=3, n_ctrl=1, T=args.T, lqr_iter=12, eps=1e-4,
        linesearch_decay=model.linesearch_decay,
        max_linesearch_iter=model.max_linesearch_iter,
        exit_unconverged=False, detach_unconverged=False, backprop=False,
    )
    cost = QuadCost(torch.diag(q), p)
    ep = receding_horizon(cfg, model, model_params, cost, x0, n_steps=args.steps,
                          u_lower=model.lower, u_upper=model.upper,
                          env_step=plant.step, env_params=plant_params)

    # open-loop contrast: first plan executed on the plant, no feedback
    res0 = solve(cfg, x0, cost, model, params=model_params, u_lower=model.lower,
                 u_upper=model.upper)
    x_ol = open_loop_rollout(plant.step, plant_params, x0, res0.u)[:, 1:]

    n_ol = min(args.steps, cfg.T)
    final_cl = ep.xs[:, -1].cpu().numpy()
    at_T_cl = ep.xs[:, n_ol].cpu().numpy()
    at_T_ol = x_ol[:, n_ol - 1].cpu().numpy()
    print(f"plant mismatch: m={args.mass} l={args.length} "
          f"d={args.damping} b={args.bias} (model: m=1 l=1 d=0 b=0)")
    for i in range(B):
        print(f"  ep {i}: start th={th[i]:+.2f}  "
              f"closed-loop final cos={final_cl[i, 0]:+.3f} "
              f"dth={final_cl[i, 2]:+.2f}  |  at t={n_ol}: "
              f"closed cos={at_T_cl[i, 0]:+.3f} vs open {at_T_ol[i, 0]:+.3f}")
    up = bool((final_cl[:, 0] > 0.9).all() and (np.abs(final_cl[:, 2]) < 1.5).all())
    print("closed-loop stabilized upright under mismatch:", up)
    closed, opened = (float(np.abs(1 - a[:, 0]).mean()) for a in (at_T_cl, at_T_ol))
    print("mean |1-cos| at t=%d: closed-loop %.3f vs open-loop %.3f" % (n_ol, closed, opened))
    return {"final_cos": final_cl[:, 0].tolist(), "final_dtheta": final_cl[:, 2].tolist(),
            "closed_1mcos": closed, "open_1mcos": opened, "upright": up, "ok": up}


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
