"""Closed-loop receding-horizon pendulum control (the port of
examples/closed_loop.py).

Equivalent of the reference's gym demo (test_mpc.py:29-113): plan with MPC,
apply the first action, step the plant, re-plan with the shifted previous
solution as warm start (the rocket `__main__` pattern, rocket.py:1137).
The plant here is the env's own dynamics, applied per example with
torch.func.vmap.

    python -m dilqr_tpu_torch.examples.closed_loop [--mode swingup|spin]
        [--steps 100] [--T 20] [--device cpu]
"""
from __future__ import annotations

import argparse
import math

import torch

from ..core.solver import solve
from ..models import pendulum
from ..types import ILQRConfig, QuadCost


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="swingup", choices=["swingup", "spin"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--T", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    dyn = pendulum.make()
    params = pendulum.default_params(device=dev)
    T = args.T

    # cost presets (reference test_mpc.py:50-72)
    if args.mode == "swingup":
        goal_weights, goal_state = [1.0, 1.0, 0.1], [1.0, 0.0, 0.0]
    else:  # spin
        goal_weights, goal_state = [0.1, 0.1, 1.0], [1.0, 0.0, 8.0]
    ctrl_penalty = 0.001
    gw = torch.tensor(goal_weights, device=dev)
    q = torch.cat([gw, torch.full((1,), ctrl_penalty, device=dev)])
    p = torch.cat([-gw.sqrt() * torch.tensor(goal_state, device=dev), torch.zeros(1, device=dev)])

    cfg = ILQRConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=50, eps=1e-3,
        linesearch_decay=dyn.linesearch_decay,
        max_linesearch_iter=dyn.max_linesearch_iter,
        exit_unconverged=False, backprop=False,
    )

    def plan(x, u_init):
        res = solve(cfg, x, QuadCost(torch.diag(q), p), dyn, params=params, u_init=u_init,
                    u_lower=-2.0, u_upper=2.0)
        return res.u, res.costs

    step = torch.func.vmap(lambda xi, ui: dyn.step(xi, ui, params))
    # plant state: near hanging down (exactly down is a symmetric stationary
    # point of the solver -- zero feedforward torque in both directions)
    th0 = math.pi - 0.1
    x = torch.tensor([[math.cos(th0), math.sin(th0), 0.0]], device=dev)
    u_init = None
    for t in range(args.steps):
        u_plan, costs = plan(x, u_init)
        a = u_plan[:, 0]  # [B=1, n_ctrl]
        x = step(x, a)
        # shift the solution as the next warm start
        u_init = torch.cat([u_plan[:, 1:], u_plan[:, -1:]], 1)
        th = math.atan2(float(x[0, 1]), float(x[0, 0]))
        if t % 10 == 0 or t == args.steps - 1:
            print(f"t={t:3d} u={float(a[0, 0]):+.3f} theta={th:+.3f} "
                  f"dtheta={float(x[0, 2]):+.3f} plan_cost={float(costs[0]):.3f}")
    up = abs(th) < 0.15 and abs(float(x[0, 2])) < 0.5
    print("upright:", up)
    return {"theta": th, "dtheta": float(x[0, 2]), "plan_cost": float(costs[0]),
            "upright": up, "ok": args.mode == "spin" or up}


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
