"""Closed-loop MPC against an OPAQUE external plant (the gym pattern; the
port of examples/external_plant.py).

The reference's demo drives `gym.make('Pendulum-v1')` through a host
loop: plan, apply the first action to the external simulator, refresh
the state from its observation, re-plan (test_mpc.py:29, 95-113). The
plant there is a third-party black box -- not differentiable, not a
PyTorch function, possibly not even vectorized.

The port's native pattern for closed loops is control.receding_horizon
(use it whenever the plant is a step function on tensors). This example
is the adapter for when you CANNOT: an `ExternalPlantLoop` that runs one
solve per episode step on the device and talks to the opaque plant on the
host:
  * warm-start shifting between steps (drop the applied action, repeat
    the last -- reference rocket.py:1137), so later solves converge in a
    couple of iLQR iterations;
  * per-step host<->device copies of the observation x [B,nx] and the
    first action [B,nu] (the plant's interface, not the solver's),
    measured and printed at the end.

The opaque plant below is a numpy re-implementation of gym's
Pendulum-v1 physics (angle-wrapped, velocity-clipped -- dynamics the
planning model does NOT match exactly), driven only through
reset()/step() like any third-party simulator.

    python -m dilqr_tpu_torch.examples.external_plant [--steps 60] [--batch 8]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.solver import solve
from ..models import pendulum
from ..types import ILQRConfig, QuadCost


class OpaquePendulum:
    """Stands in for `gym.make('Pendulum-v1')`: numpy-only, stateful,
    reset/step interface, observation = (cos th, sin th, th_dot).
    Physics follow gym's pendulum.py (g=10, m=1, l=1, dt=0.05,
    torque clip +-2, speed clip +-8) -- note the SPEED CLIP makes it
    deliberately different from the planning model."""

    def __init__(self, batch, seed=0):
        self.rng = np.random.RandomState(seed)
        self.batch = batch

    def reset(self):
        th = self.rng.uniform(-np.pi, np.pi, self.batch)
        thdot = self.rng.uniform(-1.0, 1.0, self.batch)
        self.state = np.stack([th, thdot], 1)
        return self._obs()

    def _obs(self):
        th, thdot = self.state[:, 0], self.state[:, 1]
        return np.stack([np.cos(th), np.sin(th), thdot], 1)

    def step(self, u):
        th, thdot = self.state[:, 0], self.state[:, 1]
        u = np.clip(np.asarray(u)[:, 0], -2.0, 2.0)
        # gym convention: th = 0 upright, gravity term 3g/(2l) sin(th)
        newthdot = thdot + (3.0 * 10.0 / 2.0 * np.sin(th) + 3.0 * u) * 0.05
        newthdot = np.clip(newthdot, -8.0, 8.0)  # gym's speed limit
        newth = th + newthdot * 0.05
        self.state = np.stack([newth, newthdot], 1)
        cost = (((th + np.pi) % (2 * np.pi) - np.pi) ** 2
                + 0.1 * thdot ** 2 + 0.001 * u ** 2)
        return self._obs(), cost


class ExternalPlantLoop:
    """Host-loop MPC adapter for an opaque plant: one solve per step on
    ``device``, the previous solution shifted as warm start."""

    def __init__(self, cfg, dyn, params, cost, u_lower, u_upper, device):
        self.cfg, self.dyn, self.params, self.cost = cfg, dyn, params, cost
        self.u_lower, self.u_upper, self.device = u_lower, u_upper, device

    def plan(self, x_obs, u_warm):
        res = solve(self.cfg, x_obs, self.cost, self.dyn, params=self.params, u_init=u_warm,
                    u_lower=self.u_lower, u_upper=self.u_upper)
        # shift: drop the applied action, repeat the last
        u_next = torch.cat([res.u[:, 1:], res.u[:, -1:]], 1)
        return res.u[:, 0], u_next, res.n_iter

    def run(self, plant, n_steps):
        obs = plant.reset()
        B = obs.shape[0]
        u_warm = torch.zeros(B, self.cfg.T, self.cfg.n_ctrl, device=self.device)
        total = np.zeros(B)
        iters = []
        t0 = time.perf_counter()
        for _ in range(n_steps):
            x = torch.as_tensor(obs, dtype=torch.float32).to(self.device)
            a, u_warm, n_it = self.plan(x, u_warm)
            obs, cost = plant.step(a.cpu().numpy())  # host boundary
            total += cost
            iters.append(int(n_it))
        return total, (time.perf_counter() - t0) / n_steps, iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    dyn = pendulum.make()
    params = pendulum.default_params(device=dev)
    q, p = pendulum.get_true_obj(device=dev)
    cfg = ILQRConfig(
        n_state=3, n_ctrl=1, T=20, lqr_iter=10, eps=1e-3,
        linesearch_decay=dyn.linesearch_decay,
        max_linesearch_iter=dyn.max_linesearch_iter,
        exit_unconverged=False, detach_unconverged=False, backprop=False,
    )
    loop = ExternalPlantLoop(cfg, dyn, params, QuadCost(torch.diag(q), p), -2.0, 2.0, dev)

    plant = OpaquePendulum(args.batch)
    total, s_per_step, iters = loop.run(plant, args.steps)

    # open-loop baseline: zero torque from the same inits
    plant2 = OpaquePendulum(args.batch)
    plant2.reset()
    open_total = np.zeros(args.batch)
    for _ in range(args.steps):
        _, c = plant2.step(np.zeros((args.batch, 1)))
        open_total += c

    print(f"closed-loop mean episode cost: {total.mean():8.2f}")
    print(f"open-loop  mean episode cost: {open_total.mean():8.2f}")
    print(f"per-step wall (plan + host round-trip): {s_per_step * 1e3:.1f} ms"
          f"  (mean lqr iters after warm start: {np.mean(iters[2:]):.1f})")
    ok = bool(total.mean() < 0.6 * open_total.mean())
    print("OK" if ok else "MPC against the opaque plant did not beat zero-torque open loop")
    return {"closed_cost": float(total.mean()), "open_cost": float(open_total.mean()),
            "ms_per_step": s_per_step * 1e3, "iters": iters, "ok": ok}


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
