"""Closed-loop receding-horizon MPC for a fleet of B systems, one control
step at a time.

Each step: the examples whose episode ends restart (example i restarts at
every step s with s = i mod ``episode_steps``, from a start drawn from the
configuration's distribution, with a zero warm start); one ``MPC.solve`` of
the whole fleet warm-started from the previous plan shifted by one, as
``control.receding_horizon`` shifts it; the plant steps each example with
the first action (the configuration's model at params perturbed by
+-``plant_perturbation`` per example, fixed for the run); the plan is
shifted; the card is synchronized as the actions are delivered. A step's
host time covers all of that.

Set-up makes every input on the card from the seed (``start_pool`` draws of
the whole fleet, cycled) and runs one whole episode cycle, which warms every
shape the window uses.
"""
from __future__ import annotations

import time

import torch

from benchmark.drive import Outcome, launches, sample_indices, sync
from benchmark.measure import trace as tr


def run(prob, traffic: dict, seed: int, seconds: float, tracing: bool) -> Outcome:
    dev = prob.device
    B, E, pool = traffic["batch"], traffic["episode_steps"], traffic["start_pool"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    starts = torch.stack([prob.start(gen, B) for _ in range(pool)])
    pert = traffic["plant_perturbation"]
    plant_params = prob.params * (1.0 + pert * (2.0 * torch.rand(
        B, prob.params.shape[0], generator=gen, device=dev) - 1.0))
    restart = (torch.arange(B, device=dev) % E)[None, :] == torch.arange(E, device=dev)[:, None]
    mpc, dyn, cost = prob.program()
    failed = torch.zeros((), dtype=torch.int64, device=dev)
    st = {"s": 0, "x": starts[0],
          "u": torch.zeros(B, prob.T, prob.nu, dtype=torch.float32, device=dev)}

    def step(on: bool):
        s = st["s"]
        with tr.span("restart", on):
            m = restart[s % E]
            x = torch.where(m[:, None], starts[(s // E) % pool], st["x"])
            u0 = torch.where(m[:, None, None], 0.0, st["u"])
        with tr.span("solve", on):
            res = mpc.solve(x, cost, dyn, params=prob.params, u_init=u0)
        with tr.span("plant", on):
            a = res.u[:, 0]
            xn = dyn.step(x, a, plant_params)
        with tr.span("shift", on):
            st["u"] = torch.cat([res.u[:, 1:], res.u[:, -1:]], 1)
        failed.add_((~torch.isfinite(res.costs)).sum())
        with tr.span("sync", on):
            sync(dev)
        st["x"], st["s"] = xn, s + 1
        return res, x, u0, xn

    for _ in range(E):
        step(False)
    t0 = time.perf_counter()
    for _ in range(3):
        step(False)
    step_s = (time.perf_counter() - t0) / 3
    failed.zero_()

    keep = sample_indices(seed, traffic["samples"], seconds, step_s)
    samples, n_iters, step_ms = [], [], []
    out = Outcome(B, 0.0, 0, failed, step_ms, samples, n_iters)
    n0 = launches() if tracing else 0

    def window():
        i = 0
        t_start = time.perf_counter()
        while True:
            t = time.perf_counter()
            if t - t_start >= seconds:
                break
            res, x, u0, xn = step(tracing)
            step_ms.append((time.perf_counter() - t) * 1e3)
            if tracing:
                n_iters.append(res.n_iter)
            if i in keep:
                samples.append(dict(x_in=x, u0=u0, X=res.x, U=res.u, costs=res.costs,
                                    x_next=xn, plant_params=plant_params))
            i += 1
        out.window_s = time.perf_counter() - t_start
        out.solves = i
        return t_start

    if tracing:
        with tr.window() as prof:
            out.t_start = window()
        out.trace = tr.read(prof)
        out.launches = launches() - n0
    else:
        out.t_start = window()
    return out
