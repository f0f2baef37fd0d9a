"""Cold batch planning: ``MPC.solve`` of B fresh starts (no warm start),
dispatched back to back with one synchronize at the window's end, cycling a
pool of ``pool`` input batches made on the card from the seed in set-up.
The window's time runs from the first dispatch to the end of that
synchronize, so the solves still queued when the host stops count in full.
"""
from __future__ import annotations

import time

import torch

from benchmark.drive import Outcome, launches, sample_indices, sync
from benchmark.measure import trace as tr


def run(prob, traffic: dict, seed: int, seconds: float, tracing: bool) -> Outcome:
    dev = prob.device
    B, pool = traffic["batch"], traffic["pool"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    starts = [prob.start(gen, B) for _ in range(pool)]
    mpc, dyn, cost = prob.program()
    failed = torch.zeros((), dtype=torch.int64, device=dev)

    def solve(i, on):
        with tr.span("solve", on):
            res = mpc.solve(starts[i % pool], cost, dyn, params=prob.params)
        failed.add_((~torch.isfinite(res.costs)).sum())
        return res

    n_warm = traffic["warmup_calls"]
    for i in range(n_warm):
        solve(i, False)
    sync(dev)
    t0 = time.perf_counter()
    for i in range(n_warm):
        solve(i, False)
    sync(dev)
    call_s = (time.perf_counter() - t0) / n_warm
    failed.zero_()

    keep = sample_indices(seed, traffic["samples"], seconds, call_s)
    samples, n_iters = [], []
    out = Outcome(B, 0.0, 0, failed, [], samples, n_iters)
    n0 = launches() if tracing else 0

    def window():
        i = 0
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            res = solve(i, tracing)
            if tracing:
                n_iters.append(res.n_iter)
            if i in keep:
                samples.append(dict(x_in=starts[i % pool], u0=None, X=res.x, U=res.u,
                                    costs=res.costs))
            i += 1
        with tr.span("sync", tracing):
            sync(dev)
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
