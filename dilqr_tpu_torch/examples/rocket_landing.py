"""Receding-horizon rocket soft landing (the port of
examples/rocket_landing.py).

Equivalent of the reference's rocket __main__ demo (env_dx/rocket.py:
1013-1155): 40 closed-loop steps, each solving a T-step box-constrained MPC
from the current state, applying the first thrust command, and shifting the
previous solution as the next warm start (rocket.py:1137). Batched: a whole
fleet of rockets lands in one solve a step (control.receding_horizon).

    python -m dilqr_tpu_torch.examples.rocket_landing [--batch 256]
        [--steps 40] [--horizon 20] [--lqr-iter 20] [--plot] [--gif] [--device cpu]

--plot writes rocket_landing.png and --gif rocket_landing.gif (viz, which
needs matplotlib) to the working directory.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..control import receding_horizon
from ..models import rocket
from ..types import ILQRConfig, QuadCost


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--lqr-iter", type=int, default=20)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--gif", action="store_true",
                    help="animated 3-D landing (viz.rocket_animation)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    B, T = args.batch, args.horizon
    dyn = rocket.make()
    params = rocket.default_params(device=dev)
    q, p = rocket.get_true_obj(device=dev)
    cfg = ILQRConfig(
        n_state=13, n_ctrl=3, T=T, lqr_iter=args.lqr_iter, eps=dyn.mpc_eps,
        linesearch_decay=dyn.linesearch_decay,
        max_linesearch_iter=dyn.max_linesearch_iter,
        exit_unconverged=False, detach_unconverged=False, backprop=False,
    )

    # initial conditions around the reference demo's start (rocket.py:1030):
    # 10 m up, descending, small attitude/rate perturbations
    rng = np.random.RandomState(0)
    r0 = np.array([10.0, 0.0, 0.0]) + np.array([1.0, 2.0, 2.0]) * rng.randn(B, 3)
    v0 = np.array([-2.0, 0.0, 0.0]) + 0.3 * rng.randn(B, 3)
    q0 = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (B, 1))
    w0 = 0.05 * rng.randn(B, 3)
    x = torch.from_numpy(np.concatenate([r0, v0, q0, w0], axis=1).astype(np.float32)).to(dev)

    def episode():
        return receding_horizon(cfg, dyn, params, QuadCost(torch.diag(q), p), x,
                                n_steps=args.steps, u_lower=dyn.lower, u_upper=dyn.upper)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        episode()  # the first solve loads (or builds) the kernel
    sync()
    t0 = time.perf_counter()
    ep = episode()
    sync()
    dt = time.perf_counter() - t0

    for k in range(0, args.steps, 10):
        print(f"step {k:3d}: mean alt {float(ep.xs[:, k, 0].mean()):7.3f} m, "
              f"mean v_x {float(ep.xs[:, k, 3].mean()):7.3f} m/s, "
              f"mean plan cost {float(ep.costs[:, k].mean()):9.2f}")
    alt = ep.xs[:, -1, 0].cpu().numpy()
    speed = ep.xs[:, -1, 3:6].norm(dim=1).cpu().numpy()
    within = float((np.abs(alt) < 1.0).mean())
    print(f"\n{args.steps} closed-loop steps x {B} rockets in {dt:.2f}s "
          f"({args.steps * B / dt:,.0f} plans/s)")
    print(f"final: mean altitude {alt.mean():.3f} m (start 10), "
          f"mean speed {speed.mean():.3f} m/s, {within * 100:.0f}% within 1 m")
    out = {"final_altitude": float(alt.mean()), "final_speed": float(speed.mean()),
           "within_1m": within, "plans_per_s": args.steps * B / dt, "seconds": dt}

    if args.plot or args.gif:
        from .. import viz

        xs, us = ep.xs.transpose(0, 1), ep.us.transpose(0, 1)  # [T, B, ...]
        if args.plot:
            out["plot"] = viz.rocket_trajectory(xs, us, path="rocket_landing.png")
            print("wrote", out["plot"])
        if args.gif:
            out["gif"] = viz.rocket_animation(xs, us, rocket_len=1.0, path="rocket_landing.gif")
            print("wrote", out["gif"])
    return out


if __name__ == "__main__":
    main()
