"""Time the whole-solve kernel of one checkout at chip_smoke.py's shapes, to
compare two checkouts on one card.

    python dilqr_tpu_torch/tools/ab_ilqr_fused.py --tree DIR

DIR is the root of a checkout of this repository (``.`` for this one): its
``dilqr_tpu_torch`` is imported and its kernel built. Prints one JSON line
with the card's name and power limit and, for each shape, the median and
the runs of CUDA-event-timed ``ilqr_fused`` calls after a warm-up, and the
solve's n_iter. The shapes are chip_smoke.py's: cartpole (bench.py's
configuration) at B=4096, 16384 and 135168, the rocket at B=1024, 16384
and 135168, with inputs from fixed seeds. ``--rows`` adds the other
libraries of chip_smoke.py's kernel table at its shapes: the rocket under
AUTO_DIFF and the renormalizing rocket under both methods at B=1024, each
with its slew rate (rows 1c, 1f, 1g), LinDx (3,2) at B=4096, the golden
MLP's shape (3,2,(16,)) at B=4096 and its slew rate (row 1h), the traced
double pendulum at B=4096 under both methods (row 1j) and, where the tree
has it, the learned cartpole model (5,1,(100,)) at B=1024, 4096 and 16384
(row 1m; one library serves both methods), each library built before the
first timing. Run it on two checkouts in turns (A B B A) on one card in
one run: two runs may land on two cards.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to time")
    ap.add_argument("--rows", action="store_true", help="time the kernel table's other rows too")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    import dilqr_tpu_torch as P
    from dilqr_tpu_torch.models import cartpole, rocket
    from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused

    if not torch.cuda.is_available():
        sys.exit("ab_ilqr_fused needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            runs.append(a.elapsed_time(b))
        return statistics.median(runs), runs

    rows = {}
    if args.rows:
        rows.update(table_rows(torch, P, fused, dev, ms))
    cd, cp = cartpole.make(), cartpole.default_params(device=dev)
    cq, cpp = cartpole.get_true_obj(device=dev)
    ccfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=20, lqr_iter=20, eps=1e-4, linesearch_decay=0.5,
                        max_linesearch_iter=2, exit_unconverged=False, detach_unconverged=False,
                        backprop=False)
    gen = torch.Generator(device="cpu").manual_seed(0)
    for B, reps in ((4096, 7), (16384, 7), (135168, 5)):
        th = math.pi / 1.05 + 0.1 * torch.randn(B, generator=gen)
        z = torch.zeros(B)
        x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)

        def solve():
            return fused.ilqr_fused(ccfg, cd, cp, x0, (torch.diag(cq), cpp), None, -100.0, 100.0)

        med, runs = ms(solve, reps)
        rows[f"cartpole B={B}"] = {"ms": med, "runs": runs, "n_iter": int(solve()[4])}
    rd, rp = rocket.make(), rocket.default_params(device=dev)
    rq, rpp = rocket.get_true_obj(device=dev)
    rcfg = P.ILQRConfig(n_state=13, n_ctrl=3, T=20, lqr_iter=15, eps=rd.mpc_eps,
                        linesearch_decay=rd.linesearch_decay,
                        max_linesearch_iter=rd.max_linesearch_iter, exit_unconverged=False,
                        detach_unconverged=True, backprop=False)
    gen = torch.Generator(device="cpu").manual_seed(1)
    for B, reps in ((1024, 5), (16384, 5), (135168, 3)):
        x0 = rocket.bench_start(B, gen, device=dev)

        def solve():
            return fused.ilqr_fused(rcfg, rd, rp, x0, (torch.diag(rq), rpp), None, rd.lower,
                                    rd.upper)

        med, runs = ms(solve, reps)
        rows[f"rocket B={B}"] = {"ms": med, "runs": runs, "n_iter": int(solve()[4])}
    print(json.dumps({"tree": args.tree, "card": card, "times": rows}), flush=True)


def table_rows(torch, P, fused, dev, ms):
    """The kernel table's rows 1c, 1f, 1g, 1h, 1j, 1m and LinDx (3,2), timed
    as the rocket is (CUDA events, a warm-up first): {label: figures}."""
    import dataclasses

    from dilqr_tpu_torch.core.solver import augment_slew_rate, canonicalize_cost
    from dilqr_tpu_torch.models import nn_dynamics, rocket
    from dilqr_tpu_torch.models.base import Dynamics

    AN, AD = P.GradMethod.ANALYTIC, P.GradMethod.AUTO_DIFF
    out = {}

    def timed(label, cfg, dyn, params, x0, cost, lo, hi, reps=5):
        def solve():
            return fused.ilqr_fused(cfg, dyn, params, x0, cost, None, lo, hi)

        med, runs = ms(solve, reps)
        out[label] = {"ms": med, "runs": runs, "n_iter": int(solve()[4])}

    def slew_of(cfg, dyn, params, x0, cost):
        B, n = x0.shape[0], cfg.n_state + cfg.n_ctrl
        c = canonicalize_cost(P.QuadCost(*cost), cfg.T, B, n)
        s_cfg, a_cost, s_dyn, s_params, s_x0 = augment_slew_rate(
            dataclasses.replace(cfg, slew_rate_penalty=1.0), c, dyn, params, x0, None)
        return s_cfg, s_dyn, s_params, s_x0, (a_cost.C, a_cost.c)

    rq, rpp = rocket.get_true_obj(device=dev)
    rp = rocket.default_params(device=dev)
    for label, dyn, method in (("1c rocket AUTO_DIFF", rocket.make(), AD),
                               ("1f rocket normalize_quat ANALYTIC",
                                rocket.make(normalize_quat=True), AN),
                               ("1g rocket normalize_quat AUTO_DIFF",
                                rocket.make(normalize_quat=True), AD)):
        cfg = P.ILQRConfig(n_state=13, n_ctrl=3, T=20, lqr_iter=15, eps=1e-3,
                           linesearch_decay=dyn.linesearch_decay,
                           max_linesearch_iter=dyn.max_linesearch_iter, grad_method=method,
                           exit_unconverged=False, detach_unconverged=False, backprop=False)
        gen = torch.Generator(device="cpu").manual_seed(2)
        x0 = rocket.bench_start(1024, gen, device=dev)
        lo, hi = dyn.lower.to(dev), dyn.upper.to(dev)
        timed(f"{label} B=1024", cfg, dyn, rp, x0, (torch.diag(rq), rpp), lo, hi)
        timed(f"{label} slew rate B=1024",
              *slew_of(cfg, dyn, rp, x0, (torch.diag(rq), rpp)), lo, hi)

    gen = torch.Generator(device="cpu").manual_seed(3)
    T, nx, nu, B = 20, 3, 2, 4096
    n = nx + nu
    F = (0.3 * torch.randn(T - 1, B, nx, n, generator=gen) + torch.eye(nx, n)).to(dev)
    f = (0.1 * torch.randn(T - 1, B, nx, generator=gen)).to(dev)
    x0 = torch.randn(B, nx, generator=gen).to(dev)
    A = torch.randn(n, n, generator=gen)
    cost = ((A @ A.T + 0.5 * torch.eye(n)).to(dev), torch.randn(n, generator=gen).to(dev))
    cfg = P.ILQRConfig(n_state=nx, n_ctrl=nu, T=T, lqr_iter=10, eps=1e-4, backprop=False,
                       exit_unconverged=False, detach_unconverged=False)
    timed("LinDx (3,2) B=4096", cfg, P.LinDx(F, f), None, x0, cost, -0.5, 0.5)

    gen = torch.Generator().manual_seed(12)
    dyn = nn_dynamics.make(3, 2, activation="sigmoid", hidden_sizes=(16,))
    ws = nn_dynamics.init_params(3, 2, (16,), generator=gen, device=dev)
    from dilqr_tpu_torch.core.ilqr import kernel_params
    x0 = (0.3 * torch.randn(B, 3, generator=gen)).to(dev)
    cfg = P.ILQRConfig(n_state=3, n_ctrl=2, T=T, lqr_iter=10, eps=1e-4, backprop=False,
                       exit_unconverged=False, detach_unconverged=False)
    cost = (torch.eye(5, device=dev), torch.zeros(5, device=dev))
    timed("1h MLP (3,2,(16,)) sigmoid B=4096", cfg, dyn, kernel_params(dyn, ws), x0, cost,
          -0.5, 0.5)
    s_cfg, s_dyn, s_ws, s_x0, s_cost = slew_of(cfg, dyn, ws, x0, cost)
    timed("1h MLP (3,2,(16,)) sigmoid slew rate B=4096", s_cfg, s_dyn,
          kernel_params(s_dyn, s_ws), s_x0, s_cost, -0.5, 0.5)

    def dp(x, u0, u1, params):
        k1, k2, d = params.unbind(-1)
        q0, q1, v0, v1 = x.unbind(-1)
        a0 = -k1 * torch.sin(q0) - d * v0 + u0 + 0.3 * u1
        a1 = -k2 * torch.sin(q1) - d * v1 + u1 - 0.2 * u0
        return torch.stack([q0 + 0.05 * v0, q1 + 0.05 * v1, v0 + 0.05 * a0, v1 + 0.05 * a1], -1)

    def clip(v):
        return torch.minimum(torch.maximum(v, torch.tensor(-1.5)), torch.tensor(1.5))

    def step(x, u, params):
        return dp(x, clip(u[..., 0]), clip(u[..., 1]), params)

    def step_unclamped(x, u, params):
        return dp(x, u[..., 0], u[..., 1], params)

    model = Dynamics(n_state=4, n_ctrl=2, step=step, step_unclamped=step_unclamped,
                     lower=-1.5, upper=1.5, linesearch_decay=0.5, max_linesearch_iter=4)
    params = torch.tensor([2.0, 1.5, 0.1], device=dev)
    gen = torch.Generator().manual_seed(4)
    x0 = (torch.rand(B, 4, generator=gen) * 2.0 - 1.0).to(dev)
    cost = (torch.diag(torch.tensor([1.0, 1.0, 0.1, 0.1, 1e-3, 1e-3])).to(dev),
            torch.zeros(6, device=dev))
    for method in (AN, AD):
        cfg = P.ILQRConfig(n_state=4, n_ctrl=2, T=T, lqr_iter=20, eps=1e-4, grad_method=method,
                           linesearch_decay=0.5, max_linesearch_iter=4, backprop=False,
                           exit_unconverged=False, detach_unconverged=False)
        timed(f"1j double pendulum traced {method.name} B=4096", cfg, model, params, x0, cost,
              -1.5, 1.5)

    try:
        from dilqr_tpu_torch.models import cartpole, cartpole_mlp
    except ImportError:  # a tree from before the learned cartpole model
        return out
    dyn, params = cartpole_mlp.make(), cartpole_mlp.flat_init_params(21, device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    gen = torch.Generator().manual_seed(5)
    for B in (1024, 4096, 16384):
        th = torch.pi / 1.05 + 0.1 * torch.randn(B, generator=gen)
        z = torch.zeros(B)
        x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)
        cfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=T, lqr_iter=20, eps=1e-4,
                           linesearch_decay=0.5, max_linesearch_iter=2, exit_unconverged=False,
                           detach_unconverged=False, backprop=False)
        timed(f"1m learned cartpole (5,1,(100,)) B={B}", cfg, dyn, params, x0,
              (torch.diag(q), p), -100.0, 100.0, reps=3)
    return out


if __name__ == "__main__":
    main()
