"""Differential fuzz of the port's gradient modes against its UNROLL oracle
(counterpart of scripts/fuzz_gradients.py, with the same feature matrix and
the same cases for a seed).

Random box-constrained MPC problems spanning the feature matrix -- env in
{pendulum, pendulum-complex, cartpole, LinDx}, bounds on/off, a delta_u
trust region, the slew-rate penalty, a warm start -- are solved, and the
implicit-gradient modes are compared with autograd through the unrolled
plain loop (cfg.unroll=True, at float64: the oracle):

  * BackwardMode.IFT against UNROLL on the nonlinear envs: at a converged
    fixed point the IFT adjoint is the true derivative;
  * BackwardMode.KKT against UNROLL on LinDx, where constant (F, f) make
    the module-KKT backward exact.

Forward u_zero_I is left out, as in the JAX script: the backward freezes
its active set from the box bounds alone, as the reference does. Cases
whose oracle solve does not converge (max ||du|| >= 1e-3) are re-rolled.

On a GPU (``--device cuda``, the default) at float32 the IFT/KKT side runs
the whole-solve kernel forward and the KKT-VJP kernel in its backward; the
oracle runs the plain loop at float64 on the same card. The bar is then
the float32 one, F32_TOL = 2e-3: the worst relative error of 40 cases
(seeds 0 and 1, --vmap 2) on an NVIDIA H100 80GB HBM3 at 700 W was 2.55e-4
(a warm-started pendulum case; the other 39 at most 1.95e-5), and the bar
is about eight times that. At float64 it is the JAX script's 1e-4.
``--vmap S`` also checks ``torch.func.vmap(torch.func.grad(loss))`` over S
cost scales of each case against the loop of its S gradients (on a GPU at
float32: the merged route, one folded solve and one folded backward).

    python -m dilqr_tpu_torch.tools.fuzz_gradients --cases 20 [--seed 0]
        [--device cuda|cpu] [--dtype float32|float64] [--vmap S] [--tol X]

One line per case; exits 1 on any mismatch.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import BackwardMode, ILQRConfig, LinDx, QuadCost, solve
from ..diff.modes import VMAP_STATS
from ..models import cartpole, pendulum

F64_TOL = 1e-4
F32_TOL = 2e-3


def sample_case(rng):
    env = rng.choice(["pendulum", "pendulum-complex", "cartpole", "lindx"])
    T = int(rng.choice([4, 5, 6, 8]))
    B = int(rng.choice([2, 3]))
    lqr_iter = int(rng.choice([8, 10, 12]))
    bounded = bool(rng.rand() < 0.7)
    warm = bool(rng.rand() < 0.4)
    slew = bool(rng.rand() < 0.25) and env != "lindx"
    delta_u = float(rng.uniform(0.5, 2.0)) if (bounded and rng.rand() < 0.3) else None
    return dict(env=str(env), T=T, B=B, lqr_iter=lqr_iter, bounded=bounded, warm=warm,
                slew=slew, delta_u=delta_u)


def build_problem(case, rng):
    """The problem in float64 numpy arrays, batch-major, drawn as the JAX
    script draws it."""
    env, T, B = case["env"], case["T"], case["B"]
    if env == "lindx":
        nx, nu = int(rng.choice([3, 4])), int(rng.choice([1, 2]))
        n = nx + nu
        A = np.eye(nx) + 0.1 * rng.randn(nx, nx)
        A *= 0.95 / max(1.0, np.max(np.abs(np.linalg.eigvals(A))))
        Bm = 0.5 * rng.randn(nx, nu)
        F = np.broadcast_to(np.concatenate([A, Bm], 1), (B, T - 1, nx, n)).copy()
        f = 0.05 * rng.randn(B, T - 1, nx)
        L = rng.randn(n, n)
        C = np.broadcast_to(L @ L.T / n + np.eye(n), (B, T, n, n)).copy()
        c = 0.3 * rng.randn(B, T, n)
        x0 = 0.5 * rng.randn(B, nx)
        return dict(nx=nx, nu=nu, dyn=None, C=C, c=c, F=F, f=f, x0=x0, lo=-1.0, hi=1.0)
    if env == "cartpole":
        dyn = cartpole.make()
        params = cartpole.default_params(dtype=torch.float64).numpy()
        q, p = (a.numpy() for a in cartpole.get_true_obj(dtype=torch.float64))
        th = rng.uniform(-0.6, 0.6, B)
        x0 = np.stack([0.3 * rng.randn(B), 0.2 * rng.randn(B), np.cos(th), np.sin(th),
                       0.2 * rng.randn(B)], 1)
    else:
        simple = env == "pendulum"
        dyn = pendulum.make(simple=simple)
        params = pendulum.default_params(simple=simple, dtype=torch.float64).numpy()
        if not simple:
            params[3], params[4] = 0.05, 0.1
        q, p = (a.numpy() for a in pendulum.get_true_obj(dtype=torch.float64))
        th = rng.uniform(-1.2, 1.2, B)
        x0 = np.stack([np.cos(th), np.sin(th), 0.3 * rng.randn(B)], 1)
    return dict(nx=dyn.n_state, nu=dyn.n_ctrl, dyn=dyn, params=params, C=np.diag(q), p=p,
                x0=x0, lo=float(dyn.lower), hi=float(dyn.upper))


def _config(case, prob, mode):
    dyn = prob["dyn"]
    return ILQRConfig(
        n_state=prob["nx"], n_ctrl=prob["nu"], T=case["T"], lqr_iter=case["lqr_iter"], eps=0.0,
        linesearch_decay=dyn.linesearch_decay if dyn else 0.2,
        max_linesearch_iter=dyn.max_linesearch_iter if dyn else 5,
        exit_unconverged=False, detach_unconverged=False, backward_mode=mode,
        unroll=mode is BackwardMode.UNROLL, slew_rate_penalty=1e-2 if case["slew"] else None)


def make_loss(case, prob, mode, gx, gu, u0, prev, dtype, device):
    """(loss(leaves, scale) -> scalar, the leaves): a fixed linear loss of
    the solution, the cost's quadratic term scaled by ``scale``; the
    leaves are (C, c, x0) on LinDx and (params, p, x0) otherwise."""
    cfg = _config(case, prob, mode)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    kw = {}
    if case["bounded"]:
        kw.update(u_lower=prob["lo"], u_upper=prob["hi"])
        if case["delta_u"] is not None:
            kw["delta_u"] = case["delta_u"]
    if u0 is not None:
        kw["u_init"] = t(u0)
    if case["slew"]:
        kw["prev_ctrl"] = t(prev)
    gx, gu = t(gx), t(gu)

    if prob["dyn"] is None:
        lin = LinDx(t(prob["F"]), t(prob["f"]))

        def loss(leaves, s):
            C, c, x0 = leaves
            res = solve(cfg, x0, QuadCost(C * s, c), lin, **kw)
            return (gx * res.x).sum() + (gu * res.u).sum(), res

        return loss, (t(prob["C"]), t(prob["c"]), t(prob["x0"]))
    C = t(prob["C"])

    def loss(leaves, s):
        params, p, x0 = leaves
        res = solve(cfg, x0, QuadCost(C * s, p), prob["dyn"], params=params, **kw)
        return (gx * res.x).sum() + (gu * res.u).sum(), res

    return loss, (t(prob["params"]), t(prob["p"]), t(prob["x0"]))


def grads(loss, leaves):
    """(d loss / d leaves at scale 1, the solve's largest ||du||)."""
    leaves = tuple(a.clone().requires_grad_(True) for a in leaves)
    val, res = loss(leaves, 1.0)
    g = torch.autograd.grad(val, leaves)
    return tuple(a.detach().double().cpu() for a in g), float(res.full_du_norm.max())


def rel_err(ga, gb, lindx):
    """The largest ||a - b|| / ||b|| over the leaves; LinDx's dC compared
    symmetrized (the KKT backward returns the symmetrized cotangent,
    reference lqr_step.py:346-351; autograd the raw one)."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(ga, gb)):
        if lindx and i == 0:
            a, b = 0.5 * (a + a.transpose(-1, -2)), 0.5 * (b + b.transpose(-1, -2))
        worst = max(worst, float(torch.linalg.vector_norm(a - b)
                                 / (torch.linalg.vector_norm(b) + 1e-9)))
    return worst


def vmap_err(loss, leaves, S):
    """vmap(grad(loss)) over S cost scales against the loop of S grads:
    (the largest rel_err over the candidates, the routes taken)."""
    s = torch.linspace(0.5, 1.5, S, dtype=leaves[0].dtype, device=leaves[0].device)
    before = dict(VMAP_STATS)
    g = torch.func.vmap(torch.func.grad(lambda lv, s_: loss(lv, s_)[0]), in_dims=(None, 0))(
        leaves, s)
    routes = {k: v - before[k] for k, v in VMAP_STATS.items() if v != before[k]}
    loop = [torch.func.grad(lambda lv: loss(lv, s[k])[0])(leaves) for k in range(S)]
    worst = max(rel_err([a[k].double().cpu() for a in g], [a.double().cpu() for a in loop[k]],
                        False) for k in range(S))
    return worst, routes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--vmap", type=int, default=0, metavar="S",
                    help="also check vmap(grad) over S cost scales against their loop")
    ap.add_argument("--tol", type=float, default=None,
                    help=f"relative bar (default {F32_TOL:g} at float32, {F64_TOL:g} at float64)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fuzz_gradients: --device cuda needs a CUDA device (or pass --device cpu)",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)
    dtype = getattr(torch, args.dtype)
    tol = args.tol if args.tol is not None else (F32_TOL if dtype == torch.float32 else F64_TOL)

    rng = np.random.RandomState(args.seed)
    failures = done = rerolls = 0
    worst = 0.0
    t_start = time.time()
    while done < args.cases:
        case = sample_case(rng)
        prob = build_problem(case, rng)
        T, B, nx, nu = case["T"], case["B"], prob["nx"], prob["nu"]
        gx, gu = 0.3 * rng.randn(B, T, nx), 0.3 * rng.randn(B, T, nu)
        u0 = 0.1 * rng.randn(B, T, nu) if case["warm"] else None
        prev = 0.1 * rng.randn(B, nu)
        lindx = case["env"] == "lindx"
        mode = BackwardMode.KKT if lindx else BackwardMode.IFT
        extra = ""
        try:
            loss_o, leaves_o = make_loss(case, prob, BackwardMode.UNROLL, gx, gu, u0, prev,
                                         torch.float64, device)
            g_o, du = grads(loss_o, leaves_o)
            if du >= 1e-3:
                rerolls += 1
                if rerolls > 3 * args.cases:
                    raise RuntimeError("too many unconverged re-rolls")
                continue
            loss_m, leaves_m = make_loss(case, prob, mode, gx, gu, u0, prev, dtype, device)
            g_m, _ = grads(loss_m, leaves_m)
            err = rel_err(g_m, g_o, lindx)
            ok = err <= tol
            if args.vmap:
                v_err, routes = vmap_err(loss_m, leaves_m, args.vmap)
                ok = ok and v_err <= tol
                err = max(err, v_err)
                extra = f" vmap{args.vmap} rel_err={v_err:.2e} routes={routes}"
        except Exception as e:  # noqa: BLE001 -- a case that raises is a failure
            failures += 1
            done += 1
            print(f"[{done:3d}] ERROR {case}: {e!r}", flush=True)
            continue
        worst = max(worst, err)
        failures += 0 if ok else 1
        done += 1
        print(f"[{done:3d}] {'ok ' if ok else 'FAIL'} {mode.name:4s} vs UNROLL rel_err="
              f"{rel_err(g_m, g_o, lindx):.2e} du={du:.1e} {case['env']:16s} T={T} B={B} "
              f"bounded={int(case['bounded'])} warm={int(case['warm'])} "
              f"slew={int(case['slew'])} delta_u={case['delta_u'] is not None}{extra}",
              flush=True)
    print(f"\n{done - failures}/{done} passed at rel {tol:g} ({args.dtype} on {args.device}, "
          f"worst {worst:.2e}), {rerolls} unconverged re-rolls, {time.time() - t_start:.0f}s",
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
