"""Differential fuzz of the PyTorch port (dilqr_tpu_torch) against the JAX
package (dilqr_tpu), the port's reference: the counterpart of
scripts/fuzz_vs_reference.py with the JAX package in the reference's place.

Random box-constrained MPC problems from fuzz_vs_reference.py's
distribution -- env (pendulum, cartpole, pendulum-complex, or a LinDx
problem with zero-control masks and delta_u), horizon, batch, iteration
budget, eps, warm start, bounds, perturbed params -- run through
``dilqr_tpu.solve`` (backend="xla", qp_solver="pnqp", float64, CPU) and
the port's ``solve`` (CPU, float64, qp_solver="pnqp") on the same numpy
inputs, taken across with ``dilqr_tpu_torch.convert.from_numpy``; x, u and
the best costs must agree to ``--atol`` (1e-6, the port's float64 parity
tests' bar). As in the reference fuzz, eps > 0 admits a stopping-rule tie
(one side stops an outer iteration earlier on a 1-ulp difference against
eps): equal costs and controls within max(10 eps, 1e-3) pass as TIE.

``--grads`` also compares the IFT, KKT and UNROLL gradients of a fixed
linear loss of (x, u) -- with respect to the dynamics params, the cost's
linear term and the starts (the cost matrix, its linear term and the
starts on LinDx) -- against jax.grad of JAX's solve in the same mode, to
GRAD_RTOL of the largest entry (dC compared symmetrized).

    python scripts/fuzz_torch_vs_jax.py --cases 30 [--seed 0] [--grads]

One line per case and a summary; exits 1 on any mismatch. CPU only.
"""
import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
# the reference fuzz's samplers; importing it also puts its reference
# checkout's directories on sys.path, which this script does not need
_path = list(sys.path)
sys.path.insert(0, HERE)
from fuzz_vs_reference import sample_case, sample_lindx_case  # noqa: E402

sys.path[:] = _path
GRAD_RTOL = 1e-6  # tests/test_torch_vmap_grad.py's float64 bar


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def problem(case, lindx):
    """The case as batch-major float64 numpy arrays and solve keywords,
    the same for both packages."""
    from dilqr_tpu.models import cartpole, pendulum

    if lindx:
        bound = case["bound"]
        return dict(
            nx=case["F"].shape[-2], nu=case["F"].shape[-1] - case["F"].shape[-2],
            env=None, T=case["T"], x0=case["x_init"], C=case["C"].swapaxes(0, 1),
            c=case["c"].swapaxes(0, 1), F=case["F"].swapaxes(0, 1),
            f=case["f"].swapaxes(0, 1), lqr_iter=case["lqr_iter"], eps=1e-7,
            kw=dict(u_lower=None if bound is None else -bound,
                    u_upper=None if bound is None else bound,
                    u_zero_I=None if case["u_zero_I"] is None else case["u_zero_I"].swapaxes(0, 1),
                    delta_u=case["delta_u"]),
            lin=dict(linesearch_decay=0.2, max_linesearch_iter=10))
    env = case["env_name"]
    jdyn = cartpole.make() if env == "cartpole" else pendulum.make(simple=env == "pendulum")
    q, p = (cartpole if env == "cartpole" else pendulum).get_true_obj()
    params = case["params64"][:3] if env == "pendulum" else case["params64"]
    return dict(
        nx=jdyn.n_state, nu=jdyn.n_ctrl, env=env, T=case["T"], x0=case["xinit"],
        C=np.diag(np.asarray(q, np.float64)), c=np.asarray(p, np.float64),
        params=np.asarray(params, np.float64), lqr_iter=case["lqr_iter"], eps=case["eps"],
        kw=dict(u_init=case["u_init"], u_lower=jdyn.lower if case["bounded"] else None,
                u_upper=jdyn.upper if case["bounded"] else None),
        lin=dict(linesearch_decay=jdyn.linesearch_decay,
                 max_linesearch_iter=jdyn.max_linesearch_iter))


def run(pkg, models, conv, prob, mode=None, cot=None):
    """One package's solve of ``prob`` (its arrays through ``conv``);
    with ``mode``, the gradient of <gx, x> + <gu, u> (cot) instead, as
    ``mode`` computes it: returns the leaves' gradients."""
    kw = {k: conv(v) if isinstance(v, np.ndarray) else v for k, v in prob["kw"].items()}
    env = prob["env"]
    cfg = pkg.ILQRConfig(
        n_state=prob["nx"], n_ctrl=prob["nu"], T=prob["T"], lqr_iter=prob["lqr_iter"],
        eps=prob["eps"], exit_unconverged=False, detach_unconverged=False,
        backprop=mode is not None, qp_solver="pnqp",
        backend="xla" if pkg.__name__ == "dilqr_tpu" else "torch",
        grad_method=(pkg.GradMethod.AUTO_DIFF if env == "pendulum-complex"
                     else pkg.GradMethod.ANALYTIC),
        backward_mode=getattr(pkg.BackwardMode, mode or "KKT"), unroll=mode == "UNROLL",
        **prob["lin"])
    if env is None:
        def solve(C, c, x0):
            return pkg.solve(cfg, x0, pkg.QuadCost(C, c),
                             pkg.LinDx(conv(prob["F"]), conv(prob["f"])), **kw)

        leaves = (prob["C"], prob["c"], prob["x0"])
    else:
        dyn = (models.cartpole.make() if env == "cartpole"
               else models.pendulum.make(simple=env == "pendulum"))
        C = conv(prob["C"])

        def solve(params, c, x0):
            return pkg.solve(cfg, x0, pkg.QuadCost(C, c), dyn, params=params, **kw)

        leaves = (prob["params"], prob["c"], prob["x0"])
    if mode is None:
        res = solve(*(conv(a) for a in leaves))
        return [np.asarray(getattr(res, n)) for n in ("x", "u", "costs")]
    gx, gu = (conv(a) for a in cot)

    def loss(*lv):
        res = solve(*lv)
        return (gx * res.x).sum() + (gu * res.u).sum()

    if pkg.__name__ == "dilqr_tpu":
        import jax

        g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(conv(a) for a in leaves))
        return [np.asarray(a) for a in g]
    import torch

    lv = [conv(a).requires_grad_(True) for a in leaves]
    return [a.numpy() for a in torch.autograd.grad(loss(*lv), lv)]


def grad_err(got, want, lindx):
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if lindx and i == 0:  # the KKT/IFT dC is the symmetrized cotangent
            g, w = 0.5 * (g + np.swapaxes(g, -1, -2)), 0.5 * (w + np.swapaxes(w, -1, -2))
        worst = max(worst, np.abs(g - w).max() / max(1.0, np.abs(w).max()))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--atol", type=float, default=1e-6)
    ap.add_argument("--grads", action="store_true",
                    help="also compare the IFT, KKT and UNROLL gradients against jax.grad")
    args = ap.parse_args(argv)

    jax = _jax()
    import jax.numpy as jnp
    import torch

    import dilqr_tpu as J
    import dilqr_tpu.models as JM
    import dilqr_tpu_torch as P
    import dilqr_tpu_torch.models as PM
    from dilqr_tpu_torch.convert import from_numpy

    def jconv(a):
        return jnp.asarray(a) if np.asarray(a).dtype == bool else jnp.asarray(a, jnp.float64)

    def tconv(a):
        return from_numpy(np.asarray(a), dtype=torch.float64)

    rng = np.random.RandomState(args.seed)
    fails = 0
    for i in range(args.cases):
        if i % 5 == 4:
            jax.clear_caches()  # bound live XLA:CPU executables (scripts/fuzz_gradients.py)
        lindx = rng.rand() < 0.35
        case = sample_lindx_case(rng) if lindx else sample_case(rng)
        prob = problem(case, lindx)
        t0 = time.time()
        try:
            xj, uj, cj = run(J, JM, jconv, prob)
            xt, ut, ct = run(P, PM, tconv, prob)
            du, dx, dc = (float(np.abs(a - b).max()) for a, b in ((ut, uj), (xt, xj), (ct, cj)))
            ok = max(du, dx, dc) <= args.atol
            tie = (not ok and prob["eps"] > 0.0 and dc <= args.atol
                   and du <= max(10 * prob["eps"], 1e-3))
            ok = ok or tie
            figs = f"|du|={du:.2e} |dx|={dx:.2e} |dc|={dc:.2e}"
            if args.grads:
                crng = np.random.RandomState([args.seed, i])
                B, T = prob["x0"].shape[0], prob["T"]
                cot = (0.3 * crng.randn(B, T, prob["nx"]), 0.3 * crng.randn(B, T, prob["nu"]))
                for mode in ("IFT", "KKT", "UNROLL"):
                    err = grad_err(run(P, PM, tconv, prob, mode, cot),
                                   run(J, JM, jconv, prob, mode, cot), lindx)
                    ok = ok and err <= GRAD_RTOL
                    figs += f" {mode} {err:.1e}"
        except Exception as e:  # noqa: BLE001 -- a case that raises is a failure
            fails += 1
            print(f"[ERROR] case {i}: {'lindx' if lindx else case['env_name']} -> {e!r}",
                  flush=True)
            continue
        fails += not ok
        if lindx:
            desc = (f"{'lindx':>16s} T={case['T']:2d} B={len(case['x_init'])} "
                    f"nu={prob['nu']} iter={case['lqr_iter']:2d} bound={case['bound']} "
                    f"uz={int(case['u_zero_I'] is not None)} du={case['delta_u']}")
        else:
            desc = (f"{case['env_name']:>16s} T={case['T']:2d} B={len(case['xinit'])} "
                    f"iter={case['lqr_iter']:2d} eps={case['eps']:g} "
                    f"bounded={int(case['bounded'])} warm={int(case['u_init'] is not None)}")
        tag = "TIE " if tie and ok else ("PASS" if ok else "FAIL")
        print(f"[{tag}] case {i}: {desc} {figs} ({time.time() - t0:.1f}s)", flush=True)
    print(f"{args.cases - fails}/{args.cases} cases: the port matched the JAX package at "
          f"atol={args.atol:g}" + (f", gradients at rtol={GRAD_RTOL:g}" if args.grads
                                   else ""), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
