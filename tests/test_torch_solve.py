"""The port's plain forward solve end to end: solve against the JAX
package's solve(backend="xla") at f64, the reference's MPC goldens, and
MPC.__call__ / receding_horizon against the JAX ones. Inputs are made with
numpy from a seed and reach the port through convert.from_numpy.

Tolerances: 1e-6 at f64 against JAX (the same iteration, summation order
aside -- measured differences are 1e-7 at most); the goldens keep the JAX
tests' bounds (tests/test_mpc_golden.py:69-87)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.control import receding_horizon as j_rh
from dilqr_tpu.models import cartpole as jcart
from dilqr_tpu.models import pendulum as jpend
import dilqr_tpu_torch as P
from dilqr_tpu_torch.control import open_loop_rollout, receding_horizon as t_rh
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.models import cartpole as tcart
from dilqr_tpu_torch.models import pendulum as tpend

ENVS = {"cartpole": (jcart, tcart), "pendulum": (jpend, tpend)}


def _x0(name, B, seed):
    rng = np.random.RandomState(seed)
    th = rng.uniform(-2, 2, B)
    if name == "pendulum":
        return np.stack([np.cos(th), np.sin(th), 0.3 * rng.randn(B)], 1)
    return np.stack([0.1 * rng.randn(B), 0.1 * rng.randn(B), np.cos(th), np.sin(th),
                     0.3 * rng.randn(B)], 1)


def _setup(name):
    jm, tm = ENVS[name]
    p = np.asarray(jm.default_params(), np.float64)
    q, c = (np.asarray(a, np.float64) for a in jm.get_true_obj())
    return jm.make(), tm.make(), p, q, c


def _cfg_kw(dyn, T, **kw):
    base = dict(n_state=dyn.n_state, n_ctrl=1, T=T, lqr_iter=10, eps=1e-6,
                linesearch_decay=dyn.linesearch_decay,
                max_linesearch_iter=dyn.max_linesearch_iter,
                exit_unconverged=False, detach_unconverged=False, backprop=False)
    base.update(kw)
    return base


@pytest.mark.parametrize("qp_solver", ["auto", "pnqp"])
@pytest.mark.parametrize("name", list(ENVS))
def test_solve_matches_jax_xla_f64(name, qp_solver):
    jdyn, tdyn, p, q, c = _setup(name)
    B, T = 8, 10
    x0 = _x0(name, B, 0)
    kw = _cfg_kw(jdyn, T, qp_solver=qp_solver)
    want = J.solve(J.ILQRConfig(backend="xla", **kw), jnp.asarray(x0),
                   J.QuadCost(jnp.diag(q), jnp.asarray(c)), jdyn, params=jnp.asarray(p),
                   u_lower=jdyn.lower, u_upper=jdyn.upper)
    got = P.solve(P.ILQRConfig(**kw), from_numpy(x0),
                  P.QuadCost(torch.diag(from_numpy(q)), from_numpy(c)), tdyn,
                  params=from_numpy(p), u_lower=tdyn.lower, u_upper=tdyn.upper)
    for g, w in [(got.x, want.x), (got.u, want.u), (got.costs, want.costs),
                 (got.full_du_norm, want.full_du_norm)]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    assert int(got.n_iter) == int(want.n_iter)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))


def test_solve_callable_cost_and_warm_start_matches_jax_f64():
    """A callable cost (quadraticized per iteration with torch.func) and a
    warm start, unbounded, on the pendulum."""
    jdyn, tdyn, p, q, c = _setup("pendulum")
    B, T = 4, 8
    x0 = _x0("pendulum", B, 2)
    u0 = 0.2 * np.random.RandomState(3).randn(B, T, 1)

    def cost_fn(tau, w):
        return 0.5 * (w * tau * tau).sum() + 0.1 * (tau[0] - 1.0) ** 4

    kw = _cfg_kw(jdyn, T, lqr_iter=6)
    want = J.solve(J.ILQRConfig(backend="xla", **kw), jnp.asarray(x0),
                   (cost_fn, jnp.asarray(q)), jdyn, params=jnp.asarray(p),
                   u_init=jnp.asarray(u0))
    got = P.solve(P.ILQRConfig(**kw), from_numpy(x0), (cost_fn, from_numpy(q)), tdyn,
                  params=from_numpy(p), u_init=from_numpy(u0))
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs), atol=1e-6, rtol=0)


GOLDEN_RUNS = [
    # (dtype, qp_solver, u_tol, x_tol) -- tests/test_mpc_golden.py:69-87
    ("f64", "pnqp", 1e-6, 1e-6),
    ("f64", "auto", 1e-4, 1e-4),
    ("f32", "auto", 2e-3, 5e-3),
]


@pytest.mark.parametrize("dtype,qp_solver,u_tol,x_tol", GOLDEN_RUNS)
@pytest.mark.parametrize("name", list(ENVS))
def test_mpc_golden(golden, name, dtype, qp_solver, u_tol, x_tol):
    """The reference's full nonlinear box-constrained MPC solves."""
    jm, tm = ENVS[name]
    g = golden(f"mpc_{name}" + ("_f64" if dtype == "f64" else ""))
    tdt = torch.float64 if dtype == "f64" else torch.float32
    dyn = tm.make()
    T = g["u"].shape[0]
    cfg = P.ILQRConfig(n_state=dyn.n_state, n_ctrl=1, T=T, lqr_iter=20, eps=dyn.mpc_eps,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter,
                       detach_unconverged=False, exit_unconverged=False, backprop=False,
                       qp_solver=qp_solver)
    res = P.solve(cfg, from_numpy(g["x_init"], dtype=tdt),
                  P.QuadCost(torch.diag(from_numpy(g["q"], dtype=tdt)), from_numpy(g["p"], dtype=tdt)),
                  dyn, params=from_numpy(np.asarray(jm.default_params()), dtype=tdt),
                  u_lower=dyn.lower, u_upper=dyn.upper)
    u = res.u.transpose(0, 1).numpy()
    x = res.x.transpose(0, 1).numpy()
    assert np.abs(u - g["u"]).max() <= u_tol
    assert np.abs(x - g["x"]).max() <= x_tol
    np.testing.assert_allclose(res.costs.numpy().astype(np.float64), g["objs"], rtol=10 * u_tol)


def test_mpc_call_matches_jax_f64():
    jdyn, tdyn, p, q, c = _setup("cartpole")
    B, T = 6, 10
    x0 = _x0("cartpole", B, 4)
    kw = dict(u_lower=-100.0, u_upper=100.0, lqr_iter=8, eps=1e-4, linesearch_decay=0.5,
              max_linesearch_iter=2, backprop=False, exit_unconverged=False)
    jx, ju, jc = J.MPC(5, 1, T, **kw)(jnp.asarray(x0), J.QuadCost(jnp.diag(q), jnp.asarray(c)),
                                      jdyn, params=jnp.asarray(p))
    mpc = P.MPC(5, 1, T, **kw)
    tx, tu, tc = mpc(from_numpy(x0), P.QuadCost(torch.diag(from_numpy(q)), from_numpy(c)),
                     tdyn, params=from_numpy(p))
    for g, w in [(tx, jx), (tu, ju), (tc, jc)]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_receding_horizon_matches_jax_f64():
    """Three closed-loop steps, each warm-started with the shifted plan."""
    jdyn, tdyn, p, q, c = _setup("pendulum")
    B, T = 4, 10
    x0 = _x0("pendulum", B, 6)
    kw = _cfg_kw(jdyn, T, lqr_iter=8, eps=1e-4)
    want = j_rh(J.ILQRConfig(backend="xla", **kw), jdyn, jnp.asarray(p),
                J.QuadCost(jnp.diag(q), jnp.asarray(c)), jnp.asarray(x0), 3,
                u_lower=jdyn.lower, u_upper=jdyn.upper)
    got = t_rh(P.ILQRConfig(**kw), tdyn, from_numpy(p),
               P.QuadCost(torch.diag(from_numpy(q)), from_numpy(c)), from_numpy(x0), 3,
               u_lower=tdyn.lower, u_upper=tdyn.upper)
    for g, w in [(got.xs, want.xs), (got.us, want.us), (got.costs, want.costs)]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    # the open-loop baseline replays the applied actions exactly
    xs = open_loop_rollout(tdyn.step, from_numpy(p), from_numpy(x0), got.us)
    np.testing.assert_allclose(xs.numpy(), got.xs.numpy(), atol=1e-12, rtol=0)


def test_backends_torch_and_auto_agree_on_cpu():
    """On CPU tensors backend="auto" is the plain loop: identical results."""
    _, tdyn, p, q, c = _setup("cartpole")
    x0 = from_numpy(_x0("cartpole", 4, 7), dtype=torch.float32)
    kw = _cfg_kw(tdyn, 8, lqr_iter=4)
    args = (x0, P.QuadCost(torch.diag(from_numpy(q, dtype=torch.float32)),
                           from_numpy(c, dtype=torch.float32)), tdyn)
    a = P.solve(P.ILQRConfig(**kw), *args, params=from_numpy(p, dtype=torch.float32),
                u_lower=-100.0, u_upper=100.0)
    b = P.solve(dataclasses.replace(P.ILQRConfig(**kw), backend="torch"), *args,
                params=from_numpy(p, dtype=torch.float32), u_lower=-100.0, u_upper=100.0)
    assert torch.equal(a.u, b.u) and torch.equal(a.costs, b.costs)


@pytest.mark.parametrize("grad_method", ["AUTO_DIFF", "FINITE_DIFF", "ANALYTIC_CHECK"])
def test_solve_grad_methods_match_jax_f64(grad_method):
    """The other linearizations: AUTO_DIFF differentiates the clamped step
    (saturated controls get zero columns), FINITE_DIFF takes central
    differences, ANALYTIC_CHECK compares the two."""
    jdyn, tdyn, p, q, c = _setup("pendulum")
    B, T = 5, 8
    x0 = _x0("pendulum", B, 8)
    kw = _cfg_kw(jdyn, T, lqr_iter=6, grad_method=getattr(J.GradMethod, grad_method))
    want = J.solve(J.ILQRConfig(backend="xla", **kw), jnp.asarray(x0),
                   J.QuadCost(jnp.diag(q), jnp.asarray(c)), jdyn, params=jnp.asarray(p),
                   u_lower=jdyn.lower, u_upper=jdyn.upper)
    kw["grad_method"] = getattr(P.GradMethod, grad_method)
    got = P.solve(P.ILQRConfig(**kw), from_numpy(x0),
                  P.QuadCost(torch.diag(from_numpy(q)), from_numpy(c)), tdyn,
                  params=from_numpy(p), u_lower=tdyn.lower, u_upper=tdyn.upper)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs), atol=1e-6, rtol=0)
    assert int(got.n_iter) == int(want.n_iter)


@pytest.mark.parametrize("case", ["u_zero_I", "delta_u", "complex_pendulum", "per_step_bounds"])
def test_solve_options_match_jax_f64(case):
    """Options the plain path carries and the kernel does not: a u_zero_I
    mask (unbounded), a delta_u trust region, the complex pendulum and
    per-example, per-step bounds."""
    name = "pendulum"
    jm, tm = ENVS[name]
    kwm = {"simple": False} if case == "complex_pendulum" else {}
    jdyn, tdyn = jm.make(**kwm), tm.make(**kwm)
    p = np.asarray(jm.default_params(**kwm), np.float64)
    if case == "complex_pendulum":
        p[3], p[4] = 0.1, 0.2
    q, c = (np.asarray(a, np.float64) for a in jm.get_true_obj())
    B, T = 4, 8
    x0 = _x0(name, B, 9)
    rng = np.random.RandomState(10)
    extra_j, extra_t = {}, {}
    if case == "u_zero_I":
        uz = rng.rand(B, T, 1) < 0.3
        extra_j = dict(u_zero_I=jnp.asarray(uz))
        extra_t = dict(u_zero_I=from_numpy(uz))
    elif case == "delta_u":
        extra_j = extra_t = dict(u_lower=-2.0, u_upper=2.0, delta_u=0.5)
    elif case == "per_step_bounds":
        lo = -1.0 - rng.rand(B, T, 1)
        hi = 1.0 + rng.rand(B, T, 1)
        extra_j = dict(u_lower=jnp.asarray(lo), u_upper=jnp.asarray(hi))
        extra_t = dict(u_lower=from_numpy(lo), u_upper=from_numpy(hi))
    else:
        extra_j = extra_t = dict(u_lower=-2.0, u_upper=2.0)
    kw = _cfg_kw(jdyn, T, lqr_iter=6)
    want = J.solve(J.ILQRConfig(backend="xla", **kw), jnp.asarray(x0),
                   J.QuadCost(jnp.diag(q), jnp.asarray(c)), jdyn, params=jnp.asarray(p),
                   **extra_j)
    got = P.solve(P.ILQRConfig(**kw), from_numpy(x0),
                  P.QuadCost(torch.diag(from_numpy(q)), from_numpy(c)), tdyn,
                  params=from_numpy(p), **extra_t)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs), atol=1e-6, rtol=0)
    assert int(got.n_iter) == int(want.n_iter)
