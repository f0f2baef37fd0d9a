"""The whole-solve kernel's MPC variants on the CPU: the plain version
(ops/cuda/ilqr_fused.ilqr_fused on CPU tensors, i.e. ilqr_fused_reference)
against the JAX package's Pallas kernel in interpret mode (solve(...,
backend="pallas") on the CPU, as tests/test_fused_edge_cases.py runs it),
on the same numpy-seeded inputs:

 * a per-example QuadCost [B, T, n, n] (the lanes cost; weights scaled in
   [1, 1.5] per step and example, as test_fused_per_example_lanes_cost);
 * per-time and per-example bounds [B, T, nu] that bind;
 * a u_zero_I mask, with the box (the mask zeroes the trial step) and
   without it (the Riccati's free-subspace gains); the masked u is exactly 0;
 * a static delta_u trust region, which binds;
 * the slew rate through augment_slew_rate on cartpole, the pendulum and
   the rocket (Passthrough<Env>: the port's hand Jacobian where JAX takes
   a jvp sweep).

Tolerances are tests/test_torch_ilqr_fused.py's: u 2e-3, x 5e-3, costs
rtol/atol 1e-5, n_iter equal; eps=0 and a few iterations, short of the
f32 forks of a converged line search (ROADMAP C). Also the gate: the
port's ``covered`` against JAX's ``fused_supported`` and ``lane_compatible``
on each of these configurations, on LinDx problems and on the jvp sweep's
(GradMethod.AUTO_DIFF on every env, the complex pendulum and the rocket
with normalize_quat=True under both methods, and slew rates of these) and
on the small MLP's (its weights flattened into the kernel's params), since
they reach the kernel; and on a user's own model (the double pendulum of
tests/traced_models.py) and callable costs, which both packages trace into
their kernels, with the ways to break the tracing contract that both
refuse."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.core.solver import augment_slew_rate as j_augment
from dilqr_tpu.core.solver import canonicalize_cost as j_canonicalize_cost
from dilqr_tpu.models import cartpole as jcart
from dilqr_tpu.models import nn_dynamics as jnn
from dilqr_tpu.models import pendulum as jpend
from dilqr_tpu.models import rocket as jrock
from dilqr_tpu.models.base import Dynamics as JDynamics
from dilqr_tpu.ops.pallas.ilqr_fused import (_flatten_pytree_params, cost_lane_compatible,
                                             fused_supported, lane_compatible)
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.core import ilqr as tilqr
from dilqr_tpu_torch.core.ilqr import kernel_params
from dilqr_tpu_torch.core.solver import augment_slew_rate, canonicalize_cost
from dilqr_tpu_torch.models import cartpole as tcart
from dilqr_tpu_torch.models import nn_dynamics as tnn
from dilqr_tpu_torch.models import pendulum as tpend
from dilqr_tpu_torch.models import rocket as trock
from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused
from rocket_bench_start import bench_start
from test_fused_edge_cases import _double_pendulum_style
import traced_models as tmod

ENVS = {"cartpole": (jcart, tcart), "pendulum": (jpend, tpend), "rocket": (jrock, trock)}


def _start(name, B, seed):
    rng = np.random.RandomState(seed)
    if name == "rocket":
        return bench_start(B, seed)
    th = rng.uniform(-2, 2, B).astype(np.float32)
    z = np.zeros(B, np.float32)
    if name == "pendulum":
        return np.stack([np.cos(th), np.sin(th), z], 1)
    return np.stack([z, z, np.cos(th), np.sin(th), z], 1)


def _problem(name, B, T, lqr_iter, seed=1):
    jm, tm = ENVS[name]
    jdyn, tdyn = jm.make(), tm.make()
    params = np.asarray(jm.default_params())
    q, p = (np.asarray(a) for a in jm.get_true_obj())
    kw = dict(n_state=jdyn.n_state, n_ctrl=jdyn.n_ctrl, T=T, lqr_iter=lqr_iter, eps=0.0,
              linesearch_decay=jdyn.linesearch_decay,
              max_linesearch_iter=jdyn.max_linesearch_iter,
              exit_unconverged=False, detach_unconverged=False, backprop=False)
    return jdyn, tdyn, params, q, p, _start(name, B, seed), kw


def _tm(a):
    """Batch-major [B, T, ...] numpy -> time-major torch."""
    return from_numpy(np.ascontiguousarray(np.swapaxes(a, 0, 1)))


def _compare(jres, out, strip=0):
    x, u, costs, _, n_iter = out
    np.testing.assert_allclose(u.transpose(0, 1).numpy(), np.asarray(jres.u), atol=2e-3)
    np.testing.assert_allclose(x[:, :, strip:].transpose(0, 1).numpy(), np.asarray(jres.x),
                               atol=5e-3)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jres.costs), atol=1e-5, rtol=1e-5)
    assert int(n_iter) == int(jres.n_iter)


def _both(name, B, T, lqr_iter, cost=None, lo=None, hi=None, uz=None, du=None, seed=1,
          box=True):
    """JAX's kernel (interpret mode) and the port's plain version on one
    problem: cost None is the env's diagonal cost, else a (C [B,T,n,n], c
    [B,T,n]) pair; lo/hi None take the env's box unless box=False; uz a
    [B,T,nu] bool mask."""
    jdyn, tdyn, params, q, p, x0, kw = _problem(name, B, T, lqr_iter, seed)
    if cost is None:
        jcost = J.QuadCost(jnp.diag(q), jnp.asarray(p))
        tcost = (torch.diag(from_numpy(q)), from_numpy(p))
    else:
        jcost = J.QuadCost(jnp.asarray(cost[0]), jnp.asarray(cost[1]))
        tcost = (_tm(cost[0]), _tm(cost[1]))
    if box and lo is None:
        lo, hi = np.asarray(jdyn.lower, np.float32), np.asarray(jdyn.upper, np.float32)
    jb = {} if lo is None else dict(u_lower=jnp.asarray(lo), u_upper=jnp.asarray(hi))
    jres = J.solve(J.ILQRConfig(backend="pallas", **kw), jnp.asarray(x0), jcost, jdyn,
                   params=jnp.asarray(params), **jb,
                   u_zero_I=None if uz is None else jnp.asarray(uz), delta_u=du)

    def bound(v):
        if v is None:
            return None
        v = np.asarray(v, np.float32)
        return _tm(v) if v.ndim == 3 else from_numpy(v)

    out = fused.ilqr_fused(P.ILQRConfig(**kw), tdyn, from_numpy(params), from_numpy(x0), tcost,
                           None, bound(lo), bound(hi),
                           u_zero_I=None if uz is None else _tm(uz), delta_u=du)
    return jres, out


def _lanes_cost(name, B, T, seed=2):
    """The env's diagonal cost per step and example, weights in [1, 1.5]."""
    q, p = (np.asarray(a) for a in ENVS[name][0].get_true_obj())
    scale = (1.0 + 0.5 * np.random.RandomState(seed).rand(B, T, 1)).astype(np.float32)
    C = (np.broadcast_to(np.diag(q), (B, T) + (q.size,) * 2) * scale[..., None]).astype(np.float32)
    return C, (np.broadcast_to(p, (B, T, p.size)) * scale).astype(np.float32)


def _unconstrained_reach(name, B, T, lqr_iter, **kw):
    """max |u| of the port's plain version without delta_u."""
    _, tdyn, params, q, p, x0, cfg_kw = _problem(name, B, T, lqr_iter)
    out = fused.ilqr_fused(P.ILQRConfig(**cfg_kw), tdyn, from_numpy(params), from_numpy(x0),
                           (torch.diag(from_numpy(q)), from_numpy(p)), None, tdyn.lower,
                           tdyn.upper, **kw)
    return out[1].abs().max().item()


def test_per_example_cost():
    """The lanes cost: C [B,T,n,n] and c [B,T,n] per step and example."""
    _compare(*_both("pendulum", 5, 6, 4, cost=_lanes_cost("pendulum", 5, 6)))


def test_per_example_bounds():
    """Bounds [B, T, nu] that vary over time and examples and bind."""
    B, T = 6, 6
    hi = np.random.RandomState(3).uniform(0.1, 0.6, (B, T, 1)).astype(np.float32)
    jres, out = _both("cartpole", B, T, 4, lo=-hi, hi=hi)
    _compare(jres, out)
    at = np.abs(np.abs(np.asarray(jres.u)) - hi) < 1e-6
    assert at.mean() > 0.1, at.mean()


@pytest.mark.parametrize("box", [True, False], ids=["boxed", "unboxed"])
def test_u_zero_I(box):
    """A mask over about 35% of the controls: with the box the trial step
    zeroes them before the clamp; without it the Riccati takes the
    free-subspace gains (1e-8 on frozen diagonals; for one control k
    divides by the unmasked Quu). The masked u is exactly 0."""
    B, T = 6, 6
    uz = np.random.RandomState(4).rand(B, T, 1) < 0.35
    jres, out = _both("pendulum", B, T, 4, uz=uz, box=box)
    _compare(jres, out)
    assert (out[1].transpose(0, 1).numpy()[uz] == 0.0).all()
    assert (np.asarray(jres.u)[uz] == 0.0).all()


def test_delta_u():
    """The static trust region: the QP bounds intersected with +-delta_u,
    the trial clamp widened around the current iterate. From the zero
    start |u| <= n_iter delta_u, which the solve without it passes."""
    B, T, it, du = 6, 6, 4, 0.3
    jres, out = _both("pendulum", B, T, it, du=du)
    _compare(jres, out)
    assert np.abs(np.asarray(jres.u)).max() <= it * du + 1e-5
    assert _unconstrained_reach("pendulum", B, T, it) > it * du


@pytest.mark.parametrize("box", [True, False], ids=["boxed", "unboxed"])
def test_rocket_variants(box):
    """The rocket (three controls, the box-QP) with the variants at once,
    one JAX call each: a per-example cost, and boxed: per-time and
    per-example bounds that bind (the main thrust 8-10, the side thrusts
    0.05-0.15), a mask over about 35% of the controls and delta_u = 0.1;
    unboxed: the mask, through the free-subspace gains with the 3x3
    inverse."""
    B, T, it = 4, 5, 3
    rng = np.random.RandomState(5)
    uz = rng.rand(B, T, 3) < 0.35
    kw = dict(cost=_lanes_cost("rocket", B, T), uz=uz)
    if box:
        hi = np.stack([rng.uniform(8, 10, (B, T)), rng.uniform(0.05, 0.15, (B, T)),
                       rng.uniform(0.05, 0.15, (B, T))], -1).astype(np.float32)
        kw.update(lo=-hi, hi=hi, du=0.1)
    jres, out = _both("rocket", B, T, it, box=box, **kw)
    _compare(jres, out)
    u = np.asarray(jres.u)
    assert (u[uz] == 0.0).all() and (out[1].transpose(0, 1).numpy()[uz] == 0.0).all()
    if box:
        assert np.abs(u).max() <= it * 0.1 + 1e-5
        assert (np.abs(np.abs(u) - hi) < 1e-6)[~uz].mean() > 0.1
        assert _unconstrained_reach("rocket", B, T, it) > it * 0.1


@pytest.mark.parametrize("name,B,T,lqr_iter", [("cartpole", 6, 6, 4), ("pendulum", 6, 6, 4),
                                               ("rocket", 4, 5, 3)])
def test_slew_rate(name, B, T, lqr_iter):
    """The slew rate (penalty 1.0) through augment_slew_rate: the augmented
    problem (u_{t-1}, x) with its per-example cost on the port's
    Passthrough env (hand Jacobian) against JAX's solve with
    slew_rate_penalty on its kernel (jvp sweep)."""
    jdyn, tdyn, params, q, p, x0, kw = _problem(name, B, T, lqr_iter)
    lo, hi = np.asarray(jdyn.lower, np.float32), np.asarray(jdyn.upper, np.float32)
    jcfg = J.ILQRConfig(backend="pallas", slew_rate_penalty=1.0, **kw)
    jres = J.solve(jcfg, jnp.asarray(x0), J.QuadCost(jnp.diag(q), jnp.asarray(p)), jdyn,
                   params=jnp.asarray(params), u_lower=jnp.asarray(lo), u_upper=jnp.asarray(hi))
    n = q.size
    cost = canonicalize_cost(P.QuadCost(torch.diag(from_numpy(q)), from_numpy(p)), T, B, n)
    cfg, acost, adyn, aparams, ax0 = augment_slew_rate(
        P.ILQRConfig(slew_rate_penalty=1.0, **kw), cost, tdyn, from_numpy(params),
        from_numpy(x0), None)
    assert adyn.device_env is not None and cfg.slew_rate_penalty is None
    out = fused.ilqr_fused(cfg, adyn, aparams, ax0, (acost.C, acost.c), None, from_numpy(lo),
                           from_numpy(hi))
    _compare(jres, out, strip=kw["n_ctrl"])


def _gates(cfg_kw, jdyn, tdyn, params, cost_small=True, uz=None, du=None, lo=None, hi=None,
           dtype=np.float32, qp_solver="auto", callable_cost=False, auto_diff=False):
    """(JAX's fused_supported with lane_compatible and cost_lane_compatible,
    the port's covered with its traces) on one configuration; cost_small
    False is the per-example cost, auto_diff GradMethod.AUTO_DIFF (else
    ANALYTIC); callable_cost True a parameterless sum of squares, or (JAX's
    cost_fn, the port's, the number of cost params)."""
    kw = dict(cfg_kw, qp_solver=qp_solver)
    jm, tm = ((J.GradMethod.AUTO_DIFF, P.GradMethod.AUTO_DIFF) if auto_diff
              else (J.GradMethod.ANALYTIC, P.GradMethod.ANALYTIC))
    jcfg, tcfg = J.ILQRConfig(grad_method=jm, **kw), P.ILQRConfig(grad_method=tm, **kw)
    n, nu = kw["n_state"] + kw["n_ctrl"], kw["n_ctrl"]
    jcost, j_clc, t_cc = J.QuadCost(jnp.eye(n), jnp.zeros(n)), False, None
    if callable_cost:
        jfn, tfn, n_cp = callable_cost if isinstance(callable_cost, tuple) else (
            lambda tau, p: 0.5 * (tau * tau).sum(0), lambda tau, p: 0.5 * (tau * tau).sum(-1), 0)
        jcost, j_clc = jfn, cost_lane_compatible(jfn, n, n_cp)
        t_cc = tilqr.callable_cost(tcfg, (tfn, torch.zeros(n_cp) if n_cp else ()))
    jsmall = (jnp.eye(n), jnp.zeros(n)) if cost_small and not callable_cost else None
    tsmall = (torch.eye(n), torch.zeros(n)) if cost_small and not callable_cost else None

    def jb(v):
        return None if v is None else jnp.asarray(v)

    def tb(v):
        return None if v is None else (float(v) if np.ndim(v) == 0 else from_numpy(
            np.asarray(v, np.float32)))

    jparams = jnp.asarray(params)
    j_ok = fused_supported(jcfg, jcost, jdyn, jparams, jb(uz), du,
                           jnp.float32 if dtype == np.float32 else jnp.float64,
                           cost_small=jsmall, u_lower=jb(lo), u_upper=jb(hi),
                           callable_cost=j_clc)
    if j_ok and isinstance(jdyn, JDynamics):
        j_ok = lane_compatible(jdyn, jparams, kw["n_state"], nu)
    t_ok = ((not callable_cost or t_cc is not None) and tdyn is not None and fused.covered(
        tcfg, tdyn, from_numpy(np.asarray(params)),
        torch.float32 if dtype == np.float32 else torch.float64, tsmall,
        None if uz is None else from_numpy(uz), tb(du), tb(lo), tb(hi),
        cost_callable=t_cc is not None))
    return bool(j_ok), bool(t_ok)


def _slew_dyns(name, T, B, models=None):
    """The augmented (Passthrough) models of JAX and the port; models: the
    (JAX model, port model, params) to wrap, by default the env's."""
    jm, tm = ENVS.get(name, (None, None))
    jdyn, tdyn, params = models or (jm.make(), tm.make(), np.asarray(jm.default_params()))
    n = jdyn.n_state + jdyn.n_ctrl
    kw = dict(n_state=jdyn.n_state, n_ctrl=jdyn.n_ctrl, T=T, slew_rate_penalty=1.0)
    x0 = np.zeros((B, jdyn.n_state), np.float32)
    jq = J.QuadCost(jnp.eye(n), jnp.zeros(n))
    jc = j_canonicalize_cost(jq, T, B, n)
    jcfg, _, jaug, _, _ = j_augment(J.ILQRConfig(**kw), jc, jdyn, jnp.asarray(params),
                                    jnp.asarray(x0), None, None)
    tc = canonicalize_cost(P.QuadCost(torch.eye(n), torch.zeros(n)), T, B, n)
    tcfg, _, taug, _, _ = augment_slew_rate(P.ILQRConfig(**kw), tc, tdyn, from_numpy(params),
                                            from_numpy(x0), None)
    return dict(n_state=jcfg.n_state, n_ctrl=jcfg.n_ctrl, T=T), jaug, taug, params


def _mlp_gates(nx, nu, hidden, act="sigmoid", slew=False, cost_small=True, dtype=np.float32,
               auto_diff=False, T=6, B=4, callable_cost=False):
    """(JAX's gate, the port's) on the MLP nn_dynamics.make(nx, nu, act,
    hidden_sizes=hidden) with numpy weights, each given the params its
    dispatch passes: the weights flattened where they can be (JAX's
    _flatten_pytree_params, the port's kernel_params), else the pytree;
    slew: the slew-rate wrapper of the augmented problem (per-example cost);
    callable_cost: a parameterless sum of squares that both trace; box +-1."""
    rng = np.random.RandomState(0)
    sizes = [nx + nu] + list(hidden) + [nx]
    ws = [(rng.uniform(-1, 1, (o, i)).astype(dtype), rng.uniform(-1, 1, o).astype(dtype))
          for i, o in zip(sizes[:-1], sizes[1:])]
    jw = [(jnp.asarray(W), jnp.asarray(b)) for W, b in ws]
    tw = [(from_numpy(W), from_numpy(b)) for W, b in ws]
    jdyn = jnn.make(nx, nu, activation=act, hidden_sizes=hidden)
    tdyn = tnn.make(nx, nu, activation=act, hidden_sizes=hidden)
    jm, tm = ((J.GradMethod.AUTO_DIFF, P.GradMethod.AUTO_DIFF) if auto_diff
              else (J.GradMethod.ANALYTIC, P.GradMethod.ANALYTIC))
    kw = dict(n_state=nx, n_ctrl=nu, T=T)
    jcfg, tcfg = J.ILQRConfig(grad_method=jm, **kw), P.ILQRConfig(grad_method=tm, **kw)
    n = nx + nu
    if slew:
        x0 = np.zeros((B, nx), dtype)
        jc = j_canonicalize_cost(J.QuadCost(jnp.eye(n), jnp.zeros(n)), T, B, n)
        jcfg, _, jdyn, jw, _ = j_augment(dataclasses.replace(jcfg, slew_rate_penalty=1.0),
                                         jc, jdyn, jw, jnp.asarray(x0), None, None)
        tc = canonicalize_cost(P.QuadCost(torch.eye(n), torch.zeros(n)), T, B, n)
        tcfg, _, tdyn, tw, _ = augment_slew_rate(
            dataclasses.replace(tcfg, slew_rate_penalty=1.0), tc, tdyn, tw, from_numpy(x0), None)
        n, cost_small = jcfg.n_state + nu, False
    flat = _flatten_pytree_params(jw)
    jk = jw if flat is None else flat
    jdt, tdt = (jnp.float32, torch.float32) if dtype == np.float32 else (jnp.float64,
                                                                        torch.float64)
    if callable_cost:
        jcost, cost_small = (lambda tau, p: 0.5 * (tau * tau).sum(0)), False
        assert cost_lane_compatible(jcost, n, 0)
        assert tilqr.callable_cost(
            tcfg, (lambda tau, p: 0.5 * (tau * tau).sum(-1), ())) is not None
    else:
        jcost = J.QuadCost(jnp.eye(n), jnp.zeros(n))
    j_ok = fused_supported(jcfg, jcost, jdyn, jk, None, None,
                           jdt, cost_small=(jnp.eye(n), jnp.zeros(n)) if cost_small else None,
                           u_lower=-1.0, u_upper=1.0, callable_cost=callable_cost)
    if j_ok:
        j_ok = lane_compatible(jdyn, jk, jcfg.n_state, nu)
    t_ok = fused.covered(tcfg, tdyn, kernel_params(tdyn, tw), tdt,
                         (torch.eye(n), torch.zeros(n)) if cost_small else None, None, None,
                         -1.0, 1.0, cost_callable=callable_cost)
    return bool(j_ok), bool(t_ok)


def test_covered_agrees_with_jax_gate():
    """The port's gate equals JAX's (fused_supported and lane_compatible)
    on every variant the port takes, and on refusals both make, a LinDx
    problem's included (tests/test_torch_ilqr_lindx.py holds its whole
    table); the jvp sweep's configurations agree too (AUTO_DIFF on every
    env, the complex pendulum and the rocket with normalize_quat=True under
    both methods, their slew rates), and so do the small MLP's: hidden (8,)
    sigmoid (tests/test_fused_nn_dynamics.py:25), (6, 6) relu, (8,) elu, the
    reference golden's (3, 2, (16,)) in both cost forms and under AUTO_DIFF,
    its slew rate, (13, 3, (8,)) at 253 weights, and refused by both: f64,
    two hidden layers past 256 weights (the port keeps JAX's limit where a
    hidden layer is an array per thread), one hidden layer of 101 on the
    cartpole's sizes (1,217 weights, past the 1,205 the port built and
    timed on the card), a model without hidden_sizes.
    The port's gate takes more than JAX's in one place: a net of one hidden
    layer past JAX's 256 weights, hidden 100 (the learned cartpole model,
    1,205 weights) and (1, 1, (64,)) at 257, which JAX refuses (its SMEM
    scalar vector, MAX_PYTREE_PARAMS) and the port admits (Mlp streams the
    hidden layer and reads the weights in place: nn_dynamics.weight_limit).
    A user's own model (the double pendulum) under both methods and its
    slew rate, a callable cost on cartpole, on a LinDx (16, 2) (past the
    per-example cost's gate, which a callable cost does not count) and on
    the golden MLP, and one with params on the user model: admitted by
    both, each package tracing them into its kernel; and
    refused by both: a step that captures an array, branches on data or
    calls an operation outside the set (a determinant), f64, pytree params,
    and a callable cost that captures an array."""
    T, B = 6, 4
    rows = []
    for name in ("cartpole", "pendulum", "rocket"):
        jm, tm = ENVS[name]
        jdyn, tdyn = jm.make(), tm.make()
        params = np.asarray(jm.default_params())
        nu = jdyn.n_ctrl
        kw = dict(n_state=jdyn.n_state, n_ctrl=nu, T=T)
        hi = np.ones((T, B, nu), np.float32)  # time-major, as ilqr_loop passes it
        mask = np.zeros((T, B, nu), bool)
        same = [
            ("static", {}),
            ("static bounds", dict(lo=-1.0, hi=1.0)),
            ("per-example cost", dict(cost_small=False, lo=-1.0, hi=1.0)),
            ("per-time and per-example bounds", dict(lo=-hi, hi=hi)),
            ("u_zero_I", dict(uz=mask, lo=-1.0, hi=1.0)),
            ("u_zero_I unboxed", dict(uz=mask)),
            ("delta_u", dict(du=0.4, lo=-1.0, hi=1.0)),
            ("delta_u [1]", dict(du=np.array([0.4], np.float32), lo=-1.0, hi=1.0)),
            ("f64", dict(dtype=np.float64)),
            ("qp_solver pnqp", dict(qp_solver="pnqp")),
        ]
        for label, extra in same:
            rows.append((f"{name} {label}", *_gates(kw, jdyn, tdyn, params, **extra)))
        skw, jaug, taug, _ = _slew_dyns(name, T, B)
        rows.append((f"{name} slew rate", *_gates(skw, jaug, taug, params, cost_small=False,
                                                  lo=-1.0, hi=1.0)))
    # a LinDx problem: F/f as data, the port's LinDx<NX, NU> (both gates
    # ignore params); with f, with the per-example cost, with n_ctrl 8, and
    # refused past the gate's n_state and at f64
    for label, nx, nu, f, extra in (("LinDx", 5, 1, False, {}), ("LinDx f", 3, 2, True, {}),
                                    ("LinDx per-example cost", 15, 2, True,
                                     dict(cost_small=False)),
                                    ("LinDx n_ctrl 8", 13, 8, False, {}),
                                    ("LinDx past the gate", 16, 2, True,
                                     dict(cost_small=False)),
                                    ("LinDx callable cost", 16, 2, True,
                                     dict(callable_cost=True)),
                                    ("LinDx f64", 3, 2, False, dict(dtype=np.float64))):
        n = nx + nu
        jlin = J.LinDx(jnp.zeros((B, T - 1, nx, n)), jnp.zeros((B, T - 1, nx)) if f else None)
        tlin = P.LinDx(torch.zeros(T - 1, B, nx, n), torch.zeros(T - 1, B, nx) if f else None)
        rows.append((label, *_gates(dict(n_state=nx, n_ctrl=nu, T=T), jlin, tlin,
                                    np.zeros(1), **extra)))
    # the jvp sweep: every env under AUTO_DIFF, the complex pendulum and the
    # renormalizing rocket (no hand Jacobian) under both methods, and the
    # slew rate of one env under AUTO_DIFF and of both new envs
    jvp_envs = [("complex pendulum", jpend.make(simple=False), tpend.make(simple=False),
                 np.asarray(jpend.default_params(simple=False))),
                ("rocket normalize_quat", jrock.make(normalize_quat=True),
                 trock.make(normalize_quat=True), np.asarray(jrock.default_params()))]
    jvp_envs += [(name, jm.make(), tm.make(), np.asarray(jm.default_params()))
                 for name, (jm, tm) in ENVS.items()]
    for label, jd, td, pp in jvp_envs:
        kw = dict(n_state=jd.n_state, n_ctrl=jd.n_ctrl, T=T)
        for auto in (False, True):
            method = "AUTO_DIFF" if auto else "ANALYTIC"
            rows.append((f"{label} {method}", *_gates(kw, jd, td, pp, lo=-1.0, hi=1.0,
                                                      auto_diff=auto)))
        rows.append((f"{label} AUTO_DIFF per-example cost f64",
                     *_gates(kw, jd, td, pp, cost_small=False, auto_diff=True,
                             dtype=np.float64)))
        if label in ("complex pendulum", "rocket normalize_quat", "cartpole"):
            skw, jaug, taug, _ = _slew_dyns(label, T, B, models=(jd, td, pp))
            rows.append((f"{label} slew rate AUTO_DIFF",
                         *_gates(skw, jaug, taug, pp, cost_small=False, lo=-1.0, hi=1.0,
                                 auto_diff=True)))
            rows.append((f"{label} slew rate ANALYTIC",
                         *_gates(skw, jaug, taug, pp, cost_small=False, lo=-1.0, hi=1.0)))
    # the small MLP, its weights flattened into the kernel's params
    for label, args, extra in (
            ("MLP (3,1,(8,)) sigmoid", (3, 1, (8,)), {}),
            ("MLP (3,1,(6,6)) relu", (3, 1, (6, 6), "relu"), {}),
            ("MLP (3,1,(8,)) elu", (3, 1, (8,), "elu"), {}),
            ("MLP (3,2,(16,)) golden", (3, 2, (16,)), {}),
            ("MLP (3,2,(16,)) golden per-example cost", (3, 2, (16,)), dict(cost_small=False)),
            ("MLP (3,2,(16,)) golden AUTO_DIFF", (3, 2, (16,)), dict(auto_diff=True)),
            ("MLP (3,2,(16,)) golden callable cost", (3, 2, (16,)), dict(callable_cost=True)),
            ("MLP (3,2,(16,)) golden slew rate", (3, 2, (16,)), dict(slew=True)),
            ("MLP (3,1,(8,)) elu slew rate AUTO_DIFF", (3, 1, (8,), "elu"),
             dict(slew=True, auto_diff=True)),
            ("MLP (13,3,(8,)) 253 weights", (13, 3, (8,)), {}),
            ("MLP (1,2,(51,)) 256 weights", (1, 2, (51,)), {}),
            ("MLP (3,2,(16,)) f64", (3, 2, (16,)), dict(dtype=np.float64)),
            ("MLP (5,1,(100,)) hidden 100 past JAX's gate only", (5, 1, (100,)), {}),
            ("MLP (1,1,(64,)) 257 weights past JAX's gate only", (1, 1, (64,)), {}),
            ("MLP (3,1,(16,16)) 403 weights past the gate", (3, 1, (16, 16)), {}),
            ("MLP (5,1,(101,)) 1,217 weights past the gate", (5, 1, (101,)), {})):
        rows.append((label, *_mlp_gates(*args, **extra)))
    jmlp, tmlp = jnn.make(3, 1), tnn.make(3, 1)  # no hidden_sizes: the array step only
    jw = jnn.init_params(jax.random.PRNGKey(0), 3, 1, (8,))
    flat = _flatten_pytree_params(jw)
    j_ok = fused_supported(J.ILQRConfig(n_state=3, n_ctrl=1, T=T),
                           J.QuadCost(jnp.eye(4), jnp.zeros(4)), jmlp, flat, None, None,
                           jnp.float32, cost_small=(jnp.eye(4), jnp.zeros(4)), u_lower=-1.0,
                           u_upper=1.0) and lane_compatible(jmlp, flat, 3, 1)
    tw = [(from_numpy(np.asarray(W)), from_numpy(np.asarray(b))) for W, b in jw]
    t_ok = fused.covered(P.ILQRConfig(n_state=3, n_ctrl=1, T=T), tmlp, kernel_params(tmlp, tw),
                         torch.float32, (torch.eye(4), torch.zeros(4)), None, None, -1.0, 1.0)
    rows.append(("MLP without hidden_sizes past the gate", bool(j_ok), bool(t_ok)))
    # a user's own model, traced by both packages; a callable cost on an env
    # with device code and on the user model
    dkw = dict(n_state=4, n_ctrl=2, T=T)
    jdp, tdp = _double_pendulum_style(), tmod.double_pendulum()
    dpp = np.array(tmod.DP_PARAMS, np.float32)
    for auto in (False, True):
        rows.append((f"user model {'AUTO_DIFF' if auto else 'ANALYTIC'}",
                     *_gates(dkw, jdp, tdp, dpp, lo=-1.5, hi=1.5, auto_diff=auto)))
    rows.append(("user model per-example cost", *_gates(dkw, jdp, tdp, dpp, cost_small=False)))
    skw, jaug, taug, _ = _slew_dyns("user model", T, B, models=(jdp, tdp, dpp))
    rows.append(("user model slew rate", *_gates(skw, jaug, taug, dpp, cost_small=False,
                                                 lo=-1.5, hi=1.5)))
    rows.append(("callable cost", *_gates(dict(n_state=5, n_ctrl=1, T=T), jcart.make(),
                                          tcart.make(), np.asarray(jcart.default_params()),
                                          callable_cost=True)))
    rows.append(("user model callable cost", *_gates(dkw, jdp, tdp, dpp, lo=-1.5, hi=1.5,
                                                     callable_cost=(tmod.dp_cost, tmod.dp_cost,
                                                                    10))))
    # the ways to break the contract: refused by both
    A = jnp.asarray(tmod._A.numpy())

    def j_capture(x, u, p):
        return jnp.tensordot(A, x, axes=1) + 0.05 * jnp.concatenate([u, u], axis=0)

    def j_branch(x, u, p):
        if x[0].mean() > 10.0:
            return jnp.zeros_like(x)
        return jdp.step(x, u, p)

    def j_det(x, u, p):
        m = jnp.stack([jnp.stack([x[0], x[1]]), jnp.stack([x[2], x[3]])])
        return jdp.step(x, u, p) + 1e-3 * jnp.linalg.det(m)

    for label, jstep, tstep in (("array capture", j_capture, tmod.array_capture_step),
                                ("branch on data", j_branch, tmod.branching_step),
                                ("op outside the set", j_det, tmod.det_step)):
        jd = dataclasses.replace(jdp, step=jstep, step_unclamped=jstep)
        rows.append((f"user model {label} refused",
                     *_gates(dkw, jd, tmod.double_pendulum(tstep, tstep), dpp, lo=-1.5, hi=1.5)))
    rows.append(("user model f64 refused", *_gates(dkw, jdp, tdp, dpp, dtype=np.float64)))
    jpy = dataclasses.replace(jdp, step=lambda x, u, p: _double_pendulum_style().step(
        x, u, jnp.concatenate([p["k"], p["d"]])))
    jpy = dataclasses.replace(jpy, step_unclamped=jpy.step)
    pk = {"k": jnp.asarray(dpp[:2]), "d": jnp.asarray(dpp[2:])}
    jflat = _flatten_pytree_params(pk)
    j_ok = fused_supported(J.ILQRConfig(**dkw), J.QuadCost(jnp.eye(6), jnp.zeros(6)), jpy,
                           jflat, None, None, jnp.float32, cost_small=(jnp.eye(6), jnp.zeros(6)),
                           u_lower=-1.5, u_upper=1.5) and lane_compatible(jpy, jflat, 4, 2)
    tpy = tmod.double_pendulum(tmod.dp_step_pytree, tmod.dp_step_pytree)
    tpk = {"k": from_numpy(dpp[:2]), "d": from_numpy(dpp[2:])}
    t_ok = fused.covered(P.ILQRConfig(**dkw), tpy, kernel_params(tpy, tpk), torch.float32,
                         (torch.eye(6), torch.zeros(6)), None, None, -1.5, 1.5)
    rows.append(("user model pytree params refused", bool(j_ok), bool(t_ok)))
    jw = jnp.asarray(tmod._W.numpy())
    rows.append(("callable cost array capture refused", *_gates(
        dict(n_state=3, n_ctrl=1, T=T), jpend.make(), tpend.make(),
        np.asarray(jpend.default_params()), callable_cost=(
            lambda tau, p: 0.5 * jnp.sum(jw * tau * tau, axis=0),
            lambda tau, p: tmod.array_capture_cost(tau), 0))))
    for label, j_ok, t_ok in rows:
        want = not any(s in label for s in ("f64", "pnqp", "[1]", "past the gate", "refused",
                                            "past JAX's gate only"))
        assert (j_ok, t_ok) == (want, want or "past JAX's gate only" in label), label
