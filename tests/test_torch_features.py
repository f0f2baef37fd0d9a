"""The feature paths of the port: the six feature goldens of
tests/test_features_golden.py (slew-rate penalty on the pendulum and on
LinDx, u_zero_I, delta_u, the MLP model, a callable cost) at their
tolerances, and the learned MLP model, the affine model and the slew-rate
augmentation against the JAX package at f64. Weights and inputs are made
with numpy from a seed and reach the port through convert.from_numpy.

Tolerances: the goldens keep the JAX tests' bars; against JAX at f64, 1e-10
for the MLP's step and Jacobian (the same arithmetic), 1e-8 for solves (the
same iteration, summation order aside), rtol 1e-6 of the largest entry for
IFT gradients (GMRES in another summation order) and 1e-10 for KKT
gradients (no iterative solve)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.models import affine as jaff
from dilqr_tpu.models import nn_dynamics as jnn
from dilqr_tpu.models import pendulum as jpend
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.core.linearize import linearize_dynamics
from dilqr_tpu_torch.models import affine as taff
from dilqr_tpu_torch.models import ctrl_passthrough
from dilqr_tpu_torch.models import nn_dynamics as tnn
from dilqr_tpu_torch.models import pendulum as tpend
from dilqr_tpu_torch.ops.cuda import riccati_fused

F64 = torch.float64


def _bm(a):
    """time-major golden array -> batch-major tensor"""
    return from_numpy(np.swapaxes(np.asarray(a, np.float64), 0, 1))


def _tm(t):
    """batch-major result -> time-major numpy"""
    return np.swapaxes(t.detach().numpy(), 0, 1)


def _gold_cfg(g, **kw):
    T, _, nx = g["x"].shape
    base = dict(n_state=nx, n_ctrl=g["u"].shape[2], T=T, detach_unconverged=False,
                exit_unconverged=False, backprop=False)
    base.update(kw)
    return P.ILQRConfig(**base)


def test_slew_rate_golden(golden):
    g = golden("mpc_slew_pendulum_f64")
    cfg = _gold_cfg(g, lqr_iter=12, eps=1e-4, linesearch_decay=0.2, max_linesearch_iter=5,
                    slew_rate_penalty=1.0, qp_solver="pnqp")
    res = P.solve(cfg, from_numpy(g["x_init"]),
                  P.QuadCost(torch.diag(from_numpy(g["q"])), from_numpy(g["p"])), tpend.make(),
                  params=tpend.default_params(dtype=F64), u_lower=-2.0, u_upper=2.0,
                  prev_ctrl=from_numpy(g["prev_u"]))
    np.testing.assert_allclose(_tm(res.u), g["u"], atol=1e-6)
    np.testing.assert_allclose(_tm(res.x), g["x"], atol=1e-6)


def test_slew_rate_lindx_golden(golden):
    """The augmented-LinDx block build (nu=2) against the reference's."""
    g = golden("lqr_slew_lindx_f64")
    cfg = _gold_cfg(g, lqr_iter=10, eps=1e-7, slew_rate_penalty=1.5, qp_solver="pnqp")
    res = P.solve(cfg, from_numpy(g["x_init"]), P.QuadCost(_bm(g["C"]), _bm(g["c"])),
                  P.LinDx(_bm(g["F"]), _bm(g["f"])), u_lower=-0.5, u_upper=0.5,
                  prev_ctrl=from_numpy(g["prev_u"]))
    np.testing.assert_allclose(_tm(res.u), g["u"], atol=1e-6)
    np.testing.assert_allclose(_tm(res.x), g["x"], atol=1e-6)


def test_u_zero_golden(golden):
    g = golden("lqr_uzero_f64")
    res = P.solve(_gold_cfg(g, lqr_iter=8, eps=1e-7), from_numpy(g["x_init"]),
                  P.QuadCost(_bm(g["C"]), _bm(g["c"])), P.LinDx(_bm(g["F"]), _bm(g["f"])),
                  u_zero_I=torch.from_numpy(np.swapaxes(g["u_zero_I"], 0, 1)))
    u = _tm(res.u)
    np.testing.assert_allclose(u, g["u"], atol=1e-8)
    assert np.abs(u[g["u_zero_I"]]).max() == 0.0


def test_delta_u_golden(golden):
    g = golden("lqr_delta_u_f64")
    res = P.solve(_gold_cfg(g, lqr_iter=8, eps=1e-7), from_numpy(g["x_init"]),
                  P.QuadCost(_bm(g["C"]), _bm(g["c"])), P.LinDx(_bm(g["F"]), _bm(g["f"])),
                  u_lower=-0.5, u_upper=0.5, delta_u=0.2)
    np.testing.assert_allclose(_tm(res.u), g["u"], atol=1e-8)


def test_nn_dynamics_golden(golden):
    """The MLP's step and Jacobian against the reference's hand-backprop
    grad_input (dynamics.py:81-130)."""
    g = golden("nn_dynamics")
    dyn = tnn.make(3, 2, activation="sigmoid", passthrough=True)
    params = from_numpy([(g["W0"], g["b0"]), (g["W1"], g["b1"])])
    x, u = from_numpy(g["x"]), from_numpy(g["u"])
    # linearize_dynamics takes [T, B, ...] and drops the last step: lay the
    # points out as B=1 over T = 8 + 1
    X, U = torch.cat([x, x[:1]])[:, None], torch.cat([u, u[:1]])[:, None]
    F, _ = linearize_dynamics(dyn.step, params, X, U)
    np.testing.assert_allclose(dyn.step(x, u, params).numpy(), g["x_next"], atol=1e-10)
    np.testing.assert_allclose(F[:, 0, :, :3].numpy(), g["R"], atol=1e-10)
    np.testing.assert_allclose(F[:, 0, :, 3:].numpy(), g["S"], atol=1e-10)


def test_module_cost_golden(golden):
    """A callable cost, quadraticized every iteration (mpc.py:447-487)."""
    g = golden("mpc_module_cost_f64")
    w, target = from_numpy(g["w"]), from_numpy(g["target"])

    def cost_fn(tau):
        d = tau - target
        return 0.5 * (w * d * d).sum() + 0.1 * (d ** 4).sum()

    res = P.solve(_gold_cfg(g, lqr_iter=10, eps=1e-6), from_numpy(g["x_init"]), cost_fn,
                  P.LinDx(_bm(g["F"]), _bm(g["f"])))
    np.testing.assert_allclose(_tm(res.u), g["u"], atol=1e-6)
    np.testing.assert_allclose(_tm(res.x), g["x"], atol=1e-6)


# ---- the learned MLP model against the JAX package at f64 ----

def _mlp_weights(nx, nu, hidden, seed):
    """numpy weights with the init's distribution, U(+-1/sqrt(fan_in))."""
    rng = np.random.RandomState(seed)
    sizes = [nx + nu] + list(hidden) + [nx]
    return [(rng.uniform(-1, 1, (o, i)) / np.sqrt(i), rng.uniform(-1, 1, o) / np.sqrt(i))
            for i, o in zip(sizes[:-1], sizes[1:])]


def _jax_tree(ws):
    return [(jnp.asarray(W), jnp.asarray(b)) for W, b in ws]


@pytest.mark.parametrize("passthrough", [True, False])
@pytest.mark.parametrize("activation", ["sigmoid", "relu", "elu"])
@pytest.mark.parametrize("hidden", [(100,), (6, 6)])
def test_mlp_step_and_jacobian_match_jax_f64(hidden, activation, passthrough):
    nx, nu, B = 5, 1, 16
    ws = _mlp_weights(nx, nu, hidden, seed=len(hidden))
    rng = np.random.RandomState(1)
    x, u = rng.randn(B, nx), 3.0 * rng.randn(B, nu)
    jd = jnn.make(nx, nu, activation=activation, passthrough=passthrough)
    jp = _jax_tree(ws)
    want = jax.vmap(lambda a, b: jd.step(a, b, jp))(jnp.asarray(x), jnp.asarray(u))
    R = jax.vmap(lambda a, b: jax.jacfwd(jd.step, 0)(a, b, jp))(jnp.asarray(x), jnp.asarray(u))
    S = jax.vmap(lambda a, b: jax.jacfwd(jd.step, 1)(a, b, jp))(jnp.asarray(x), jnp.asarray(u))
    td = tnn.make(nx, nu, activation=activation, passthrough=passthrough, hidden_sizes=hidden)
    tx, tu, tp = from_numpy(x), from_numpy(u), from_numpy(ws)
    X, U = torch.stack([tx, tx]), torch.stack([tu, tu])  # T = 2: one linearized step
    F, _ = linearize_dynamics(td.step, tp, X, U)
    np.testing.assert_allclose(td.step(tx, tu, tp).numpy(), np.asarray(want), atol=1e-10)
    np.testing.assert_allclose(F[0, :, :, :nx].numpy(), np.asarray(R), atol=1e-10)
    np.testing.assert_allclose(F[0, :, :, nx:].numpy(), np.asarray(S), atol=1e-10)


def test_init_params_distribution():
    ps = tnn.init_params(5, 1, (100,), generator=torch.Generator().manual_seed(0),
                         dtype=F64)
    assert [tuple(W.shape) for W, _ in ps] == [(100, 6), (5, 100)]
    assert sum(W.numel() + b.numel() for W, b in ps) == 1205
    for (W, b), fan_in in zip(ps, (6, 100)):
        for a in (W, b):
            assert a.dtype == F64 and a.abs().max() <= fan_in ** -0.5
        assert W.abs().max() > 0.9 * fan_in ** -0.5


MLP_T, MLP_B = 6, 3


def _mlp_problem(seed=0):
    """A cartpole-sized learned model (5 states, 1 control, hidden 100),
    cartpole's true cost, starts near the upright, box +-5."""
    rng = np.random.RandomState(seed)
    th = np.pi + rng.uniform(-0.5, 0.5, MLP_B)
    x0 = np.stack([0.1 * rng.randn(MLP_B), np.zeros(MLP_B), np.cos(th), np.sin(th),
                   0.2 * rng.randn(MLP_B)], 1)
    from dilqr_tpu.models import cartpole as jcart
    q, c = (np.asarray(a, np.float64) for a in jcart.get_true_obj())
    return dict(ws=_mlp_weights(5, 1, (100,), seed=7), x0=x0, C=np.diag(q), c=c,
                wx=rng.randn(MLP_B, MLP_T, 5), wu=rng.randn(MLP_B, MLP_T, 1))


def _mlp_kw(**kw):
    base = dict(n_state=5, n_ctrl=1, T=MLP_T, lqr_iter=20, eps=1e-8, linesearch_decay=0.5,
                max_linesearch_iter=2, exit_unconverged=False, detach_unconverged=False)
    base.update(kw)
    return base


def test_mlp_solve_matches_jax_f64():
    pr = _mlp_problem()
    kw = _mlp_kw(backprop=False)
    want = J.solve(J.ILQRConfig(backend="xla", **kw), jnp.asarray(pr["x0"]),
                   J.QuadCost(jnp.asarray(pr["C"]), jnp.asarray(pr["c"])), jnn.make(5, 1),
                   params=_jax_tree(pr["ws"]), u_lower=-5.0, u_upper=5.0)
    got = P.solve(P.ILQRConfig(**kw), from_numpy(pr["x0"]),
                  P.QuadCost(from_numpy(pr["C"]), from_numpy(pr["c"])), tnn.make(5, 1),
                  params=from_numpy(pr["ws"]), u_lower=-5.0, u_upper=5.0)
    u = got.u.numpy()
    assert 0.0 < np.abs(u).max() and not (np.abs(np.abs(u) - 5.0) < 1e-9).all()
    np.testing.assert_allclose(u, np.asarray(want.u), atol=1e-8, rtol=0)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-8, rtol=0)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs), atol=1e-8, rtol=0)
    assert int(got.n_iter) == int(want.n_iter)


@pytest.mark.parametrize("mode,rtol", [("IFT", 1e-6), ("KKT", 1e-10)])
def test_mlp_grads_match_jax_f64(mode, rtol):
    """Gradients of sum(u wu) + sum(x wx) with respect to every weight of
    the MLP, through the backward of the given mode, against JAX's."""
    pr = _mlp_problem(seed=1)
    kw = _mlp_kw(backward_mode=mode)

    def jloss(ws):
        r = J.solve(J.ILQRConfig(backend="xla", **{**kw, "backward_mode": J.BackwardMode[mode]}),
                    jnp.asarray(pr["x0"]), J.QuadCost(jnp.asarray(pr["C"]), jnp.asarray(pr["c"])),
                    jnn.make(5, 1), params=ws, u_lower=-5.0, u_upper=5.0)
        return jnp.sum(r.u * pr["wu"]) + jnp.sum(r.x * pr["wx"])

    want = jax.tree_util.tree_leaves(jax.grad(jloss)(_jax_tree(pr["ws"])))
    ws = [tuple(a.requires_grad_(True) for a in layer) for layer in from_numpy(pr["ws"])]
    res = P.solve(P.ILQRConfig(**{**kw, "backward_mode": P.BackwardMode[mode]}),
                  from_numpy(pr["x0"]), P.QuadCost(from_numpy(pr["C"]), from_numpy(pr["c"])),
                  tnn.make(5, 1), params=ws, u_lower=-5.0, u_upper=5.0)
    loss = (res.u * from_numpy(pr["wu"])).sum() + (res.x * from_numpy(pr["wx"])).sum()
    got = torch.autograd.grad(loss, [a for layer in ws for a in layer])
    assert len(got) == len(want) == 4
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    assert scale > 1e-3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=rtol * scale)


def test_solve_takes_pytree_params():
    """solve moves and casts each leaf of a pytree of params and keeps its
    structure: the MLP's [(W, b), ...] from float64 numpy arrays to f32 on
    the tensors' device, and the affine model's dict with c=None. The
    affine solve matches JAX's at f64."""
    pr = _mlp_problem()
    cfg = P.ILQRConfig(**_mlp_kw(backprop=False, lqr_iter=3))
    res = P.solve(cfg, from_numpy(pr["x0"], dtype=torch.float32),
                  P.QuadCost(from_numpy(pr["C"]), from_numpy(pr["c"])), tnn.make(5, 1),
                  params=[(np.asarray(W), np.asarray(b)) for W, b in pr["ws"]],
                  u_lower=-5.0, u_upper=5.0)
    assert res.u.dtype == torch.float32 and torch.isfinite(res.costs).all()

    rng = np.random.RandomState(3)
    A, Bm = np.eye(3) + 0.1 * rng.randn(3, 3), rng.randn(3, 1)
    x0 = rng.randn(4, 3)
    kw = dict(n_state=3, n_ctrl=1, T=5, lqr_iter=5, eps=1e-8, backprop=False,
              exit_unconverged=False)
    q, c = np.ones(4), 0.1 * np.ones(4)
    want = J.solve(J.ILQRConfig(backend="xla", **kw), jnp.asarray(x0),
                   J.QuadCost(jnp.diag(jnp.asarray(q)), jnp.asarray(c)), jaff.make(3, 1),
                   params=jaff.params(A, Bm), u_lower=-0.5, u_upper=0.5)
    got = P.solve(P.ILQRConfig(**kw), from_numpy(x0),
                  P.QuadCost(torch.diag(from_numpy(q)), from_numpy(c)), taff.make(3, 1),
                  params=taff.params(from_numpy(A), from_numpy(Bm)), u_lower=-0.5, u_upper=0.5)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-8, rtol=0)


def _slew_problem():
    rng = np.random.RandomState(4)
    th = rng.uniform(-2.0, 2.0, 4)
    x0 = np.stack([np.cos(th), np.sin(th), 0.3 * rng.randn(4)], 1)
    q, c = (np.asarray(a, np.float64) for a in jpend.get_true_obj())
    return x0, q, c, 0.5 * rng.randn(4, 1)


@pytest.mark.parametrize("cost_kind", ["quad", "callable"])
def test_slew_rate_pendulum_matches_jax_f64(cost_kind):
    """The slew-rate pendulum with the closed-form QP (the kernel's mode),
    a QuadCost or a callable cost, against JAX's augmentation."""
    x0, q, c, prev = _slew_problem()
    kw = dict(n_state=3, n_ctrl=1, T=8, lqr_iter=10, eps=1e-8, linesearch_decay=0.2,
              max_linesearch_iter=5, backprop=False, exit_unconverged=False,
              slew_rate_penalty=0.5)

    def jcost():
        if cost_kind == "quad":
            return J.QuadCost(jnp.diag(jnp.asarray(q)), jnp.asarray(c))
        return lambda tau: 0.5 * jnp.sum(jnp.asarray(q) * tau * tau) + jnp.sum(jnp.asarray(c) * tau)

    def tcost():
        tq, tc = from_numpy(q), from_numpy(c)
        if cost_kind == "quad":
            return P.QuadCost(torch.diag(tq), tc)
        return lambda tau: 0.5 * (tq * tau * tau).sum() + (tc * tau).sum()

    want = J.solve(J.ILQRConfig(backend="xla", **kw), jnp.asarray(x0), jcost(), jpend.make(),
                   params=jnp.asarray(jpend.default_params(), jnp.float64), u_lower=-2.0,
                   u_upper=2.0, prev_ctrl=jnp.asarray(prev))
    got = P.solve(P.ILQRConfig(**kw), from_numpy(x0), tcost(), tpend.make(),
                  params=tpend.default_params(dtype=F64), u_lower=-2.0, u_upper=2.0,
                  prev_ctrl=from_numpy(prev))
    assert got.x.shape == (4, 8, 3)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-8, rtol=0)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-8, rtol=0)


def test_ctrl_passthrough_steps_the_augmented_state():
    dyn = tpend.make()
    aug = ctrl_passthrough.make(dyn)
    # the simple pendulum's wrapper has device code (Passthrough<Pendulum>,
    # ENV_PENDULUM_SLEW in csrc/ilqr_fused.cuh); so has the complex
    # pendulum's (ENV_PENDULUM_COMPLEX_SLEW), with no hand Jacobian
    assert (aug.n_state, aug.n_ctrl, aug.device_env) == (4, 1, 4)
    aug_c = ctrl_passthrough.make(tpend.make(simple=False))
    assert (aug_c.device_env, aug_c.jac_lanes) == (8, None)
    p = tpend.default_params(dtype=F64)
    xa = torch.tensor([[0.3, 1.0, 0.0, 0.2]], dtype=F64)
    u = torch.tensor([[0.7]], dtype=F64)
    out = aug.step(xa, u, p)
    torch.testing.assert_close(out, torch.cat([u, dyn.step(xa[:, 1:], u, p)], -1))
    torch.testing.assert_close(aug.kernel_step(xa, u, p),
                               torch.cat([u, dyn.kernel_step(xa[:, 1:], u, p)], -1))
    # a wrapper without device code takes the plain loop, whose one-control
    # f32 Riccati the CUDA Riccati kernel covers at the augmented size
    assert riccati_fused.covered(aug.n_state, 1, torch.float32, None, "auto", True)
