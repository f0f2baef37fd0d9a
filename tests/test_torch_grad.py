"""The port's backward through the solver: GMRES against JAX's, the IFT, KKT
and UNROLL gradients of pendulum and cartpole solves against the JAX
package at f64, the rocket's IFT gradient against JAX's UNROLL oracle and
its KKT gradient against JAX's KKT, and the backward's options (detach_unconverged,
kkt_grad_through_F, the dense adjoint solve, the per-example dense repair,
a (cost_fn, cost_params) cost). Inputs are made with numpy from a seed.

Tolerances: 1e-10 for GMRES at f64 (the same arithmetic); rtol 1e-6 of the
largest gradient entry for the gradients at f64 (the same algorithm,
summation order aside: measured differences are ~1e-8 relative); 1e-4
between IFT and UNROLL, and between the dense and GMRES adjoint (two
algorithms for one implicit gradient, tests/test_grad_modes.py's bars);
rtol 2e-4 in f32 against JAX's Pallas KKT kernel in interpret mode
(tests/test_kkt_fused.py:111-142)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.models import cartpole as jcart
from dilqr_tpu.models import pendulum as jpend
from dilqr_tpu.models import rocket as jrock
from dilqr_tpu.ops.gmres import gmres as j_gmres
from dilqr_tpu.ops.gmres import gmres_batched as j_gmres_batched
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.diff import modes as M
from dilqr_tpu_torch.models import cartpole as tcart
from dilqr_tpu_torch.models import pendulum as tpend
from dilqr_tpu_torch.models import rocket as trock
from dilqr_tpu_torch.ops.cuda import ilqr_fused, kkt_fused
from dilqr_tpu_torch.ops.gmres import gmres, gmres_batched
from rocket_bench_start import bench_start

ENVS = {"pendulum": (jpend, tpend), "cartpole": (jcart, tcart)}


def test_gmres_batched_matches_jax_f64():
    """One ill-conditioned example with a tiny right-hand side beside an
    easy one (tests/test_grad_modes.py:233-272): the same per-example
    residuals and solutions as JAX, the hard example flagged, the global
    form blind to it."""
    d, tol = 8, 1e-4
    A0 = np.diag(np.logspace(-3, 0, d))
    A1 = np.eye(d)
    b = np.stack([np.full(d, 1e-6), np.ones(d)])[None]  # [1, B=2, d]

    def j_mv(x):
        (xb,) = x
        return (jnp.stack([jnp.asarray(A0) @ xb[0, 0], jnp.asarray(A1) @ xb[0, 1]])[None],)

    tA0, tA1 = from_numpy(A0), from_numpy(A1)

    def t_mv(x):
        (xb,) = x
        return (torch.stack([tA0 @ xb[0, 0], tA1 @ xb[0, 1]])[None],)

    kw = dict(tol=tol, restart=3, maxiter=1)
    jx, jres, jbn = j_gmres_batched(j_mv, (jnp.asarray(b),), x0=(jnp.asarray(b),), **kw)
    tx, tres, tbn = gmres_batched(t_mv, (from_numpy(b),), x0=(from_numpy(b),), **kw)
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tbn.numpy(), np.asarray(jbn), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tx[0].numpy(), np.asarray(jx[0]), rtol=0, atol=1e-10)
    bad = (tres > tol * tbn).numpy()
    assert bad[0] and not bad[1]
    np.testing.assert_allclose(tx[0][0, 1].numpy(), np.ones(d), rtol=1e-10)
    # the global criterion passes silently on the same system
    _, gres, gbn = gmres(t_mv, (from_numpy(b),), x0=(from_numpy(b),), return_info=True, **kw)
    _, jgres, _ = j_gmres(j_mv, (jnp.asarray(b),), x0=(jnp.asarray(b),), return_info=True,
                          **kw)
    assert float(gres) <= tol * float(gbn)
    np.testing.assert_allclose(float(gres), float(jgres), rtol=1e-8, atol=1e-14)


def _problem(name, B, T, seed):
    rng = np.random.RandomState(seed)
    th = rng.uniform(-1.2, 1.2, B) + (np.pi if name == "cartpole" else 0.0)
    w = rng.uniform(-1, 1, B)
    if name == "pendulum":
        x0 = np.stack([np.cos(th), np.sin(th), w], 1)
    else:
        x0 = np.stack([0.1 * rng.randn(B), np.zeros(B), np.cos(th), np.sin(th), w], 1)
    jm, _ = ENVS[name]
    nx = x0.shape[1]
    q, c = (np.asarray(a, np.float64) for a in jm.get_true_obj())
    return dict(x0=x0, wx=rng.randn(B, T, nx), wu=rng.randn(B, T, 1),
                p=np.asarray(jm.default_params(), np.float64), C=np.diag(q), c=c)


def _cfg_kw(name, T, mode, **kw):
    jm, _ = ENVS[name]
    dyn = jm.make()
    base = dict(n_state=dyn.n_state, n_ctrl=1, T=T, lqr_iter=20,
                eps=1e-6, linesearch_decay=dyn.linesearch_decay,
                max_linesearch_iter=dyn.max_linesearch_iter, detach_unconverged=False,
                exit_unconverged=False, unroll=mode == "UNROLL")
    base.update(kw)
    return base


def _jax_grads(name, mode, pr, **kw):
    jm, _ = ENVS[name]
    dyn = jm.make()
    cfg = J.ILQRConfig(backward_mode=getattr(J.BackwardMode, mode), backend="xla",
                       **_cfg_kw(name, pr["wx"].shape[1], mode, **kw))

    def loss(p, C, c, xi):
        r = J.solve(cfg, xi, J.QuadCost(C, c), dyn, params=p, u_lower=dyn.lower,
                    u_upper=dyn.upper)
        return jnp.sum(r.u * pr["wu"]) + jnp.sum(r.x * pr["wx"])

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(pr[k]) for k in ("p", "C", "c", "x0")))
    return [np.asarray(a) for a in g]


def _port_grads(name, mode, pr, dtype=torch.float64, **kw):
    _, tm = ENVS[name]
    dyn = tm.make()
    cfg = P.ILQRConfig(backward_mode=getattr(P.BackwardMode, mode),
                       **_cfg_kw(name, pr["wx"].shape[1], mode, **kw))
    ins = [from_numpy(pr[k], dtype=dtype).requires_grad_(True) for k in ("p", "C", "c", "x0")]
    p, C, c, xi = ins
    res = P.solve(cfg, xi, P.QuadCost(C, c), dyn, params=p, u_lower=dyn.lower,
                  u_upper=dyn.upper)
    loss = (res.u * from_numpy(pr["wu"], dtype=dtype)).sum() + (
        res.x * from_numpy(pr["wx"], dtype=dtype)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, ins)]


def _assert_close_rel(got, want, rtol, names=("dparams", "dC", "dc", "dx_init")):
    for a, b, n in zip(got, want, names):
        if n == "dC":  # the IFT/KKT dC is the symmetrized cotangent
            a = 0.5 * (a + np.swapaxes(a, -1, -2))
            b = 0.5 * (b + np.swapaxes(b, -1, -2))
        err = np.abs(a - b).max() / max(1.0, np.abs(b).max())
        assert err <= rtol, f"{n}: rel err {err:.2e}\n{a}\n{b}"


@pytest.mark.parametrize("mode", ["IFT", "KKT", "UNROLL"])
@pytest.mark.parametrize("name", ["pendulum", "cartpole"])
def test_grads_match_jax_f64(name, mode):
    pr = _problem(name, B=3, T=8, seed=0)
    _assert_close_rel(_port_grads(name, mode, pr), _jax_grads(name, mode, pr), rtol=1e-6)


def _rocket_problem(B, T, seed):
    """bench.py's rocket start (near hover), f64, with random loss weights."""
    rng = np.random.RandomState(seed)
    x0 = bench_start(B, rng, dtype=np.float64)
    q, c = (np.asarray(a, np.float64) for a in jrock.get_true_obj())
    return dict(x0=x0, wx=rng.randn(B, T, 13), wu=rng.randn(B, T, 3),
                p=np.asarray(jrock.default_params(), np.float64), C=np.diag(q), c=c)


def _rocket_kw(T, mode):
    dyn = jrock.make()
    return dict(n_state=13, n_ctrl=3, T=T, lqr_iter=30, eps=1e-8,
                linesearch_decay=dyn.linesearch_decay, max_linesearch_iter=dyn.max_linesearch_iter,
                detach_unconverged=False, exit_unconverged=False, unroll=mode == "UNROLL")


def _rocket_grads(pkg, mode, pr, hi):
    """Gradients of sum(u wu) + sum(x wx) with respect to (params, C, c,
    x_init) through package pkg ("jax" or "port"), bounds -hi..hi ([3])."""
    T = pr["wx"].shape[1]
    keys = ("p", "C", "c", "x0")
    if pkg == "jax":
        dyn = jrock.make()
        cfg = J.ILQRConfig(backward_mode=getattr(J.BackwardMode, mode), backend="xla",
                           **_rocket_kw(T, mode))

        def loss(p, C, c, xi):
            r = J.solve(cfg, xi, J.QuadCost(C, c), dyn, params=p, u_lower=jnp.asarray(-hi),
                        u_upper=jnp.asarray(hi))
            return jnp.sum(r.u * pr["wu"]) + jnp.sum(r.x * pr["wx"])

        g = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(pr[k]) for k in keys))
        return [np.asarray(a) for a in g]
    cfg = P.ILQRConfig(backward_mode=getattr(P.BackwardMode, mode), **_rocket_kw(T, mode))
    ins = [from_numpy(pr[k]).requires_grad_(True) for k in keys]
    p, C, c, xi = ins
    res = P.solve(cfg, xi, P.QuadCost(C, c), trock.make(), params=p, u_lower=from_numpy(-hi),
                  u_upper=from_numpy(hi))
    assert bool(res.converged.all())
    loss = (res.u * from_numpy(pr["wu"])).sum() + (res.x * from_numpy(pr["wx"])).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, ins)]


@pytest.mark.parametrize("mode", ["IFT", "KKT"])
def test_rocket_grads_match_jax_f64(mode):
    """The rocket's gradients (13 states, 3 controls, all 5 params through
    the linearization VJP) at f64, T=5, B=2. IFT against JAX's UNROLL
    oracle: at a converged fixed point the implicit gradient is the true
    one (1e-4, the bar of scripts/fuzz_gradients.py). KKT against JAX's
    KKT (1e-6, the same algorithm: on a nonlinear env it differentiates the
    last LQR subproblem only, so it is not held to the oracle), with tight
    per-control bounds: the frozen active set comes from [3] bounds."""
    pr = _rocket_problem(B=2, T=5, seed=0)
    if mode == "IFT":
        hi = np.full(3, 20.0)
        got, want, rtol = _rocket_grads("port", "IFT", pr, hi), _rocket_grads(
            "jax", "UNROLL", pr, hi), 1e-4
    else:
        hi = np.array([0.3, 0.05, 0.05])
        got, want, rtol = _rocket_grads("port", "KKT", pr, hi), _rocket_grads(
            "jax", "KKT", pr, hi), 1e-6
    assert np.abs(got[0]).max() > 1e-2
    _assert_close_rel(got, want, rtol=rtol)


def test_rocket_ift_matches_port_unroll():
    """The port's own UNROLL (plain autograd through the plain loop)
    against its IFT on the rocket (1e-4)."""
    pr = _rocket_problem(B=2, T=5, seed=0)
    hi = np.full(3, 20.0)
    _assert_close_rel(_rocket_grads("port", "IFT", pr, hi), _rocket_grads("port", "UNROLL", pr, hi),
                      rtol=1e-4)


def test_ift_matches_unrolled():
    pr = _problem("pendulum", B=3, T=10, seed=1)
    _assert_close_rel(_port_grads("pendulum", "IFT", pr), _port_grads("pendulum", "UNROLL", pr),
                      rtol=1e-4)


def test_dense_ift_matches_gmres():
    pr = _problem("pendulum", B=3, T=6, seed=2)
    _assert_close_rel(_port_grads("pendulum", "IFT", pr, ift_solver="dense"),
                      _port_grads("pendulum", "IFT", pr), rtol=1e-4)


@pytest.mark.parametrize("mode", ["IFT", "UNROLL"])
def test_detach_unconverged(mode):
    """With too few iterations some examples do not converge: their
    gradients vanish, the converged examples' stay as they were."""
    pr = _problem("pendulum", B=3, T=6, seed=3)
    kw = dict(lqr_iter=3, eps=1e-3)
    on = _port_grads("pendulum", mode, pr, detach_unconverged=True, **kw)
    off = _port_grads("pendulum", mode, pr, detach_unconverged=False, **kw)
    _, tm = ENVS["pendulum"]
    cfg = P.ILQRConfig(**{**_cfg_kw("pendulum", 6, mode, **kw), "backprop": False})
    conv = P.solve(cfg, from_numpy(pr["x0"]), P.QuadCost(from_numpy(pr["C"]), from_numpy(pr["c"])),
                   tm.make(), params=from_numpy(pr["p"]), u_lower=-2.0, u_upper=2.0).converged
    conv = conv.numpy()
    assert conv.any() and not conv.all(), conv
    dxi_on, dxi_off = on[3], off[3]
    assert not dxi_on[~conv].any()
    np.testing.assert_allclose(dxi_on[conv], dxi_off[conv], rtol=1e-12, atol=1e-12)


def test_kkt_grad_through_F_false_drops_only_dF_dtheta():
    """kkt_grad_through_F=False changes the params gradient alone (F is a
    constant in the chain); x_init, C and c get the same cotangents."""
    pr = _problem("pendulum", B=2, T=6, seed=4)
    a = _port_grads("pendulum", "KKT", pr, kkt_grad_through_F=False)
    b = _port_grads("pendulum", "KKT", pr)
    for i in (1, 2, 3):
        np.testing.assert_allclose(a[i], b[i], rtol=0, atol=1e-12)
    assert np.abs(a[0] - b[0]).max() > 1e-6


def test_ift_underconverged_falls_back_to_dense():
    """A starved GMRES (restart=1, maxiter=1, tol=1e-10) warns and repairs
    every failing example with the dense solve: the gradient then equals
    ift_solver="dense"; without the fallback it does not."""
    pr = _problem("pendulum", B=2, T=6, seed=0)  # example 0 fails, example 1 does not
    kw = dict(lqr_iter=2, ift_tol=1e-10, ift_restart=1, ift_maxiter=1)
    with pytest.warns(UserWarning, match="falling back to the dense"):
        g_fb = _port_grads("pendulum", "IFT", pr, **kw)
    g_d = _port_grads("pendulum", "IFT", pr, ift_solver="dense", **kw)
    with pytest.warns(UserWarning, match="may be inaccurate"):
        g_raw = _port_grads("pendulum", "IFT", pr, ift_fallback=False, **kw)
    _assert_close_rel(g_fb, g_d, rtol=1e-6)
    assert max(np.abs(a - b).max() for a, b in zip(g_raw, g_d)) > 1e-8


def test_ift_per_example_dense_repair(monkeypatch):
    """The repair touches only the examples reported bad; an unreported
    corruption stays in its own example (the backward is per-example)."""
    pr = _problem("pendulum", B=3, T=4, seed=6)
    kw = dict(lqr_iter=6, ift_restart=6, ift_maxiter=2)
    g_ref = _port_grads("pendulum", "IFT", pr, **kw)[3]
    orig = M.solve_adjoint_fixed_point

    def sabotage(report):
        def fn(sT_Ff, lT_xu, v, **k):
            (wx, wu), res_b, b_b = orig(sT_Ff, lT_xu, v, **k)
            wx, wu = wx.clone(), wu.clone()
            wx[:, 1] += 100.0
            wu[:, 1] -= 50.0
            if report:
                res_b = res_b.clone()
                res_b[1] = 1e6
            return (wx, wu), res_b, b_b
        return fn

    monkeypatch.setattr(M, "solve_adjoint_fixed_point", sabotage(True))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g_rep = _port_grads("pendulum", "IFT", pr, **kw)[3]
    err = np.abs(g_rep - g_ref).max(axis=1)
    assert err[0] == 0.0 and err[2] == 0.0, err
    assert err[1] <= 1e-4 * np.abs(g_ref).max(), err
    monkeypatch.setattr(M, "solve_adjoint_fixed_point", sabotage(False))
    g_bad = _port_grads("pendulum", "IFT", pr, **kw)[3]
    err2 = np.abs(g_bad - g_ref).max(axis=1)
    assert err2[1] > 1.0 and err2[0] == 0.0 and err2[2] == 0.0, err2


def _cost_fn(tau, w):
    return 0.5 * (w * tau * tau).sum() + 0.1 * (tau[0] - 1.0) ** 4


def _callable_cost_grads(mode, pr, w):
    kw = _cfg_kw("pendulum", 6, mode, lqr_iter=30)
    tw, tp = from_numpy(w).requires_grad_(True), from_numpy(pr["p"]).requires_grad_(True)
    res = P.solve(P.ILQRConfig(backward_mode=getattr(P.BackwardMode, mode), **kw),
                  from_numpy(pr["x0"]), (_cost_fn, tw), tpend.make(), params=tp,
                  u_lower=-2.0, u_upper=2.0)
    loss = (res.u * from_numpy(pr["wu"])).sum() + (res.x * from_numpy(pr["wx"])).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (tw, tp))]


def test_callable_cost_params_grad():
    """A (cost_fn, cost_params) cost: the IFT backward returns the cost
    parameters' gradient through the quadraticization's VJP; UNROLL
    differentiates the same closure by plain autograd."""
    pr = _problem("pendulum", B=2, T=6, seed=7)
    th = np.array([0.3, -0.2])  # small angles: the torque stays inside its box
    pr["x0"] = np.stack([np.cos(th), np.sin(th), np.array([0.1, -0.1])], 1)
    w = np.asarray(jpend.get_true_obj()[0], np.float64)
    got = _callable_cost_grads("IFT", pr, w)
    assert np.abs(got[0]).max() > 1e-3
    _assert_close_rel(got, _callable_cost_grads("UNROLL", pr, w), rtol=1e-4,
                      names=("dw", "dparams"))


def test_f32_ift_auto_matches_jax_pallas_kkt():
    """f32 IFT gradient, backward_backend="auto" on CPU tensors (the plain
    recursions), against JAX with backend="pallas": its forward and its KKT
    kernel in interpret mode; the port launches no CUDA kernel. Small
    angles keep the torques inside their box: with every control at a
    bound, d mean(u^2) / d params is zero in both packages."""
    pr = _problem("pendulum", B=3, T=8, seed=8)
    th = np.array([0.3, -0.2, 0.1])
    pr["x0"] = np.stack([np.cos(th), np.sin(th), np.array([0.1, -0.1, 0.0])], 1)
    kw = _cfg_kw("pendulum", 8, "IFT", lqr_iter=8, eps=1e-4)
    dyn = jpend.make()
    cfg = J.ILQRConfig(backward_mode=J.BackwardMode.IFT, backend="pallas", **kw)
    f32 = lambda k: jnp.asarray(pr[k], jnp.float32)  # noqa: E731

    def jl(p_):
        r = J.solve(cfg, f32("x0"), J.QuadCost(f32("C"), f32("c")), dyn, params=p_,
                    u_lower=-2.0, u_upper=2.0)
        return jnp.mean(r.u ** 2)

    want = np.asarray(jax.grad(jl)(f32("p")))
    before = (kkt_fused.LAUNCHES, ilqr_fused.LAUNCHES)
    tp = from_numpy(pr["p"], dtype=torch.float32).requires_grad_(True)
    t32 = lambda k: from_numpy(pr[k], dtype=torch.float32)  # noqa: E731
    res = P.solve(P.ILQRConfig(backward_mode=P.BackwardMode.IFT, backward_backend="auto", **kw),
                  t32("x0"), P.QuadCost(t32("C"), t32("c")), tpend.make(), params=tp,
                  u_lower=-2.0, u_upper=2.0)
    (got,) = torch.autograd.grad((res.u ** 2).mean(), tp)
    assert (kkt_fused.LAUNCHES, ilqr_fused.LAUNCHES) == before
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-6)


def test_backprop_default_mpc_is_differentiable():
    """MPC's defaults (backprop=True, KKT mode) give a differentiable
    result."""
    pr = _problem("cartpole", B=2, T=6, seed=9)
    tp = from_numpy(pr["p"], dtype=torch.float32).requires_grad_(True)
    x, u, _ = P.MPC(5, 1, 6, u_lower=-100.0, u_upper=100.0, lqr_iter=5, eps=1e-4,
                    exit_unconverged=False, detach_unconverged=False)(
        from_numpy(pr["x0"], dtype=torch.float32),
        P.QuadCost(from_numpy(pr["C"], dtype=torch.float32),
                   from_numpy(pr["c"], dtype=torch.float32)), tcart.make(), params=tp)
    (g,) = torch.autograd.grad((u ** 2).sum() + x.sum(), tp)
    assert g.dtype == torch.float32 and torch.isfinite(g).all() and g.abs().sum() > 0

