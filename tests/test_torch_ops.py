"""ops of the PyTorch port (pnqp, the sequential Riccati, the rollout and
line search) against the JAX package at f64 and against the reference's
goldens. Inputs are made with numpy from a seed; the port gets them through
convert.from_numpy.

Tolerances: 1e-9 at f64 where both packages run the same recursion (only
summation order differs); the goldens keep the JAX tests' own bounds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dilqr_tpu.models import pendulum as jpend
from dilqr_tpu.ops.riccati import lqr_backward as j_backward
from dilqr_tpu.ops.rollout import lqr_forward as j_forward
from dilqr_tpu.types import LinDx as JLinDx
from dilqr_tpu.types import QuadCost as JQuadCost
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.models import pendulum as tpend
from dilqr_tpu_torch.ops.pnqp import pnqp as tpnqp
from dilqr_tpu_torch.ops.riccati import lqr_backward as t_backward
from dilqr_tpu_torch.ops.rollout import lqr_forward as t_forward

F32 = torch.float32


@pytest.mark.parametrize("name,warm", [("pnqp", False), ("pnqp", True), ("pnqp_n1", False)])
def test_pnqp_golden(golden, name, warm):
    """The reference's pnqp goldens at f32, the JAX test's bound
    (tests/test_pnqp.py): x to 2e-5, the free set exactly."""
    g = golden(name)
    x_init = from_numpy(golden("pnqp_warm")["x_init"], dtype=F32) if warm else None
    res = tpnqp(from_numpy(g["H"], dtype=F32), from_numpy(g["q"], dtype=F32),
                from_numpy(g["lower"], dtype=F32), from_numpy(g["upper"], dtype=F32),
                x_init=x_init, n_iter=20)
    want = golden("pnqp_warm") if warm else g
    np.testing.assert_allclose(res.x.numpy(), want["x"], atol=2e-5)
    if "If" in want and name != "pnqp_n1":
        np.testing.assert_array_equal(res.If.numpy(), want["If"])


def _problem(seed, T, B, nx, nu):
    rng = np.random.RandomState(seed)
    n = nx + nu
    A = rng.randn(T, B, n, n)
    C = A @ A.transpose(0, 1, 3, 2) + 2.0 * np.eye(n)
    c = rng.randn(T, B, n)
    F = 0.3 * rng.randn(T - 1, B, nx, n)
    f = 0.2 * rng.randn(T - 1, B, nx)
    u = 0.5 * rng.randn(T, B, nu)
    uz = rng.rand(T, B, nu) < 0.3
    return C, c, F, f, u, uz


# (bounds, u_zero_I, qp_solver, delta_u, use f)
GAIN_MODES = {
    "free": (None, False, "auto", None, True),
    "zero_mask": (None, True, "auto", None, False),
    "box_auto": (0.6, False, "auto", None, False),
    "box_pnqp": (0.6, False, "pnqp", None, False),
    "box_delta": (0.6, False, "pnqp", 0.3, False),
}


@pytest.mark.parametrize("nu", [1, 2])
@pytest.mark.parametrize("mode", list(GAIN_MODES))
def test_lqr_backward_matches_jax_f64(mode, nu):
    bound, use_uz, qp, delta_u, use_f = GAIN_MODES[mode]
    T, B, nx = 6, 5, 4
    C, c, F, f, u, uz = _problem(3, T, B, nx, nu)
    kw = dict(qp_solver=qp, delta_u=delta_u)
    if bound is not None:
        kw.update(u_lower=-bound, u_upper=bound)
    f_in = f if use_f else None
    uz_in = uz if use_uz else None
    want = j_backward(nx, nu, jnp.asarray(C), jnp.asarray(c), jnp.asarray(F),
                      None if f_in is None else jnp.asarray(f_in), jnp.asarray(u),
                      u_zero_I=None if uz_in is None else jnp.asarray(uz_in),
                      backend="xla", **kw)
    got = t_backward(nx, nu, *from_numpy((C, c, F, f_in, u)),
                     u_zero_I=from_numpy(uz_in), **kw)
    np.testing.assert_allclose(got.K.numpy(), np.asarray(want.K), atol=1e-9, rtol=0)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=1e-9, rtol=0)


@pytest.mark.parametrize("dyn_kind", ["pendulum", "lindx"])
def test_lqr_forward_matches_jax_f64(dyn_kind):
    """Closed-loop rollout with the per-example line search: the accepted
    trajectory, its objective and the diagnostics."""
    T, B = 7, 6
    rng = np.random.RandomState(5)
    if dyn_kind == "pendulum":
        nx, nu = 3, 1
        th = rng.uniform(-2, 2, B)
        x_init = np.stack([np.cos(th), np.sin(th), rng.randn(B)], 1)
        p = np.asarray(jpend.default_params(), np.float64)
        jdyn = (jpend.make().step, jnp.asarray(p))
        tdyn = (tpend.make().step, from_numpy(p))
        kw = dict(u_lower=-2.0, u_upper=2.0)
    else:
        nx, nu = 3, 2
        x_init = rng.randn(B, nx)
        F = 0.4 * rng.randn(T - 1, B, nx, nx + nu)
        f = 0.1 * rng.randn(T - 1, B, nx)
        jdyn, tdyn = JLinDx(jnp.asarray(F), jnp.asarray(f)), P.LinDx(*from_numpy((F, f)))
        kw = dict(u_lower=-0.5, u_upper=0.5, delta_u=0.4)
    n = nx + nu
    A = rng.randn(T, B, n, n)
    C = A @ A.transpose(0, 1, 3, 2) + np.eye(n)
    c = rng.randn(T, B, n)
    x = rng.randn(T, B, nx)
    u = 0.5 * rng.randn(T, B, nu)
    K = 0.3 * rng.randn(T, B, nu, nx)
    k = rng.randn(T, B, nu)
    args = (x_init, x, u, K, k)
    ls = dict(linesearch_decay=0.3, max_linesearch_iter=4)
    jx, ju, jout = j_forward(T, nx, nu, jnp.asarray(x_init), JQuadCost(jnp.asarray(C), jnp.asarray(c)),
                             jdyn, *[jnp.asarray(a) for a in args[1:]], **kw, **ls)
    tx, tu, tout = t_forward(T, nx, nu, from_numpy(x_init), P.QuadCost(*from_numpy((C, c))),
                             tdyn, *from_numpy(args[1:]), **kw, **ls)
    for got, want in [(tx, jx), (tu, ju), (tout.objs, jout.objs), (tout.costs, jout.costs),
                      (tout.full_du_norm, jout.full_du_norm),
                      (tout.alpha_du_norm, jout.alpha_du_norm),
                      (tout.mean_alphas, jout.mean_alphas)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9, rtol=0)


@pytest.mark.parametrize("tag,bound", [("unc", None), ("box", 0.5)])
def test_lindx_forward_golden(golden, tag, bound):
    """The reference's LinDx LQR goldens through the port's solve, at the
    JAX test's f32 bounds (tests/test_lqr_golden.py)."""
    g = golden(f"lqr_lindx_{tag}")
    T, B, nx = g["F"].shape[0] + 1, g["F"].shape[1], g["F"].shape[2]
    nu = g["F"].shape[3] - nx

    def bm(a):
        return from_numpy(a, dtype=F32).transpose(0, 1)

    cfg = P.ILQRConfig(n_state=nx, n_ctrl=nu, T=T, lqr_iter=10, eps=1e-7,
                       detach_unconverged=False, exit_unconverged=False, backprop=False)
    res = P.solve(cfg, from_numpy(g["x_init"], dtype=F32), P.QuadCost(bm(g["C"]), bm(g["c"])),
                  P.LinDx(bm(g["F"]), bm(g["f"])),
                  u_lower=None if bound is None else -bound,
                  u_upper=None if bound is None else bound)
    np.testing.assert_allclose(res.u.transpose(0, 1).numpy(), g["u"], atol=1e-4)
    np.testing.assert_allclose(res.x.transpose(0, 1).numpy(), g["x"], atol=1e-4)
    np.testing.assert_allclose(res.costs.numpy(), g["objs"], rtol=1e-4)
