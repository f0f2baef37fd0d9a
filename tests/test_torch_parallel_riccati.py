"""The port's associative-scan Riccati (ops/parallel_riccati.py) and the
paths that reach it with riccati_parallel: the scan alone against a
sequential fold, plqr_backward / plqr_rollout / plqr_solve against the
JAX package's at f64 on JAX's test shapes, unmasked and masked, the f32
long horizon, the KKT VJP's parallel form, and the solve and its
gradients with riccati_parallel against JAX's.

Tolerances: 1e-12 for the scan against the fold at f64 (the same
products, grouped otherwise); atol 1e-10 for plqr_* at f64 and 5e-4 at f32
T=128 (tests/test_parallel_riccati.py's bars); atol 1e-9 for the KKT VJP
(tests/test_parallel_riccati.py:144-171); rtol 1e-8 for the solve and the
IFT gradient at f64 (the same algorithm on the same data, summation order
aside)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.diff.kkt import kkt_vjp as j_kkt_vjp
from dilqr_tpu.models import pendulum as jpend
from dilqr_tpu.ops import parallel_riccati as jpr
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.diff import kkt as tkkt
from dilqr_tpu_torch.models import pendulum as tpend
from dilqr_tpu_torch.ops import parallel_riccati as tpr
from dilqr_tpu_torch.ops.cuda import kkt_fused, riccati_fused
from dilqr_tpu_torch.ops.riccati import lqr_backward
from dilqr_tpu_torch.ops.rollout import get_traj

j_backward = jax.jit(jpr.plqr_backward, static_argnums=(0, 1))
j_solve = jax.jit(jpr.plqr_solve, static_argnums=(0, 1))
j_rollout = jax.jit(jpr.plqr_rollout, static_argnums=(0,))


def _problem(T, B, nx, nu, seed=0, dtype=np.float64):
    """tests/test_parallel_riccati.py's problem, as numpy."""
    n = nx + nu
    rng = np.random.RandomState(seed)
    A = rng.randn(T, B, n, n)
    C = A @ A.transpose(0, 1, 3, 2) + 3.0 * np.eye(n)
    c = rng.randn(T, B, n)
    Fx = np.eye(nx) + 0.08 * rng.randn(T - 1, B, nx, nx)
    Fu = 0.4 * rng.randn(T - 1, B, nx, nu)
    F = np.concatenate([Fx, Fu], -1)
    f = 0.2 * rng.randn(T - 1, B, nx)
    x0 = rng.randn(B, nx)
    return [a.astype(dtype) for a in (C, c, F, f, x0)]


def _affine(a, b):
    """(later b) o (earlier a) for affine maps x -> G x + g."""
    (Ga, ga), (Gb, gb) = a, b
    return Gb @ Ga, (Gb @ ga[..., None])[..., 0] + gb


@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_matches_sequential_fold(reverse):
    """Lengths 1-17, a non-commutative operation (affine maps of 3x3
    matrices near the identity, so that products stay of order one):
    element t of the scan is the fold of elements 0..t (reverse: of
    t..T-1, the later one on the left), which fixes the order the combine
    is handed its operands, as plqr_backward relies on it."""
    rng = np.random.RandomState(0)
    for n in range(1, 18):
        G = torch.from_numpy(np.eye(3) + 0.2 * rng.randn(n, 2, 3, 3))
        g = torch.from_numpy(rng.randn(n, 2, 3))
        got = tpr._associative_scan(_affine, (G, g), reverse=reverse)
        order = range(n - 1, -1, -1) if reverse else range(n)
        acc, want = None, [None] * n
        for t in order:
            acc = (G[t], g[t]) if acc is None else _affine(acc, (G[t], g[t]))
            want[t] = acc
        for i in range(2):
            torch.testing.assert_close(got[i], torch.stack([w[i] for w in want]), rtol=0,
                                       atol=1e-12, msg=f"length {n}, leaf {i}")
        if n not in (7, 17):
            continue
        # JAX's scan builds the same tree of combines
        jgot = jax.lax.associative_scan(
            lambda a, b: _affine(a, b), (jnp.asarray(G.numpy()), jnp.asarray(g.numpy())),
            reverse=reverse)
        for i in range(2):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(jgot[i]), rtol=0, atol=1e-12)


def _compare(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("shape", [(6, 3, 4, 1), (32, 2, 3, 2)])
def test_plqr_matches_jax_f64(shape):
    """JAX's default-lane shapes: (4, 1) takes the combine's linalg.solve
    branch (n > 3), (3, 2) the closed-form inverse."""
    T, B, nx, nu = shape
    C, c, F, f, x0 = _problem(T, B, nx, nu)
    jargs = [jnp.asarray(a) for a in (C, c, F, f)]
    targs = [from_numpy(a) for a in (C, c, F, f)]
    jK, jk = j_backward(nx, nu, *jargs)
    K, k = tpr.plqr_backward(nx, nu, *targs)
    _compare(K, jK, 1e-10)
    _compare(k, jk, 1e-10)
    # and the port's own sequential recursion
    ref = lqr_backward(nx, nu, *targs, torch.zeros(T, B, nu, dtype=torch.float64),
                       backend="torch")
    torch.testing.assert_close(K, ref.K, rtol=0, atol=1e-10)
    torch.testing.assert_close(k, ref.k, rtol=0, atol=1e-10)

    jres = j_solve(nx, nu, *jargs, jnp.asarray(x0))
    res = tpr.plqr_solve(nx, nu, *targs, from_numpy(x0))
    for got, want in zip(res, jres):
        _compare(got, want, 1e-10)
    x, u = tpr.plqr_rollout(nx, from_numpy(x0), K, k, targs[2], targs[3])
    jx, ju = j_rollout(nx, jnp.asarray(x0), jK, jk, jargs[2], jargs[3])
    _compare(x, jx, 1e-10)
    _compare(u, ju, 1e-10)
    # the parallel rollout is the open-loop rollout of its own controls
    x_ref = get_traj(T, res.u, from_numpy(x0), P.LinDx(targs[2], targs[3]))
    torch.testing.assert_close(res.x, x_ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("shape", [(64, 3, 3, 2), (128, 2, 4, 1)])
def test_plqr_masked_matches_jax_f64(shape):
    """u_zero_I free-subspace masking, JAX's masked shapes; frozen rows
    carry exactly zero gain, and the solve keeps them at zero."""
    T, B, nx, nu = shape
    C, c, F, f, x0 = _problem(T, B, nx, nu, seed=3)
    uz = np.random.RandomState(7).rand(T, B, nu) < 0.3
    jargs = [jnp.asarray(a) for a in (C, c, F, f)]
    targs = [from_numpy(a) for a in (C, c, F, f)]
    tuz = torch.from_numpy(uz)
    jK, jk = j_backward(nx, nu, *jargs, jnp.asarray(uz))
    K, k = tpr.plqr_backward(nx, nu, *targs, tuz)
    _compare(K, jK, 1e-10)
    _compare(k, jk, 1e-10)
    assert not K[tuz].any() and not k[tuz].any()
    ref = lqr_backward(nx, nu, *targs, torch.zeros(T, B, nu, dtype=torch.float64),
                       u_zero_I=tuz, backend="torch")
    torch.testing.assert_close(K, ref.K, rtol=0, atol=1e-10)
    torch.testing.assert_close(k, ref.k, rtol=0, atol=1e-10)
    res = tpr.plqr_solve(nx, nu, *targs, from_numpy(x0), tuz)
    jres = j_solve(nx, nu, *jargs, jnp.asarray(x0), jnp.asarray(uz))
    for got, want in zip(res, jres):
        _compare(got, want, 1e-10)
    assert not res.u[tuz].any()


def test_plqr_f32_long_horizon():
    """f32 at T=128 within 5e-4 of the sequential recursion and of JAX's
    parallel scan (tests/test_parallel_riccati.py:54-64)."""
    T, B, nx, nu = 128, 2, 3, 1
    C, c, F, f, _ = _problem(T, B, nx, nu, dtype=np.float32)
    targs = [from_numpy(a) for a in (C, c, F, f)]
    K, k = tpr.plqr_backward(nx, nu, *targs)
    assert K.dtype == torch.float32
    ref = lqr_backward(nx, nu, *targs, torch.zeros(T, B, nu), backend="torch")
    torch.testing.assert_close(K, ref.K, rtol=0, atol=5e-4)
    torch.testing.assert_close(k, ref.k, rtol=0, atol=5e-4)
    jK, jk = j_backward(nx, nu, *(jnp.asarray(a) for a in (C, c, F, f)))
    _compare(K, jK, 5e-4)
    _compare(k, jk, 5e-4)


def test_lqr_backward_dispatch():
    """parallel sends an unboxed solve to the scan (no QP iterations, no
    kernel), and a boxed one to the recursion, whatever the flag."""
    T, B, nx, nu = 8, 2, 4, 1
    C, c, F, f, _ = (from_numpy(a) for a in _problem(T, B, nx, nu))
    u = torch.zeros(T, B, nu, dtype=torch.float64)
    before = riccati_fused.LAUNCHES
    par = lqr_backward(nx, nu, C, c, F, f, u, parallel=True)
    K, k = tpr.plqr_backward(nx, nu, C, c, F, f)
    assert par.n_total_qp_iter == 0
    assert torch.equal(par.K, K) and torch.equal(par.k, k)
    boxed = dict(u_lower=-0.5, u_upper=0.5)
    a = lqr_backward(nx, nu, C, c, F, f, u, parallel=True, **boxed)
    b = lqr_backward(nx, nu, C, c, F, f, u, backend="torch", **boxed)
    assert torch.equal(a.K, b.K) and torch.equal(a.k, b.k) and a.n_total_qp_iter == T
    assert riccati_fused.LAUNCHES == before
    with pytest.raises(ValueError, match="backend"):
        lqr_backward(nx, nu, C, c, F, f, u, parallel=True, backend="pallas")


def test_kkt_vjp_parallel_matches_jax_f64():
    """make_kkt_vjp(parallel=True): the auxiliary solve and both adjoint
    recursions as associative scans, against JAX's parallel VJP and the
    port's sequential one (T=64 LinDx, active-set masked; 1e-9)."""
    T, B, nx, nu = 64, 2, 3, 2
    C, c, F, _, _ = _problem(T, B, nx, nu, seed=5)
    rng = np.random.RandomState(11)
    x, u = rng.randn(T, B, nx), rng.randn(T, B, nu)
    gx, gu = rng.randn(T, B, nx), rng.randn(T, B, nu)
    uz = rng.rand(T, B, nu) < 0.25
    arrs = (C, c, F, x, u)
    want = jax.jit(lambda *a: j_kkt_vjp(nx, nu, *a, backend="xla", parallel=True))(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(gx), jnp.asarray(gu), jnp.asarray(uz))
    targs = [from_numpy(a) for a in arrs]
    before = kkt_fused.LAUNCHES
    fn = tkkt.make_kkt_vjp(nx, nu, *targs, u_zero_I=torch.from_numpy(uz), parallel=True)
    got = fn(from_numpy(gx), from_numpy(gu))
    seq = tkkt.make_kkt_vjp(nx, nu, *targs, u_zero_I=torch.from_numpy(uz),
                            backend="torch")(from_numpy(gx), from_numpy(gu))
    assert kkt_fused.LAUNCHES == before
    for name, g, w, s in zip(got._fields, got, want, seq):
        _compare(g, w, 1e-9)
        torch.testing.assert_close(g, s, rtol=0, atol=1e-9, msg=name)
    # "Ff" is the full call's dF and df
    ff = fn(from_numpy(gx), from_numpy(gu), wants="Ff")
    assert torch.equal(ff.dF, got.dF) and torch.equal(ff.df, got.df)


def _pendulum(B=3, T=10, seed=0):
    rng = np.random.RandomState(seed)
    th = rng.uniform(-1.5, 1.5, B)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)
    q, p = (np.asarray(a, np.float64) for a in jpend.get_true_obj())
    return dict(x0=x0, C=np.diag(q), c=p, p=np.asarray(jpend.default_params(), np.float64),
                wx=rng.randn(B, T, 3), wu=rng.randn(B, T, 1))


def _cfg(pkg, T, **kw):
    base = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=8, eps=0.0, exit_unconverged=False,
                detach_unconverged=False, riccati_parallel=True)
    base.update(kw)
    return J.ILQRConfig(backend="xla", **base) if pkg == "jax" else P.ILQRConfig(**base)


def test_riccati_parallel_solve_matches_jax_f64():
    """The unboxed solve with riccati_parallel (the plain loop's backward is
    the scan) against JAX's, and against the port's sequential solve."""
    pr, T = _pendulum(), 10
    cfg = _cfg("jax", T, backprop=False)
    jr = J.solve(cfg, jnp.asarray(pr["x0"]), J.QuadCost(jnp.asarray(pr["C"]),
                                                         jnp.asarray(pr["c"])),
                 jpend.make(), params=jnp.asarray(pr["p"]))
    tcfg = _cfg("port", T, backprop=False)
    cost = P.QuadCost(from_numpy(pr["C"]), from_numpy(pr["c"]))
    tr = P.solve(tcfg, from_numpy(pr["x0"]), cost, tpend.make(), params=from_numpy(pr["p"]))
    for name in ("x", "u", "costs"):
        np.testing.assert_allclose(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
                                   rtol=1e-8, atol=1e-12, err_msg=name)
    seq = P.solve(dataclasses.replace(tcfg, riccati_parallel=False), from_numpy(pr["x0"]), cost,
                  tpend.make(), params=from_numpy(pr["p"]))
    torch.testing.assert_close(tr.u, seq.u, rtol=0, atol=1e-10)
    torch.testing.assert_close(tr.costs, seq.costs, rtol=0, atol=1e-10)


def _port_grads(cfg, pr, bounds):
    keys = ("p", "C", "c", "x0")
    ins = [from_numpy(pr[k]).requires_grad_(True) for k in keys]
    p, C, c, xi = ins
    res = P.solve(cfg, xi, P.QuadCost(C, c), tpend.make(), params=p, **bounds)
    tl = (res.u * from_numpy(pr["wu"])).sum() + (res.x * from_numpy(pr["wx"])).sum()
    return torch.autograd.grad(tl, ins)


def _assert_rel(got, want, rtol):
    for name, g, w in zip(("p", "C", "c", "x0"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        if name == "C":  # the IFT dC is the symmetrized cotangent
            g, w = 0.5 * (g + g.swapaxes(-1, -2)), 0.5 * (w + w.swapaxes(-1, -2))
        err = np.abs(g - w).max() / max(1e-30, np.abs(w).max())
        assert err <= rtol, f"{name}: rel err {err:.2e}"


@pytest.mark.parametrize("boxed", [True, False])
def test_riccati_parallel_ift_gradient_matches_jax_f64(boxed):
    """Gradients of sum(u wu) + sum(x wx) with respect to (params, C, c,
    x_init) through the IFT backward, whose auxiliary solve and adjoints
    are scans (boxed: the forward keeps the recursion; unboxed: both are
    scans), against JAX's with the same flag: rtol 1e-8 of the largest
    entry."""
    pr, T = _pendulum(B=2, T=8, seed=1), 8
    bounds = dict(u_lower=-2.0, u_upper=2.0) if boxed else {}
    kw = dict(lqr_iter=20, eps=1e-8)
    jdyn = jpend.make()
    jcfg = _cfg("jax", T, backward_mode=J.BackwardMode.IFT, **kw)

    def loss(p, C, c, xi):
        r = J.solve(jcfg, xi, J.QuadCost(C, c), jdyn, params=p, **bounds)
        return jnp.sum(r.u * pr["wu"]) + jnp.sum(r.x * pr["wx"])

    keys = ("p", "C", "c", "x0")
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*(jnp.asarray(pr[k]) for k in keys))
    got = _port_grads(_cfg("port", T, backward_mode=P.BackwardMode.IFT, **kw), pr, bounds)
    _assert_rel([g.numpy() for g in got], want, 1e-8)


def test_unroll_differentiates_through_plqr():
    """UNROLL with riccati_parallel: autograd through plqr_backward itself
    (the unboxed pendulum), against UNROLL through the sequential
    recursion, rtol 1e-8 of the largest entry."""
    pr, T = _pendulum(B=2, T=8, seed=1), 8
    kw = dict(backward_mode=P.BackwardMode.UNROLL, unroll=True, lqr_iter=20, eps=1e-8)
    got = _port_grads(_cfg("port", T, **kw), pr, {})
    want = _port_grads(_cfg("port", T, riccati_parallel=False, **kw), pr, {})
    assert all(g.abs().max() > 0 for g in got)
    _assert_rel([g.numpy() for g in got], [w.numpy() for w in want], 1e-8)
