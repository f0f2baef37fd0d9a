"""LinDx (time-varying affine LQR) problems and n_ctrl 1..8 on the
whole-solve kernel, on the CPU: the plain version (ops/cuda/ilqr_fused.
ilqr_fused on CPU tensors, i.e. ilqr_fused_reference) against the JAX
package's Pallas kernel in interpret mode (solve(..., backend="pallas") on
the CPU, as tests/test_fused_edge_cases.py runs it), on the same
numpy-seeded problems (tests/test_fused_edge_cases.py's _random_lindx: an
SPD cost per step and example, F near [I | 0]):

 * boxed and unboxed, with and without f (test_fused_lindx's cases);
 * a u_zero_I mask with the box (zeroed before the trial clamp), with
   delta_u and per-time and per-example bounds at once, and without the box
   (the free-subspace gains); the masked u is exactly 0;
 * the example-invariant cost ([n,n]+[n]);
 * the LinDx slew rate (augment_slew_rate's augmented LinDx, (5, 2));
 * n_ctrl 4..8, boxed and unboxed (the Gauss-Jordan inverse of the
   box-QP and the gains, test_fused_gauss_jordan_nu), and one control past
   the register path's 6 states with a mask (k over the unmasked Quu).

Tolerances are tests/test_torch_ilqr_fused.py's: u 2e-3, x 5e-3, costs
rtol/atol 1e-5, n_iter equal, with eps=0 and a few iterations (ROADMAP C).
Also the f32 goldens lqr_lindx_{box,unc} through the port's solve and the
covered path's plain version at the goldens' tolerance
(tests/test_lqr_golden.py:47-55), and the gate: the port's ``covered``
against JAX's ``fused_supported`` for LinDx over n_state 1..18, n_ctrl
1..8 and both cost forms."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.ops.pallas.ilqr_fused import fused_supported
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.core.solver import augment_slew_rate, canonicalize_cost
from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused
from test_fused_edge_cases import _random_lindx


def _tm(a):
    """Batch-major [B, T, ...] -> time-major torch (f32)."""
    return from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(a, np.float32), 0, 1)))


def _kw(nx, nu, T, lqr_iter):
    return dict(n_state=nx, n_ctrl=nu, T=T, lqr_iter=lqr_iter, eps=0.0,
                exit_unconverged=False, detach_unconverged=False, backprop=False)


def _compare(jres, out):
    x, u, costs, _, n_iter = out
    np.testing.assert_allclose(u.transpose(0, 1).numpy(), np.asarray(jres.u), atol=2e-3)
    np.testing.assert_allclose(x.transpose(0, 1).numpy(), np.asarray(jres.x), atol=5e-3)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jres.costs), atol=1e-5, rtol=1e-5)
    assert int(n_iter) == int(jres.n_iter)


def _both(seed, T, B, nx, nu, lqr_iter, lo=None, hi=None, uz=None, du=None, small=False,
          **gen):
    """JAX's kernel (interpret mode) and the port's plain version on one
    random LinDx problem. lo/hi: numbers or [B, T, nu]; uz a [B, T, nu]
    mask; small: the cost as one example-invariant [n,n]+[n] pair (the
    first step and example's). Returns (JAX's result, the port's outputs)."""
    cost, dyn, x0, _ = _random_lindx(seed, T, B, nx, nu, **gen)
    if small:
        C, c = np.asarray(cost.C)[0, 0], np.asarray(cost.c)[0, 0]
        jcost, tcost = J.QuadCost(jnp.asarray(C), jnp.asarray(c)), (from_numpy(C), from_numpy(c))
    else:
        jcost, tcost = cost, (_tm(cost.C), _tm(cost.c))
    kw = _kw(nx, nu, T, lqr_iter)

    def jb(v):
        return None if v is None else jnp.asarray(v, jnp.float32)

    def tb(v):
        return None if v is None else (float(v) if np.ndim(v) == 0 else _tm(v))

    jres = J.solve(J.ILQRConfig(backend="pallas", **kw), x0, jcost, dyn, u_lower=jb(lo),
                   u_upper=jb(hi), u_zero_I=None if uz is None else jnp.asarray(uz),
                   delta_u=du)
    tdyn = P.LinDx(_tm(dyn.F), None if dyn.f is None else _tm(dyn.f))
    tcfg = P.ILQRConfig(**kw)
    tuz = None if uz is None else _tm(uz).bool()
    assert fused.covered(tcfg, tdyn, None, torch.float32, tcost if small else None, tuz, du,
                         tb(lo), tb(hi))
    out = fused.ilqr_fused(tcfg, tdyn, None, from_numpy(np.asarray(x0)), tcost, None, tb(lo),
                           tb(hi), u_zero_I=tuz, delta_u=du)
    return jres, out


@pytest.mark.parametrize("boxed", [False, True], ids=["unboxed", "boxed"])
@pytest.mark.parametrize("with_f", [True, False], ids=["f", "no_f"])
def test_lindx(boxed, with_f):
    """The slice's shape (3 states, 2 controls: the nu=2 box-QP with its
    Cramer inverse), F and f as data, with the +-0.5 box and without."""
    b = dict(lo=-0.5, hi=0.5) if boxed else {}
    jres, out = _both(3, 8, 6, 3, 2, 8, f_scale=0.1 if with_f else None, **b)
    _compare(jres, out)
    if boxed:
        u = np.asarray(jres.u)
        assert np.abs(u).max() <= 0.5 + 1e-6 and (np.abs(np.abs(u) - 0.5) < 1e-6).mean() > 0.02


@pytest.mark.parametrize("boxed", [True, False], ids=["boxed", "unboxed"])
def test_lindx_variants(boxed):
    """A u_zero_I mask over about 30% of the controls; boxed, with delta_u
    0.2 and per-time and per-example bounds (0.2-0.6) at once (the mask
    zeroes the trial step, the trust region intersects the QP bounds);
    unboxed, through the free-subspace gains. The masked u is exactly 0."""
    T, B, nu = 6, 4, 2
    rng = np.random.RandomState(21)
    uz = rng.rand(B, T, nu) < 0.3
    kw = {}
    if boxed:
        hi = rng.uniform(0.2, 0.6, (B, T, nu)).astype(np.float32)
        kw = dict(lo=-hi, hi=hi, du=0.2)
    jres, out = _both(9, T, B, 3, nu, 6, uz=uz, f_scale=0.1, **kw)
    _compare(jres, out)
    assert (np.asarray(jres.u)[uz] == 0.0).all()
    assert (out[1].transpose(0, 1).numpy()[uz] == 0.0).all()
    if boxed:
        assert np.abs(np.asarray(jres.u)).max() <= 6 * 0.2 + 1e-5


def test_lindx_example_invariant_cost():
    """One [n,n]+[n] cost for every step and example (the cost_small form,
    whose gate admits more states), boxed."""
    _compare(*_both(5, 8, 6, 3, 2, 8, lo=-0.5, hi=0.5, small=True, f_scale=0.1))


def test_lindx_slew_rate():
    """The slew rate (penalty 1.0) on a LinDx problem: augment_slew_rate's
    augmented LinDx ((u_{t-1}, x): 5 states, 2 controls) with its
    per-example cost through the plain version, against JAX's solve with
    slew_rate_penalty on its kernel."""
    T, B, nx, nu = 8, 4, 3, 2
    cost, dyn, x0, _ = _random_lindx(7, T, B, nx, nu, f_scale=0.1)
    kw = _kw(nx, nu, T, 6)
    jres = J.solve(J.ILQRConfig(backend="pallas", slew_rate_penalty=1.0, **kw), x0, cost, dyn,
                   u_lower=-0.5, u_upper=0.5)
    tcost = canonicalize_cost(P.QuadCost(*(from_numpy(np.asarray(a)) for a in cost)), T, B,
                              nx + nu)
    tdyn = P.LinDx(_tm(dyn.F), _tm(dyn.f))
    cfg, acost, adyn, _, ax0 = augment_slew_rate(
        P.ILQRConfig(slew_rate_penalty=1.0, **kw), tcost, tdyn, None,
        from_numpy(np.asarray(x0)), None)
    assert isinstance(adyn, P.LinDx) and (cfg.n_state, cfg.n_ctrl) == (5, 2)
    assert fused.covered(cfg, adyn, None, torch.float32, None, None, None, -0.5, 0.5)
    x, u, costs, du, n_iter = fused.ilqr_fused(cfg, adyn, None, ax0, (acost.C, acost.c), None,
                                               -0.5, 0.5)
    _compare(jres, (x[:, :, nu:], u, costs, du, n_iter))


@pytest.mark.parametrize("nu", [4, 5, 6, 7, 8])
@pytest.mark.parametrize("boxed", [False, True], ids=["unboxed", "boxed"])
def test_lindx_gauss_jordan_nu(nu, boxed):
    """n_ctrl 4..8 (odd and even): the box-QP's and the gains' inverses by
    unpivoted Gauss-Jordan (inv_lanes, the kernel's inv_small<M>), as
    test_fused_gauss_jordan_nu drives JAX's."""
    b = dict(lo=-0.4, hi=0.4) if boxed else {}
    _compare(*_both(11 + nu, 5, 3, 4, nu, 4, ridge=1.0, f_scale=None, F_scale=0.2, **b))


def test_lindx_one_control_past_the_register_path():
    """One control and 9 states (the kernel's strided path with the
    closed-form 1-D QP) with a mask and no box: k divides by the unmasked
    Quu (the reference's quirk, as the register path does)."""
    T, B = 6, 4
    uz = np.random.RandomState(3).rand(B, T, 1) < 0.3
    jres, out = _both(13, T, B, 9, 1, 5, uz=uz, f_scale=0.1)
    _compare(jres, out)
    assert (out[1].transpose(0, 1).numpy()[uz] == 0.0).all()


def test_inv_lanes_matches_linalg_inv():
    """inv_lanes for m = 1..8 on SPD-plus-ridge matrices: within 1e-4
    (relative to the largest entry) of torch.linalg.inv at f32, and the
    closed forms of utils/batch.inv_small for m <= 3."""
    rng = np.random.RandomState(0)
    for m in range(1, 9):
        A = rng.randn(16, m, m)
        H = torch.from_numpy((A @ A.transpose(0, 2, 1) + np.eye(m)).astype(np.float32))
        got, want = fused.inv_lanes(H), torch.linalg.inv(H.double()).float()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("tag,bound", [("unc", None), ("box", 0.5)])
def test_lindx_golden_on_the_covered_path(golden, tag, bound):
    """The reference's f32 LQR goldens (3 states, 2 controls, T=10, B=8)
    through the port's solve (the plain loop on the CPU) and the plain
    version of the kernel the configuration is covered by, at the goldens'
    tolerance (tests/test_lqr_golden.py:47-55)."""
    g = golden(f"lqr_lindx_{tag}")
    T, B, nx = g["F"].shape[0] + 1, g["F"].shape[1], g["F"].shape[2]
    nu = g["F"].shape[3] - nx
    f32 = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in g.items()}
    cfg = P.ILQRConfig(n_state=nx, n_ctrl=nu, T=T, lqr_iter=10, eps=1e-7,
                       detach_unconverged=False, exit_unconverged=False, backprop=False)
    lim = {} if bound is None else dict(u_lower=-bound, u_upper=bound)
    res = P.solve(cfg, f32["x_init"], P.QuadCost(f32["C"].transpose(0, 1),
                                                 f32["c"].transpose(0, 1)),
                  P.LinDx(f32["F"].transpose(0, 1), f32["f"].transpose(0, 1)), **lim)
    dyn = P.LinDx(f32["F"], f32["f"])  # time-major, as ilqr_loop passes it
    assert fused.covered(cfg, dyn, None, torch.float32, None, None, None, -bound if bound else
                         None, bound)
    x, u, costs, _, _ = fused.ilqr_fused(cfg, dyn, None, f32["x_init"], (f32["C"], f32["c"]),
                                         None, None if bound is None else -bound, bound)
    for xs, us, objs in ((res.x.transpose(0, 1), res.u.transpose(0, 1), res.costs),
                         (x, u, costs)):
        np.testing.assert_allclose(us.numpy(), g["u"], atol=1e-4)
        np.testing.assert_allclose(xs.numpy(), g["x"], atol=1e-4)
        np.testing.assert_allclose(objs.numpy(), g["objs"], rtol=1e-4)


def test_covered_agrees_with_jax_gate_for_lindx():
    """The port's ``covered`` equals JAX's ``fused_supported`` for a LinDx
    problem over n_state 1..18 x n_ctrl 1..8 x both cost forms (the table
    LINDX_MAX_NX holds), and both refuse f64 and qp_solver="pnqp"."""
    T, B = 10, 4
    for nu in range(1, 9):
        for nx in range(1, 19):
            n = nx + nu
            jlin = J.LinDx(jnp.zeros((B, T - 1, nx, n)), None)
            tlin = P.LinDx(torch.zeros(T - 1, B, nx, n), torch.zeros(T - 1, B, nx))
            for small in (False, True):
                js = (jnp.eye(n), jnp.zeros(n)) if small else None
                ts = (torch.eye(n), torch.zeros(n)) if small else None
                for extra in ({},) if nx != 3 else ({}, {"dtype": "f64"},
                                                     {"qp_solver": "pnqp"}):
                    kw = dict(n_state=nx, n_ctrl=nu, T=T, qp_solver=extra.get("qp_solver",
                                                                              "auto"))
                    f64 = "dtype" in extra
                    j_ok = fused_supported(J.ILQRConfig(**kw), J.QuadCost(jnp.eye(n),
                                                                          jnp.zeros(n)),
                                           jlin, None, None, None,
                                           jnp.float64 if f64 else jnp.float32, cost_small=js)
                    t_ok = fused.covered(P.ILQRConfig(**kw), tlin, None,
                                         torch.float64 if f64 else torch.float32, ts, None,
                                         None, None, None)
                    assert bool(j_ok) == t_ok, (nx, nu, small, extra)
                    if extra:
                        assert not t_ok
    assert fused.LINDX_MAX_NX[False][1] == 15 and fused.LINDX_MAX_NX[True][7] == 13
