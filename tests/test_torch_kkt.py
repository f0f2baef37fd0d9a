"""The port's module-KKT VJP: the plain version of the CUDA kernel's whole
call (ops/cuda/kkt_fused.kkt_fused_reference, the assembly folded in)
against the JAX Pallas kernel in interpret mode, resident and stream, in
f32, at the shapes JAX's gate admits (covered equals that gate); the plain recursions
(diff/kkt.make_kkt_vjp(backend="torch")) against JAX's XLA path at f64; the
"Ff" mode, linearity, dispatch, and the reference's KKT goldens.

Tolerances: atol 5e-5 in f32 at n <= 7 and 2e-4 at n = 16 -- elementwise
f32 chains summed in another order than the JAX kernel's, over short
recursions (the JAX kernel's own tests use the same bounds); 1e-10 at f64
(the same recursions, summation order aside); the goldens keep the JAX
tests' bounds (tests/test_lqr_golden.py, tests/test_grad_modes.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.diff.kkt import make_kkt_vjp as j_make_kkt_vjp
from dilqr_tpu.ops.pallas.kkt_fused import kkt_fused_supported, make_kkt_vjp_pallas
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.diff.kkt import kkt_vjp, make_kkt_vjp
from dilqr_tpu_torch.models import pendulum as tpend
from dilqr_tpu_torch.ops.cuda import kkt_fused

FIELDS = ("dx_init", "dC", "dc", "dF", "df")


def _problem(seed, T, B, nx, nu, dtype=np.float32, masked=False):
    n = nx + nu
    rng = np.random.RandomState(seed)
    A = rng.randn(T, B, n, n)
    C = A @ A.transpose(0, 1, 3, 2) + 2.0 * np.eye(n)
    arrs = [C, rng.randn(T, B, n), 0.3 * rng.randn(T - 1, B, nx, n), rng.randn(T, B, nx),
            0.5 * rng.randn(T, B, nu), rng.randn(T, B, nx), rng.randn(T, B, nu)]
    arrs = [a.astype(dtype) for a in arrs]
    uz = (rng.rand(T, B, nu) < 0.3) if masked else None
    return arrs, uz


def _port(arrs, uz):
    return [from_numpy(a) for a in arrs], (None if uz is None else from_numpy(uz))


def _cpu_call(arrs, uz, nx, nu):
    """The CUDA wrapper on CPU tensors: kkt_fused_reference plus assembly."""
    (C, c, F, x, u, gx, gu), tuz = _port(arrs, uz)
    return make_kkt_vjp_cuda_cpu(nx, nu, C, c, F, x, u, tuz)(gx, gu, True)


def make_kkt_vjp_cuda_cpu(*args):
    before = kkt_fused.LAUNCHES
    call = kkt_fused.make_kkt_vjp_cuda(*args)

    def wrapped(gx, gu, full):
        out = call(gx, gu, full)
        assert kkt_fused.LAUNCHES == before, "a CPU tensor must not reach the kernel"
        return out

    return wrapped


def _compare(got, want, atol):
    for name, g, w in zip(FIELDS, got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=0,
                                   err_msg=f"field {name}")


@pytest.mark.parametrize("nu,masked,mode", [
    (1, False, "resident"), (1, True, "resident"), (2, False, "resident"),
    (2, True, "resident"), (3, False, "resident"), (3, True, "resident"),
    (1, True, "stream"), (3, True, "stream")])
def test_reference_matches_jax_kernel(nu, masked, mode):
    T, B, nx = (6, 5, 4) if mode == "resident" else (7, 5, 4)
    arrs, uz = _problem(0, T, B, nx, nu, masked=masked)
    C, c, F, x, u, gx, gu = (jnp.asarray(a) for a in arrs)
    want = make_kkt_vjp_pallas(nx, nu, C, c, F, x, u,
                               u_zero_I=None if uz is None else jnp.asarray(uz),
                               interpret=True, mode=mode)(gx, gu, True)
    _compare(_cpu_call(arrs, uz, nx, nu), want, atol=5e-5)


@pytest.mark.parametrize("nx,nu", [(6, 1), (16, 1), (14, 3)])
def test_reference_matches_jax_kernel_widened_shapes(nx, nu):
    """The shapes the kernel gained with JAX's whole gate -- the slew-rate
    cartpole's (6,1) and the widest n_state for one and three controls --
    masked, against JAX's Pallas kernel in interpret mode in the variant
    JAX picks itself; atol 5e-5, 2e-4 at n_state >= 13."""
    T, B = 4, 3
    arrs, uz = _problem(20 + nx, T, B, nx, nu, masked=True)
    C, c, F, x, u, gx, gu = (jnp.asarray(a) for a in arrs)
    want = make_kkt_vjp_pallas(nx, nu, C, c, F, x, u, u_zero_I=jnp.asarray(uz),
                               interpret=True)(gx, gu, True)
    _compare(_cpu_call(arrs, uz, nx, nu), want, atol=2e-4 if nx >= 13 else 5e-5)


def test_covered_equals_jax_gate():
    """covered admits exactly what JAX's kkt_fused_supported admits over
    n_state 1..20, n_ctrl 1..4, T in {1, 2, 20, 200} and both float types."""
    for T in (1, 2, 20, 200):
        for nx in range(1, 21):
            for nu in range(1, 5):
                for jt, tt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
                    assert kkt_fused.covered(T, nx, nu, tt) == kkt_fused_supported(T, nx, nu, jt), \
                        (T, nx, nu, tt)


def test_reference_matches_jax_stream_rocket_shape():
    """nx=13, nu=3: the shape JAX routes to the stream kernel."""
    T, B, nx, nu = 6, 3, 13, 3
    arrs, uz = _problem(5, T, B, nx, nu, masked=True)
    C, c, F, x, u, gx, gu = (jnp.asarray(a) for a in arrs)
    want = make_kkt_vjp_pallas(nx, nu, C, c, F, x, u, u_zero_I=jnp.asarray(uz),
                               interpret=True, mode="stream")(gx, gu, True)
    _compare(_cpu_call(arrs, uz, nx, nu), want, atol=2e-4)


@pytest.mark.parametrize("nu,masked", [(1, False), (1, True), (2, True), (3, False)])
def test_plain_matches_jax_xla_f64(nu, masked):
    T, B, nx = 6, 4, 4
    arrs, uz = _problem(1, T, B, nx, nu, dtype=np.float64, masked=masked)
    C, c, F, x, u, gx, gu = (jnp.asarray(a) for a in arrs)
    want = j_make_kkt_vjp(nx, nu, C, c, F, x, u,
                          u_zero_I=None if uz is None else jnp.asarray(uz),
                          backend="xla")(gx, gu)
    (tC, tc, tF, tx, tu, tgx, tgu), tuz = _port(arrs, uz)
    got = make_kkt_vjp(nx, nu, tC, tc, tF, tx, tu, u_zero_I=tuz, backend="torch")(tgx, tgu)
    _compare(got, want, atol=1e-10)
    # the kernel's plain version computes the same map at f64
    _compare(_cpu_call(arrs, uz, nx, nu), want, atol=1e-10)


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_ff_mode_equals_full_and_is_linear(backend):
    T, B, nx, nu = 5, 3, 3, 1
    arrs, uz = _problem(2, T, B, nx, nu, masked=True)
    (C, c, F, x, u, gx, gu), tuz = _port(arrs, uz)
    fn = make_kkt_vjp(nx, nu, C, c, F, x, u, u_zero_I=tuz, backend=backend)
    ff, full = fn(gx, gu, wants="Ff"), fn(gx, gu)
    assert ff.dC is None and ff.dc is None and ff.dx_init is None
    torch.testing.assert_close(ff.dF, full.dF, rtol=0, atol=0)
    torch.testing.assert_close(ff.df, full.df, rtol=0, atol=0)
    # the IFT backward needs the operator linear in the cotangent
    ff2 = fn(2.0 * gx, 2.0 * gu, wants="Ff")
    torch.testing.assert_close(ff2.dF, 2.0 * ff.dF, rtol=0, atol=1e-5)
    torch.testing.assert_close(ff2.df, 2.0 * ff.df, rtol=0, atol=1e-5)
    # with_f=False zeros df, as JAX does
    nf = make_kkt_vjp(nx, nu, C, c, F, x, u, u_zero_I=tuz, with_f=False,
                      backend=backend)(gx, gu, wants="Ff")
    assert not nf.df.any()


def test_dispatch_and_coverage():
    arrs, uz = _problem(3, 4, 2, 5, 1)
    (C, c, F, x, u, gx, gu), _ = _port(arrs, uz)
    with pytest.raises(ValueError, match="CUDA tensors"):
        make_kkt_vjp(5, 1, C, c, F, x, u, backend="cuda")
    # parallel (the associative scans) takes precedence over the kernel, as
    # in JAX, and computes the sequential recursions' map: f32, 5e-5
    par = kkt_vjp(5, 1, C, c, F, x, u, gx, gu, parallel=True)
    seq = kkt_vjp(5, 1, C, c, F, x, u, gx, gu, backend="torch")
    for name in FIELDS:
        torch.testing.assert_close(getattr(par, name), getattr(seq, name), rtol=0, atol=5e-5)
    with pytest.raises(ValueError, match="backend"):
        make_kkt_vjp(5, 1, C, c, F, x, u, backend="pallas")
    assert kkt_fused.covered(20, 5, 1, torch.float32)
    assert kkt_fused.covered(200, 13, 3, torch.float32)
    assert not kkt_fused.covered(20, 5, 1, torch.float64)
    assert not kkt_fused.covered(1, 5, 1, torch.float32)
    # the shapes JAX's gate refuses (test_covered_equals_jax_gate holds the
    # whole grid): past its n_state limit for each n_ctrl, and n_ctrl 4
    assert kkt_fused.covered(20, 6, 1, torch.float32)
    assert not kkt_fused.covered(20, 17, 1, torch.float32)
    assert not kkt_fused.covered(20, 15, 3, torch.float32)
    assert not kkt_fused.covered(20, 4, 4, torch.float32)
    assert not kkt_fused.covered(20, 5, 1, torch.float32, parallel=True)
    # "auto" on CPU tensors takes the plain recursions, the same map
    before = kkt_fused.LAUNCHES
    a = kkt_vjp(5, 1, C, c, F, x, u, gx, gu, backend="auto")
    b = kkt_vjp(5, 1, C, c, F, x, u, gx, gu, backend="torch")
    assert kkt_fused.LAUNCHES == before
    for name in FIELDS:
        torch.testing.assert_close(getattr(a, name), getattr(b, name), rtol=0, atol=0)


def _bm(a):
    return torch.from_numpy(np.swapaxes(np.asarray(a, np.float32), 0, 1).copy())


@pytest.mark.parametrize("tag,bound", [("unc", None), ("box", 0.5)])
def test_lindx_kkt_grad_golden(golden, tag, bound):
    """d loss / d (x_init, C, c, F, f) of a LinDx box-LQR solve against the
    reference (tests/test_lqr_golden.py:55-96), 2e-3."""
    g, p = golden(f"lqr_grad_{tag}"), golden(f"lqr_grad_problem_{tag}")
    T, B, nx = g["x"].shape
    nu = g["u"].shape[2]
    cfg = P.ILQRConfig(n_state=nx, n_ctrl=nu, T=T, lqr_iter=10, eps=1e-7,
                       detach_unconverged=False, exit_unconverged=False,
                       backward_mode=P.BackwardMode.KKT)
    inputs = [from_numpy(p["x_init"], dtype=torch.float32)] + [
        _bm(p[k]) for k in ("C", "c", "F", "f")]
    for t in inputs:
        t.requires_grad_(True)
    xi, C, c, F, f = inputs
    res = P.solve(cfg, xi, P.QuadCost(C, c), P.LinDx(F, f),
                  u_lower=None if bound is None else -bound,
                  u_upper=None if bound is None else bound)
    loss = (res.x * _bm(g["gx"])).sum() + (res.u * _bm(g["gu"])).sum()
    grads = torch.autograd.grad(loss, inputs)
    for got, name in zip(grads, FIELDS):
        got = got.numpy() if name == "dx_init" else np.swapaxes(got.numpy(), 0, 1)
        np.testing.assert_allclose(got, g[name], atol=2e-3, rtol=2e-3, err_msg=f"{tag}:{name}")


def test_kkt_nonlinear_golden(golden):
    """The nonlinear module-KKT chain (kkt_grad_through_F=False, pnqp) of a
    pendulum solve against the reference at f64, forward to 1e-8 first, then
    gradients to 2e-3 relative (tests/test_grad_modes.py:90-162)."""
    g = golden("kkt_nonlinear_pendulum_f64")
    dyn = tpend.make()
    T = g["u"].shape[0]
    cfg = P.ILQRConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=12, eps=1e-5,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter,
                       detach_unconverged=False, exit_unconverged=False,
                       backward_mode=P.BackwardMode.KKT, qp_solver="pnqp",
                       kkt_grad_through_F=False)
    bm = lambda a: torch.from_numpy(np.swapaxes(a, 0, 1).copy())  # noqa: E731
    inputs = [tpend.default_params(dtype=torch.float64), bm(g["C"]), bm(g["c"]),
              from_numpy(g["x_init"])]
    for t in inputs:
        t.requires_grad_(True)
    params, C, c, xi = inputs
    res = P.solve(cfg, xi, P.QuadCost(C, c), dyn, params=params, u_lower=-2.0, u_upper=2.0)
    np.testing.assert_allclose(res.u.detach().transpose(0, 1).numpy(), g["u"], atol=1e-8)
    loss = (res.x * bm(g["gx"])).sum() + (res.u * bm(g["gu"])).sum()
    grads = torch.autograd.grad(loss, inputs)
    refs = [g["dparams"], np.swapaxes(g["dC"], 0, 1), np.swapaxes(g["dc"], 0, 1),
            g["dx_init"]]
    for a, b, n in zip(grads, refs, ["dparams", "dC", "dc", "dx_init"]):
        a = a.numpy()
        if n == "dC":
            a = 0.5 * (a + np.swapaxes(a, -1, -2))
            b = 0.5 * (b + np.swapaxes(b, -1, -2))
        err = np.abs(a - b).max() / max(1.0, np.abs(b).max())
        assert err <= 2e-3, f"{n}: KKT vs reference rel err {err:.2e}"
