"""The reverse Riccati kernel's plain version and its dispatch on the CPU.

riccati_fused_reference (what csrc/riccati_fused.cu computes) against the
JAX package's fused Pallas Riccati kernel in interpret mode
(``lqr_backward(..., backend="pallas")``) and against the port's plain
``lqr_backward``, on the JAX kernel test's random symmetric problems and
shapes (tests/test_pallas_kernels.py:15-35), in the free, box (the JAX test's +-1 and
a tight +-0.2), zero and delta_u modes, f32. Tolerance atol 2e-6, the JAX kernel test's bar: the
same recursion in another summation order. Also the ``covered`` table and
the dispatch: CPU tensors launch nothing, backend "cuda" on CPU tensors
raises, the UNROLL loop and the KKT backward hand their backend on."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dilqr_tpu.ops.pallas.riccati_fused import pallas_supported
from dilqr_tpu.ops.riccati import lqr_backward as j_lqr_backward
import dilqr_tpu_torch as P
from dilqr_tpu_torch.core import ilqr as t_ilqr
from dilqr_tpu_torch.diff import kkt as t_kkt
from dilqr_tpu_torch.models import cartpole
from dilqr_tpu_torch.ops.cuda import riccati_fused as rf
from dilqr_tpu_torch.ops.riccati import lqr_backward

SHAPES = [(6, 5, 4), (3, 2, 5)]
MODES = ["free", "box", "tight", "zero", "delta_u"]


def _problem(seed, T, B, nx):
    """tests/test_pallas_kernels.py:15-23, plus a zero mask."""
    n = nx + 1
    rng = np.random.RandomState(seed)
    A = rng.randn(T, B, n, n).astype(np.float32)
    C = A @ A.transpose(0, 1, 3, 2) + 2.0 * np.eye(n, dtype=np.float32)
    c = rng.randn(T, B, n).astype(np.float32)
    F = (0.3 * rng.randn(T - 1, B, nx, n)).astype(np.float32)
    u = (0.5 * rng.randn(T, B, 1)).astype(np.float32)
    uz = rng.rand(T, B, 1) < 0.3
    return C, c, F, u, uz


def _mode_kw(mode, uz):
    return {"free": {}, "box": dict(u_lower=-1.0, u_upper=1.0),
            "tight": dict(u_lower=-0.2, u_upper=0.2), "zero": dict(u_zero_I=uz),
            "delta_u": dict(u_lower=-1.0, u_upper=1.0, delta_u=0.3)}[mode]


def _torch_args(C, c, F, u, kw):
    t = lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a  # noqa: E731
    return (t(C), t(c), t(F), t(u)), {k: t(v) for k, v in kw.items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_pallas_kernel(shape, mode):
    T, B, nx = shape
    C, c, F, u, uz = _problem(0, T, B, nx)
    kw = _mode_kw(mode, uz)
    want = j_lqr_backward(nx, 1, jnp.asarray(C), jnp.asarray(c), jnp.asarray(F), None,
                          jnp.asarray(u), backend="pallas",
                          **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                             for k, v in kw.items()})
    args, tkw = _torch_args(C, c, F, u, kw)
    before = rf.LAUNCHES
    K, k = rf.riccati_fused(nx, *args, **tkw)  # CPU tensors: the plain version
    assert rf.LAUNCHES == before
    assert K.shape == (T, B, 1, nx) and k.shape == (T, B, 1)
    np.testing.assert_allclose(K.numpy(), np.asarray(want.K), atol=2e-6, rtol=0)
    np.testing.assert_allclose(k.numpy(), np.asarray(want.k), atol=2e-6, rtol=0)
    if mode == "tight":  # the clip and the active set do some work here
        at_bound = (np.abs(k.numpy() + 0.2 + u) < 1e-6) | (np.abs(k.numpy() - 0.2 + u) < 1e-6)
        assert at_bound.any() and not at_bound.all()


@pytest.mark.parametrize("mode", ["box", "zero"])
@pytest.mark.parametrize("nx", [9, 16])
def test_reference_matches_jax_pallas_kernel_past_eight_states(nx, mode):
    """n_state 9 and 16, which the kernel now covers as JAX's gate does:
    the plain version against JAX's Pallas kernel in interpret mode, box
    (+-1, a [T,B,1] lower bound) and zero modes, atol 2e-6 as above."""
    T, B = 3, 2
    C, c, F, u, uz = _problem(4, T, B, nx)
    kw = _mode_kw(mode, uz)
    if mode == "box":
        kw["u_lower"] = np.full((T, B, 1), -1.0, np.float32)
    want = j_lqr_backward(nx, 1, jnp.asarray(C), jnp.asarray(c), jnp.asarray(F), None,
                          jnp.asarray(u), backend="pallas",
                          **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                             for k, v in kw.items()})
    args, tkw = _torch_args(C, c, F, u, kw)
    K, k = rf.riccati_fused(nx, *args, **tkw)
    np.testing.assert_allclose(K.numpy(), np.asarray(want.K), atol=2e-6, rtol=0)
    np.testing.assert_allclose(k.numpy(), np.asarray(want.k), atol=2e-6, rtol=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES + [(20, 33, 8), (1, 4, 1)])
def test_reference_matches_plain_recursion(shape, mode):
    """The kernel's semantics against the port's plain lqr_backward on the
    same inputs (symmetric C), including n_state 8 and T=1."""
    T, B, nx = shape
    C, c, F, u, uz = _problem(1, T, B, nx)
    args, tkw = _torch_args(C, c, F, u, _mode_kw(mode, uz))
    K, k = rf.riccati_fused_reference(nx, *args, **tkw)
    want = lqr_backward(nx, 1, args[0], args[1], args[2], None, args[3], backend="torch", **tkw)
    torch.testing.assert_close(K, want.K, atol=2e-6, rtol=0)
    torch.testing.assert_close(k, want.k, atol=2e-6, rtol=0)


def test_covered_table():
    f32, f64 = torch.float32, torch.float64
    mask = torch.zeros(3, 2, 1, dtype=torch.bool)
    assert rf.covered(5, 1, f32, None, "auto", True)
    assert rf.covered(1, 1, f32, None, "auto", False) and rf.covered(8, 1, f32, mask, "auto", False)
    assert rf.covered(9, 1, f32, None, "auto", True)  # any n_state, as JAX's gate
    assert rf.covered(40, 1, f32, mask, "auto", False)
    assert not rf.covered(0, 1, f32, None, "auto", True)
    assert not rf.covered(5, 2, f32, None, "auto", True)  # one control only
    assert not rf.covered(5, 1, f64, None, "auto", True)
    assert not rf.covered(5, 1, f32, None, "pnqp", True)
    assert not rf.covered(5, 1, f32, mask, "auto", True)  # the mask only without a box
    assert not rf.covered(5, 1, f32, None, "auto", False, f=torch.zeros(2, 2, 5))


def test_covered_equals_jax_gate():
    """covered admits exactly what JAX sends to its Pallas kernel --
    pallas_supported and f is None (dilqr_tpu/ops/riccati.py:135-152) --
    over n_state 1..40, n_ctrl 1..3, both float types, mask on and off,
    both QP solvers, boxed or not, and f given or not."""
    mask = torch.zeros(3, 2, 1, dtype=torch.bool)
    f = torch.zeros(2, 2, 5)
    for nx in range(1, 41):
        for nu in (1, 2, 3):
            for jt, tt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
                for uz in (None, mask):
                    for qp in ("auto", "pnqp"):
                        for boxed in (False, True):
                            for ff in (None, f):
                                want = pallas_supported(nu, jt, uz, qp, boxed) and ff is None
                                got = rf.covered(nx, nu, tt, uz, qp, boxed, ff)
                                assert got == want, (nx, nu, tt, uz is None, qp, boxed, ff)


def test_dispatch_on_cpu():
    """"auto" and "torch" on CPU tensors run the plain recursion and launch
    nothing; "cuda" raises; an unknown backend raises."""
    C, c, F, u, _ = _problem(2, 5, 3, 4)
    args, _ = _torch_args(C, c, F, u, {})
    before = rf.LAUNCHES
    outs = [lqr_backward(4, 1, args[0], args[1], args[2], None, args[3], u_lower=-1.0,
                         u_upper=1.0, backend=b) for b in ("auto", "torch")]
    assert rf.LAUNCHES == before
    torch.testing.assert_close(outs[0].K, outs[1].K, atol=0, rtol=0)
    assert outs[0].n_total_qp_iter == 5
    with pytest.raises(ValueError, match="CUDA tensors"):
        lqr_backward(4, 1, args[0], args[1], args[2], None, args[3], backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        lqr_backward(4, 1, args[0], args[1], args[2], None, args[3], backend="pallas")


def _record_backends(monkeypatch, module):
    seen = []
    orig = module.lqr_backward

    def spy(*a, **kw):
        seen.append(kw.get("backend"))
        return orig(*a, **kw)

    monkeypatch.setattr(module, "lqr_backward", spy)
    return seen


@pytest.mark.parametrize("unroll", [False, True])
def test_lqr_step_hands_on_its_backend(monkeypatch, unroll):
    """The plain loop passes cfg.backend to the Riccati backward, and
    "torch" under cfg.unroll (the kernel has no autograd rule)."""
    seen = _record_backends(monkeypatch, t_ilqr)
    dyn = cartpole.make()
    q, p = cartpole.get_true_obj()
    x0 = torch.tensor([[0.0, 0.0, -1.0, 0.1, 0.0]])
    cfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=4, lqr_iter=2, backprop=False, unroll=unroll,
                       exit_unconverged=False)
    P.solve(cfg, x0, P.QuadCost(torch.diag(q), p), dyn, params=cartpole.default_params(),
            u_lower=-100.0, u_upper=100.0)
    assert seen and set(seen) == {"torch" if unroll else "auto"}


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_kkt_backward_hands_on_its_backend(monkeypatch, backend):
    """The plain KKT VJP's auxiliary LQR gets the backend make_kkt_vjp was
    given."""
    seen = _record_backends(monkeypatch, t_kkt)
    T, B, nx = 5, 3, 4
    C, c, F, u, uz = _problem(3, T, B, nx)
    t = torch.from_numpy
    vjp = t_kkt.make_kkt_vjp(nx, 1, t(C), t(c), t(F), t(np.zeros((T, B, nx), np.float32)), t(u),
                             u_zero_I=t(uz), backend=backend)
    vjp(torch.ones(T, B, nx), torch.ones(T, B, 1))
    assert seen == [backend]
