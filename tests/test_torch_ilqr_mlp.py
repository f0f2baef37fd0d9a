"""The learned MLP with its widths fixed on the whole-solve kernel, on the
CPU: the port's pieces against the JAX package on the same numpy-seeded
inputs (weights U(+-1/sqrt(fan_in)), as the init draws them):

 * ``nn_dynamics.flat_params`` against JAX's ``_flatten_pytree_params``
   (ravel_pytree order, None past 256 weights), bit for bit;
 * ``kernel_step`` (the kernel form over the flat weights, the counterpart
   of JAX's ``step_scalars``) against step_scalars and the port's array
   step at f64 (1e-12), and its jvp sweep (``ilqr_fused.jvp_jacobian``, the
   plain version's Jacobian) against jax.jacfwd of step_scalars at f64,
   with relu and elu evaluated at pre-activations of exactly 0;
 * the plain version ``ilqr_fused_reference`` against JAX's Pallas kernel
   in interpret mode on JAX's own small setup (tests/test_fused_nn_dynamics.py:
   25-40: T=7, lqr_iter 4, eps 0, B=6, box +-1): hidden (8,) sigmoid, (6, 6)
   relu, (8,) elu, (16,) sigmoid at n_ctrl 2 (the reference golden's shape),
   and the slew rate of (8,) sigmoid; tolerances
   tests/test_torch_ilqr_variants.py's (u 2e-3, x 5e-3, costs rtol/atol
   1e-5, n_iter equal);
 * the IFT gradient with respect to the weights through the port's kernel
   route (ilqr_loop flattening the weights for the kernel, the backward on
   the pytree) against JAX's through its kernel forward
   (test_mlp_ift_grad_through_fused_forward's setup and its atol 5e-3);
 * the reference golden (tests/goldens/nn_dynamics.npz, NNDynamics(3, 2,
   [16], sigmoid, passthrough)) through kernel_step and jvp_sweep at f64
   (1e-10);
 * the gate's memory admission (``ilqr_fused.jax_tile_fits``) against
   JAX's fused_supported where it binds (n_state 12-21).
"""
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.models import nn_dynamics as jnn
from dilqr_tpu.models.base import Dynamics as JDynamics
from dilqr_tpu.ops.pallas.ilqr_fused import _flatten_pytree_params, fused_supported
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.core import ilqr as tilqr
from dilqr_tpu_torch.core.solver import augment_slew_rate, canonicalize_cost
from dilqr_tpu_torch.models import nn_dynamics as tnn
from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused
from test_torch_ilqr_variants import _compare

importlib.import_module("dilqr_tpu.ops.pallas.ilqr_fused")
fmod = sys.modules["dilqr_tpu.ops.pallas.ilqr_fused"]


def _weights(nx, nu, hidden, seed, dtype=np.float32):
    """[(W [out, in], b [out]), ...] drawn U(+-1/sqrt(fan_in))."""
    rng = np.random.RandomState(seed)
    sizes = [nx + nu] + list(hidden) + [nx]
    return [(rng.uniform(-1, 1, (o, i)).astype(dtype) / np.sqrt(i).astype(dtype),
             rng.uniform(-1, 1, o).astype(dtype) / np.sqrt(i).astype(dtype))
            for i, o in zip(sizes[:-1], sizes[1:])]


def _jw(ws):
    return [(jnp.asarray(W), jnp.asarray(b)) for W, b in ws]


def _tw(ws):
    return [(from_numpy(W), from_numpy(b)) for W, b in ws]


@pytest.mark.parametrize("nx,nu,hidden", [(3, 1, (8,)), (3, 1, (6, 6)), (3, 2, (16,)),
                                          (13, 3, (8,)), (3, 1, ()), (1, 2, (51,)),
                                          (1, 1, (64,)), (5, 1, (100,))])
def test_flat_params_matches_jax_ravel(nx, nu, hidden):
    """flat_params is _flatten_pytree_params bit for bit: 256 weights
    (1, 2, (51,)) flatten, 257 (1, 1, (64,)) and the learned model's 1,205
    (hidden 100) give None in both. The port's kernel route flattens those
    two past JAX's limit (kernel_params, nn_dynamics.weight_limit: one
    hidden layer), in the same order."""
    ws = _weights(nx, nu, hidden, 0)
    j = _flatten_pytree_params(_jw(ws))
    t = tnn.flat_params(_tw(ws))
    n = sum(W.size + b.size for W, b in ws)
    if n > 256:
        assert j is None and t is None
        dyn = tnn.make(nx, nu, hidden_sizes=hidden)
        k = tilqr.kernel_params(dyn, _tw(ws))
        want = np.concatenate([a.reshape(-1) for layer in ws for a in layer])
        assert len(hidden) == 1 and k.shape == (n,)
        assert np.array_equal(want.view(np.uint32), k.numpy().view(np.uint32))
        return
    assert t.shape == (n,) and t.dtype == torch.float32
    assert np.array_equal(np.asarray(j).view(np.uint32), t.numpy().view(np.uint32))


def test_flat_params_refuses_what_is_not_a_weight_list():
    """A flat vector, a dict and a list that is not of (W, b) pairs give
    None (JAX passes a flat vector as it is)."""
    w = torch.zeros(5)
    assert tnn.flat_params(w) is None
    assert tnn.flat_params({"a": w}) is None
    assert tnn.flat_params([w, w]) is None
    assert tnn.flat_params([]) is None


ACT_CASES = [(3, 1, (8,), "sigmoid"), (3, 1, (6, 6), "relu"), (3, 1, (8,), "elu"),
             (3, 2, (16,), "sigmoid"), (13, 3, (8,), "sigmoid")]


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "plain"])
@pytest.mark.parametrize("nx,nu,hidden,act", ACT_CASES)
def test_kernel_step_matches_step_scalars_f64(nx, nu, hidden, act, residual):
    """kernel_step over the flat weights is JAX's step_scalars and the
    port's array step at f64 (1e-12), and its jvp sweep (jvp_jacobian, one
    one-hot tangent a column) is jax.jacfwd of step_scalars (1e-12). Half
    the points are x = 0, u = 0 with zero hidden biases, where every hidden
    pre-activation is exactly 0: relu'(0) = 0 and elu'(0) = 1 there."""
    ws = _weights(nx, nu, hidden, 1, np.float64)
    B = 8
    rng = np.random.RandomState(2)
    x, u = rng.randn(B, nx), rng.randn(B, nu)
    x[B // 2:], u[B // 2:] = 0.0, 0.0
    for li in range(len(ws) - 1):
        ws[li][1][:] = 0.0
    jdyn = jnn.make(nx, nu, activation=act, passthrough=residual, hidden_sizes=hidden)
    tdyn = tnn.make(nx, nu, activation=act, passthrough=residual, hidden_sizes=hidden)
    flat = np.asarray(_flatten_pytree_params(_jw(ws)))
    assert flat.dtype == np.float64

    def jstep(xb, ub):  # step_scalars on axis-0 stacks
        return jdyn.step(xb.T, ub.T, [jnp.asarray(v) for v in flat]).T

    want = np.asarray(jstep(jnp.asarray(x), jnp.asarray(u)))
    tx, tu, tf = from_numpy(x), from_numpy(u), from_numpy(flat)
    got = tdyn.kernel_step(tx, tu, tf)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tdyn.step(tx, tu, _tw(ws)).numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tdyn.step(tx, tu, tf).numpy(), want, rtol=0, atol=1e-12)
    jac = jax.vmap(jax.jacfwd(lambda z: jstep(z[None, :nx], z[None, nx:])[0]))
    want_D = np.asarray(jac(jnp.asarray(np.concatenate([x, u], 1))))
    D = fused.jvp_jacobian(tdyn.kernel_step)(tx, tu, tf)
    np.testing.assert_allclose(D.numpy(), want_D, rtol=0, atol=1e-12)


def _problem(nx, nu, hidden, act, seed=0):
    """JAX's setup (tests/test_fused_nn_dynamics.py:25-40) at (nx, nu):
    T=7, lqr_iter 4, eps 0, B=6, x0 = 0.3 randn, cost diag(1) and 0."""
    ws = _weights(nx, nu, hidden, seed)
    x0 = (0.3 * np.random.RandomState(seed).randn(6, nx)).astype(np.float32)
    kw = dict(n_state=nx, n_ctrl=nu, T=7, lqr_iter=4, eps=0.0, exit_unconverged=False,
              detach_unconverged=False, backprop=False)
    jdyn = jnn.make(nx, nu, activation=act, passthrough=True, hidden_sizes=hidden)
    tdyn = tnn.make(nx, nu, activation=act, passthrough=True, hidden_sizes=hidden)
    return ws, x0, kw, jdyn, tdyn


def _jax_kernel_solve(kw, x0, jdyn, ws, **extra):
    """JAX's solve through its kernel (interpret mode on the CPU), which
    must take it: DISPATCH_STATS counts one fused call."""
    n = kw["n_state"] + kw["n_ctrl"]
    fmod.DISPATCH_STATS.update(fused=0, vmap_merged=0, vmap_mapped=0)
    jres = J.solve(J.ILQRConfig(backend="pallas", **kw, **extra), jnp.asarray(x0),
                   J.QuadCost(jnp.eye(n), jnp.zeros(n)), jdyn, params=_jw(ws), u_lower=-1.0,
                   u_upper=1.0)
    assert fmod.DISPATCH_STATS["fused"] == 1, "JAX's MLP solve did not take its kernel"
    return jres


@pytest.mark.parametrize("nx,nu,hidden,act", ACT_CASES[:4])
def test_plain_version_matches_jax_kernel(nx, nu, hidden, act):
    """ilqr_fused_reference (ilqr_fused on CPU tensors) with the flat
    weights against JAX's kernel on the pytree, which it flattens."""
    ws, x0, kw, jdyn, tdyn = _problem(nx, nu, hidden, act)
    jres = _jax_kernel_solve(kw, x0, jdyn, ws)
    n = nx + nu
    cfg, flat = P.ILQRConfig(**kw), tnn.flat_params(_tw(ws))
    cost = (torch.eye(n), torch.zeros(n))
    assert fused.covered(cfg, tdyn, flat, torch.float32, cost, None, None, -1.0, 1.0)
    _compare(jres, fused.ilqr_fused(cfg, tdyn, flat, from_numpy(x0), cost, None, -1.0, 1.0))


def test_slew_rate_matches_jax_kernel():
    """The slew rate (penalty 1.0) of the (8,) sigmoid MLP: the augmented
    problem on Passthrough<Mlp> (device env 11) against JAX's solve
    with slew_rate_penalty on its kernel."""
    ws, x0, kw, jdyn, tdyn = _problem(3, 1, (8,), "sigmoid", seed=3)
    jres = _jax_kernel_solve(kw, x0, jdyn, ws, slew_rate_penalty=1.0)
    cost = canonicalize_cost(P.QuadCost(torch.eye(4), torch.zeros(4)), 7, 6, 4)
    cfg, acost, adyn, aparams, ax0 = augment_slew_rate(
        P.ILQRConfig(slew_rate_penalty=1.0, **kw), cost, tdyn, _tw(ws), from_numpy(x0), None)
    assert adyn.device_env == 11 and adyn.device_mlp.slew and adyn.kernel_step is not None
    flat = tilqr.kernel_params(adyn, aparams)
    assert fused.covered(cfg, adyn, flat, torch.float32, None, None, None, -1.0, 1.0)
    _compare(jres, fused.ilqr_fused(cfg, adyn, flat, ax0, (acost.C, acost.c), None, -1.0, 1.0),
             strip=1)


def test_ift_gradient_through_the_kernel_route(monkeypatch):
    """The IFT gradient of mean(u^2) with respect to the weights (JAX's
    test_mlp_ift_grad_through_fused_forward: eps 1e-4, lqr_iter 8): the
    port's solve with its dispatch made to accept CPU tensors for the
    covered configuration, so ilqr_loop flattens the weights into the
    kernel route (the plain version on the CPU) and the backward runs on
    the pytree, against JAX's gradient through its kernel forward; atol
    5e-3, JAX's own between its kernel and XLA forwards."""
    ws, x0, kw, jdyn, tdyn = _problem(3, 1, (8,), "sigmoid")
    kw = dict(kw, backprop=True, eps=1e-4, lqr_iter=8)
    routed = []

    def use_kernel(cfg, cost, dyn, prm, x_init, *rest):
        ok = fused.covered(cfg, dyn, prm, x_init.dtype, rest[2], rest[0], rest[1], rest[3],
                           rest[4])
        routed.append(ok and isinstance(prm, torch.Tensor))
        return ok

    monkeypatch.setattr(tilqr, "use_kernel", use_kernel)
    jcfg = J.ILQRConfig(backend="pallas", backward_mode=J.BackwardMode.IFT, **kw)

    def jloss(pp):
        r = J.solve(jcfg, jnp.asarray(x0), J.QuadCost(jnp.eye(4), jnp.zeros(4)), jdyn,
                    params=pp, u_lower=-1.0, u_upper=1.0)
        return jnp.mean(r.u ** 2)

    jg = jax.grad(jloss)(_jw(ws))
    tws = [tuple(a.requires_grad_(True) for a in layer) for layer in _tw(ws)]
    res = P.solve(P.ILQRConfig(backward_mode=P.BackwardMode.IFT, **kw), from_numpy(x0),
                  P.QuadCost(torch.eye(4), torch.zeros(4)), tdyn, params=tws, u_lower=-1.0,
                  u_upper=1.0)
    tg = torch.autograd.grad((res.u ** 2).mean(), [a for layer in tws for a in layer])
    assert routed and all(routed)
    fa = np.concatenate([np.asarray(a).ravel() for a in jax.tree_util.tree_leaves(jg)])
    ta = np.concatenate([g.numpy().ravel() for g in tg])
    assert np.isfinite(ta).all() and np.abs(ta).max() > 0
    np.testing.assert_allclose(ta, fa, atol=5e-3)


def test_golden_forward_and_jacobian(golden):
    """The reference's NNDynamics golden (3 states, 2 controls, hidden 16,
    sigmoid, passthrough; 147 weights): x' from kernel_step on the flat
    weights and R = dx'/dx, S = dx'/du from its jvp sweep, at f64, against
    the reference's forward and hand-backprop grad_input."""
    g = golden("nn_dynamics")
    dyn = tnn.make(3, 2, activation="sigmoid", passthrough=True, hidden_sizes=(16,))
    flat = tnn.flat_params(from_numpy([(g["W0"], g["b0"]), (g["W1"], g["b1"])]))
    assert flat.shape == (147,) and flat.dtype == torch.float64
    x, u = from_numpy(g["x"]), from_numpy(g["u"])
    np.testing.assert_allclose(dyn.kernel_step(x, u, flat).numpy(), g["x_next"], atol=1e-10)
    D = fused.jvp_jacobian(dyn.kernel_step)(x, u, flat).numpy()
    np.testing.assert_allclose(D[:, :, :3], g["R"], atol=1e-10)
    np.testing.assert_allclose(D[:, :, 3:], g["S"], atol=1e-10)


@pytest.mark.parametrize("nu", [1, 2, 3, 7, 8])
@pytest.mark.parametrize("small", [True, False], ids=["small_cost", "lanes_cost"])
def test_memory_admission_matches_jax(nu, small):
    """ilqr_fused.jax_tile_fits within covered, on a one-hidden-unit MLP,
    against JAX's fused_supported where its memory model binds: n_state 12
    to 21 at T 2, 7, 20 and 300, with and without a warm start, a u_zero_I
    mask and per-time bounds."""
    rows = []
    for nx in range(12, 22):
        n = nx + nu
        tdyn = tnn.make(nx, nu, hidden_sizes=(1,))
        flat = torch.zeros(tdyn.device_mlp.n_weights)
        jdyn = JDynamics(n_state=nx, n_ctrl=nu, step=lambda x, u, p: x)
        for T in (2, 7, 20, 300):
            for warm, mask, dyn_bounds in ((False, False, False), (True, False, False),
                                           (True, True, True)):
                hi = jnp.ones((T, 4, nu)) if dyn_bounds else 1.0
                thi = torch.ones(T, 4, nu) if dyn_bounds else 1.0
                cs = (jnp.eye(n), jnp.zeros(n)) if small else None
                tcs = (torch.eye(n), torch.zeros(n)) if small else None
                j_ok = fused_supported(J.ILQRConfig(n_state=nx, n_ctrl=nu, T=T),
                                       J.QuadCost(jnp.eye(n), jnp.zeros(n)), jdyn,
                                       jnp.zeros(5), jnp.zeros((T, 4, nu), bool) if mask
                                       else None, None, jnp.float32, cost_small=cs,
                                       u_init_zero=not warm, u_lower=-hi, u_upper=hi)
                t_ok = fused.covered(P.ILQRConfig(n_state=nx, n_ctrl=nu, T=T), tdyn, flat,
                                     torch.float32, tcs, torch.zeros(T, 4, nu, dtype=torch.bool)
                                     if mask else None, None, -thi, thi,
                                     u_init_zero=not warm)
                rows.append(((nx, T, warm, mask, dyn_bounds), bool(j_ok), bool(t_ok)))
    assert any(j for _, j, _ in rows) and not all(j for _, j, _ in rows)
    for label, j_ok, t_ok in rows:
        assert j_ok == t_ok, label
