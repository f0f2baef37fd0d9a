"""The whole-solve kernel's jvp sweep on the CPU: the plain version
(ops/cuda/ilqr_fused.ilqr_fused on CPU tensors, i.e. ilqr_fused_reference,
whose Jacobian is then one batched torch.func.jvp a column of the kernel-form
step) against the JAX package's Pallas kernel in interpret mode (solve(...,
backend="pallas") on the CPU, whose ``lin_at`` takes one jvp a column), on
the same numpy-seeded inputs, params through convert.from_numpy:

 * GradMethod.AUTO_DIFF on cartpole and the simple pendulum, with bounds
   that saturate: the pendulum's box is its +-2 torque clamp, so the line
   search parks controls exactly on the clamp (tangent 1 there, torch.clamp's
   convention), and cartpole's box +-150 lies past its +-100 clamp, so a
   control past the clamp has a zero column;
 * the complex pendulum (the IL env "pendulum-complex"'s params 10, 1, 1,
   1, 0.1) under ANALYTIC and AUTO_DIFF;
 * the rocket with normalize_quat=True under both methods (bench.py's
   start, the +-20 box);
 * the complex pendulum's slew rate (Passthrough<JvpJac<PendulumComplex>>);
 * a per-example cost on the complex pendulum;
 * the whole slice: MPC.solve and the IFT gradient through the port's
   kernel route (core/ilqr.ilqr_loop sending the covered configuration to
   ops/cuda/ilqr_fused, whose CPU route is the plain version) against JAX's
   solve and its IFT gradient through its kernel.

Tolerances are tests/test_torch_ilqr_fused.py's and
test_torch_ilqr_variants.py's: u 2e-3, x 5e-3, costs rtol/atol 1e-5, n_iter
equal, on eps=0 solves of a few iterations, short of the f32 forks of a
converged line search (ROADMAP C, "Properties of the problem"): the plain
version's jvp and JAX's differ by a few ulp (torch's atan2, cos and sin
against JAX's in-kernel polynomial atan2, and the order of the rocket's
quaternion norm). The gradient: within 1e-3 of the largest entry, the
rounding of two f32 forwards carried through a GMRES solve. One 1024-example
tile, T <= 8. The reference golden of the renormalizing rocket under
AUTO_DIFF (mpc_rocket_norm_f64) is held by
tests/test_torch_rocket.py::test_rocket_mpc_norm_quat_golden_f64 through the
plain loop."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.models import cartpole as jcart
from dilqr_tpu.models import pendulum as jpend
from dilqr_tpu.models import rocket as jrock
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.core import ilqr as tilqr
from dilqr_tpu_torch.core.solver import augment_slew_rate, canonicalize_cost
from dilqr_tpu_torch.models import cartpole as tcart
from dilqr_tpu_torch.models import pendulum as tpend
from dilqr_tpu_torch.models import rocket as trock
from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused
from rocket_bench_start import bench_start
from test_torch_ilqr_variants import _compare, _tm

IL_PARAMS = np.array([10.0, 1.0, 1.0, 1.0, 0.1], np.float32)  # il/env.py "pendulum-complex"


def _env(name):
    """(JAX model, port model, params [P], box (lo, hi))."""
    if name == "cartpole":
        return (jcart.make(), tcart.make(), np.asarray(jcart.default_params()),
                (-150.0, 150.0))
    if name == "pendulum":
        return jpend.make(), tpend.make(), np.asarray(jpend.default_params()), (-2.0, 2.0)
    if name == "pendulum-complex":
        return jpend.make(simple=False), tpend.make(simple=False), IL_PARAMS, (-2.0, 2.0)
    lim = np.asarray(jrock.make().upper, np.float32)
    return (jrock.make(normalize_quat=True), trock.make(normalize_quat=True),
            np.asarray(jrock.default_params()), (-lim, lim))


def _start(name, B, seed):
    if name == "rocket-norm":
        return bench_start(B, seed)
    rng = np.random.RandomState(seed)
    th = rng.uniform(-3.0, 3.0, B).astype(np.float32)
    w = (0.5 * rng.randn(B)).astype(np.float32)
    if name == "cartpole":
        z = np.zeros(B, np.float32)
        return np.stack([z, z, np.cos(th), np.sin(th), w], 1)
    return np.stack([np.cos(th), np.sin(th), w], 1)


def _cfg_kw(jdyn, T, lqr_iter, auto_diff, eps=0.0):
    return dict(n_state=jdyn.n_state, n_ctrl=jdyn.n_ctrl, T=T, lqr_iter=lqr_iter, eps=eps,
                linesearch_decay=jdyn.linesearch_decay,
                max_linesearch_iter=jdyn.max_linesearch_iter, exit_unconverged=False,
                detach_unconverged=False, backprop=False), (
        (J.GradMethod.AUTO_DIFF, P.GradMethod.AUTO_DIFF) if auto_diff
        else (J.GradMethod.ANALYTIC, P.GradMethod.ANALYTIC))


def _diag_cost(jdyn):
    nx, nu = jdyn.n_state, jdyn.n_ctrl
    q = np.concatenate([np.ones(nx), 0.1 * np.ones(nu)]).astype(np.float32)
    p = np.zeros(nx + nu, np.float32)
    p[:nx] = -np.sqrt(q[:nx]) * _goal(nx)
    return q, p


def _goal(nx):
    g = np.zeros(nx, np.float32)
    g[{5: 2, 3: 0, 13: 6}[nx]] = 1.0  # cos th = 1 upright, the identity quaternion
    return g


def _costs(jdyn, cost):
    """(JAX's, the port's) cost: None is a diagonal cost toward the goal,
    else a per-example (C [B,T,n,n], c [B,T,n]) pair."""
    if cost is None:
        q, p = _diag_cost(jdyn)
        return J.QuadCost(jnp.diag(q), jnp.asarray(p)), (torch.diag(from_numpy(q)),
                                                           from_numpy(p))
    return (J.QuadCost(jnp.asarray(cost[0]), jnp.asarray(cost[1])),
            tuple(_tm(a) for a in cost))


def _port(name, auto_diff, B, T, lqr_iter, cost=None, seed=1, u0=None):
    """The port's plain version on one problem, in the env's box; u0 None
    or a warm start [B,T,nu]. The configuration must be covered."""
    jdyn, tdyn, params, (lo, hi) = _env(name)
    kw, (_, tm) = _cfg_kw(jdyn, T, lqr_iter, auto_diff)
    tcost = _costs(jdyn, cost)[1]
    tb = (lambda v: from_numpy(v)) if isinstance(lo, np.ndarray) else (lambda v: v)
    cfg = P.ILQRConfig(grad_method=tm, **kw)
    assert fused.covered(cfg, tdyn, from_numpy(params), torch.float32,
                         None if cost is not None else tcost, None, None, tb(lo), tb(hi))
    return fused.ilqr_fused(cfg, tdyn, from_numpy(params), from_numpy(_start(name, B, seed)),
                            tcost, None if u0 is None else _tm(u0), tb(lo), tb(hi))


def _both(name, auto_diff, B, T, lqr_iter, cost=None, seed=1, u0=None):
    """JAX's kernel (interpret mode) and the port's plain version (_port)
    on one problem."""
    jdyn, _, params, (lo, hi) = _env(name)
    kw, (jm, _) = _cfg_kw(jdyn, T, lqr_iter, auto_diff)
    jres = J.solve(J.ILQRConfig(backend="pallas", grad_method=jm, **kw),
                   jnp.asarray(_start(name, B, seed)), _costs(jdyn, cost)[0], jdyn,
                   params=jnp.asarray(params), u_lower=jnp.asarray(lo),
                   u_upper=jnp.asarray(hi), u_init=None if u0 is None else jnp.asarray(u0))
    return jres, _port(name, auto_diff, B, T, lqr_iter, cost, seed, u0)


@pytest.mark.parametrize("name", ["cartpole", "pendulum"])
def test_auto_diff_with_saturating_bounds(name):
    """AUTO_DIFF linearizes the clamped step. The pendulum's controls park on
    the box, which is its torque clamp (the column stays: the tie's
    convention). Cartpole starts from controls of +-120 on half its
    examples, past its +-100 force clamp inside the +-150 box, where the
    column is 0; the ANALYTIC solve of the same problem (the un-clamped
    column) ends elsewhere after two iterations, ten times the tolerance
    away, so the clamp's column decides the answer."""
    B, T, it = 8, 6, 4
    u0 = None
    if name == "cartpole":
        it = 2
        rng = np.random.RandomState(6)
        u0 = (0.1 * rng.randn(B, T, 1)).astype(np.float32)
        u0[: B // 2] = 120.0 * np.sign(rng.randn(B // 2, 1, 1))
    jres, out = _both(name, True, B, T, it, u0=u0)
    _compare(jres, out)
    if name == "pendulum":
        assert (np.abs(np.abs(np.asarray(jres.u)) - 2.0) < 1e-6).mean() > 0.1
    else:
        ana = _port(name, False, B, T, it, u0=u0)
        assert (ana[1] - out[1]).abs().max().item() > 2e-2


@pytest.mark.parametrize("auto_diff", [False, True], ids=["analytic", "auto_diff"])
def test_complex_pendulum(auto_diff):
    """The complex pendulum at the IL env's params: no hand Jacobian, so
    the jvp sweep under both methods (the un-clamped physics, the clamped
    step)."""
    _compare(*_both("pendulum-complex", auto_diff, 8, 8, 5))


@pytest.mark.parametrize("auto_diff", [False, True], ids=["analytic", "auto_diff"])
def test_rocket_normalize_quat(auto_diff):
    """The rocket with normalize_quat=True (RocketNorm), bench.py's start
    and its +-20 box, under both methods."""
    _compare(*_both("rocket-norm", auto_diff, 4, 5, 3))


def test_complex_pendulum_slew_rate():
    """The slew rate (penalty 1.0) of the complex pendulum: the augmented
    problem on Passthrough<JvpJac<PendulumComplex>> (the passthrough rows
    exact, the pendulum's from the jvp sweep) against JAX's solve with
    slew_rate_penalty on its kernel."""
    jdyn, tdyn, params, (lo, hi) = _env("pendulum-complex")
    B, T = 8, 6
    x0 = _start("pendulum-complex", B, 2)
    kw, (jm, tm) = _cfg_kw(jdyn, T, 4, True)
    q, p = _diag_cost(jdyn)
    jres = J.solve(J.ILQRConfig(backend="pallas", grad_method=jm, slew_rate_penalty=1.0, **kw),
                   jnp.asarray(x0), J.QuadCost(jnp.diag(q), jnp.asarray(p)), jdyn,
                   params=jnp.asarray(params), u_lower=lo, u_upper=hi)
    cost = canonicalize_cost(P.QuadCost(torch.diag(from_numpy(q)), from_numpy(p)), T, B, 4)
    cfg, acost, adyn, aparams, ax0 = augment_slew_rate(
        P.ILQRConfig(grad_method=tm, slew_rate_penalty=1.0, **kw), cost, tdyn,
        from_numpy(params), from_numpy(x0), None)
    assert adyn.device_env == 8 and adyn.jac_lanes is None
    assert fused.covered(cfg, adyn, aparams, torch.float32, None, None, None, lo, hi)
    _compare(jres, fused.ilqr_fused(cfg, adyn, aparams, ax0, (acost.C, acost.c), None, lo, hi),
             strip=1)


def test_complex_pendulum_per_example_cost():
    """A per-example cost [B, T, n, n] (weights scaled in [1, 1.5] per step
    and example) on the complex pendulum under AUTO_DIFF."""
    B, T = 8, 6
    q, p = _diag_cost(_env("pendulum-complex")[0])
    scale = (1.0 + 0.5 * np.random.RandomState(3).rand(B, T, 1)).astype(np.float32)
    C = (np.broadcast_to(np.diag(q), (B, T, 4, 4)) * scale[..., None]).astype(np.float32)
    c = (np.broadcast_to(p, (B, T, 4)) * scale).astype(np.float32)
    _compare(*_both("pendulum-complex", True, B, T, 4, cost=(C, c)))


def test_jvp_sweep_matches_the_hand_jacobian():
    """The plain version's jvp sweep (jvp_jacobian) of the un-clamped kernel
    step is the hand-derived jac_lanes to rounding (cartpole, the simple
    pendulum, the rocket); under AUTO_DIFF (_jacobian) a control past the
    clamp has a zero column and one exactly on it keeps the un-clamped
    column, torch.clamp's convention."""
    rng = np.random.RandomState(4)
    unclamped = {
        tcart: lambda x, u, p: tcart._step(x, u, p, clamp_u=False, kernel=True),
        tpend: lambda x, u, p: tpend._step(x, u, p, clamp_u=False, simple=True, kernel=True),
        trock: trock.make().step_unclamped,
    }
    for mod, lim in ((tcart, 100.0), (tpend, 2.0), (trock, 400.0)):
        dyn = mod.make()
        nx = dyn.n_state
        x = from_numpy(rng.randn(16, nx).astype(np.float32))
        u = from_numpy((0.5 * lim * rng.randn(16, dyn.n_ctrl)).astype(np.float32))
        params = mod.default_params()
        hand = dyn.jac_lanes(x, u, params)
        jvp_cols = fused.jvp_jacobian(unclamped[mod])(x, u, params)
        assert jvp_cols.dtype == torch.float32
        np.testing.assert_allclose(jvp_cols.numpy(), hand.numpy(),
                                   atol=2e-5 * hand.abs().max().item())
        u_edge = u.clone()
        u_edge[:4] = lim
        u_edge[4:8] = 1.5 * lim
        auto = fused._jacobian(P.GradMethod.AUTO_DIFF, dyn)(x, u_edge, params)
        free = dyn.jac_lanes(x, u_edge, params)
        assert (auto[4:8, :, nx:] == 0).all()
        np.testing.assert_allclose(auto[:4].numpy(), free[:4].numpy(),
                                   atol=2e-5 * free.abs().max().item())


def test_whole_slice_mpc_and_ift_gradient(monkeypatch):
    """MPC.solve on the complex pendulum at the IL env's params and the IFT
    gradient of the mean u^2 with respect to those params, through the
    port's kernel route: core/ilqr.ilqr_loop's dispatch, made to accept
    CPU tensors for the covered configuration, sends the solve to
    ops/cuda/ilqr_fused (the plain version on the CPU) -- against JAX's
    MPC and its IFT gradient through its kernel (interpret mode)."""
    jdyn, tdyn, params, (lo, hi) = _env("pendulum-complex")
    B, T = 8, 6
    x0 = _start("pendulum-complex", B, 5)
    q, p = _diag_cost(jdyn)
    covered = []

    def use_kernel(cfg, cost, dyn, prm, x_init, *rest):
        ok = fused.covered(cfg, dyn, prm, x_init.dtype, rest[2], rest[0], rest[1], rest[3],
                           rest[4])
        covered.append(ok)
        return ok

    monkeypatch.setattr(tilqr, "use_kernel", use_kernel)
    mkw = dict(u_lower=lo, u_upper=hi, lqr_iter=6, eps=0.0, linesearch_decay=0.2,
               max_linesearch_iter=5, exit_unconverged=False, detach_unconverged=False)
    jmpc = J.MPC(3, 1, T, backward_mode=J.BackwardMode.IFT, **mkw)
    jmpc.cfg = dataclasses.replace(jmpc.cfg, backend="pallas")  # its kernel on the CPU
    tmpc = P.MPC(3, 1, T, backward_mode=P.BackwardMode.IFT, **mkw)
    jcost = J.QuadCost(jnp.diag(q), jnp.asarray(p))
    tcost = P.QuadCost(torch.diag(from_numpy(q)), from_numpy(p))

    def jloss(th):
        return jnp.mean(jmpc(jnp.asarray(x0), jcost, jdyn, params=th)[1] ** 2)

    jval, jg = jax.value_and_grad(jloss)(jnp.asarray(params))
    th = from_numpy(params).requires_grad_(True)
    res = tmpc.solve(from_numpy(x0), tcost, tdyn, params=th)
    tval = (res.u ** 2).mean()
    (tg,) = torch.autograd.grad(tval, th)
    assert covered and all(covered)
    jres = jmpc.solve(jnp.asarray(x0), jcost, jdyn, params=jnp.asarray(params))
    np.testing.assert_allclose(res.u.detach().numpy(), np.asarray(jres.u), atol=2e-3)
    np.testing.assert_allclose(res.x.detach().numpy(), np.asarray(jres.x), atol=5e-3)
    np.testing.assert_allclose(res.costs.detach().numpy(), np.asarray(jres.costs), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-4)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-3 * np.abs(jg).max())
