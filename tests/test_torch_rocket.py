"""The rocket in the PyTorch port: the model against the JAX package at f64,
the reference's rocket goldens through the port's plain solve and its
receding_horizon, the whole-solve kernel's plain version on a ragged
two-tile batch, and which rocket configurations the kernel covers.

Inputs are made with numpy from a seed and reach the port through
convert.from_numpy. Tolerances: 1e-12 at f64 for the model (the same
expressions, last-bit rounding aside); the JAX tests' bounds for the env
golden (tests/test_envs.py) and the solver goldens (1e-6 at f64,
tests/test_rocket_golden.py); 1e-6 absolute for the per-tile check (the
same arithmetic on the same examples)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

import dilqr_tpu as J
from dilqr_tpu.control import receding_horizon as j_receding_horizon
from dilqr_tpu.models import rocket as jr
import dilqr_tpu_torch as P
from dilqr_tpu_torch.control import receding_horizon
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.models import rocket as tr
from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused
from dilqr_tpu_torch.tools import rounding_witness
from rocket_bench_start import bench_start


def _points(B, seed):
    """States with an un-normalized quaternion and thrusts inside and past
    the +-400 clamp."""
    rng = np.random.RandomState(seed)
    return rng.randn(B, 13), 300.0 * rng.randn(B, 3)


PARAMS = np.array([0.5, 1.2, 0.8, 1.3, 0.9])  # unequal inertias: every coupling term counts


@pytest.mark.parametrize("form", ["step", "step_unclamped"])
@pytest.mark.parametrize("normalize_quat", [False, True])
def test_step_matches_jax_f64(normalize_quat, form):
    x, u = _points(32, 0)
    jdyn, tdyn = jr.make(normalize_quat), tr.make(normalize_quat)
    want = np.asarray(jax.vmap(lambda xi, ui: getattr(jdyn, form)(xi, ui, jnp.asarray(PARAMS)))(
        jnp.asarray(x), jnp.asarray(u)))
    got = getattr(tdyn, form)(from_numpy(x), from_numpy(u), from_numpy(PARAMS)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def test_jac_lanes_matches_jax_and_jacfwd_f64():
    """jac_lanes (the kernel's Jacobian of the un-clamped step) against the
    JAX package's and against torch.func.jacfwd of the port's
    step_unclamped; the kernel form of the step is the step itself."""
    x, u = _points(32, 1)
    x[:, 6:10] *= 0.3  # thrusts of order 300 scale the DCM partials: keep D of order 10
    jdyn, tdyn = jr.make(), tr.make()
    want = np.asarray(jdyn.jac_lanes(jnp.asarray(x.T), jnp.asarray(u.T), jnp.asarray(PARAMS)))
    want = np.moveaxis(want, -1, 0)  # lanes [13, 16, B] -> [B, 13, 16]
    tx, tu, tp = from_numpy(x), from_numpy(u), from_numpy(PARAMS)
    got = tdyn.jac_lanes(tx, tu, tp)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    for i in range(4):
        J = jacfwd(lambda xu: tdyn.step_unclamped(xu[:13], xu[13:], tp))(torch.cat([tx[i], tu[i]]))
        np.testing.assert_allclose(J.numpy(), got[i].numpy(), atol=1e-12, rtol=0)
    assert torch.equal(tdyn.kernel_step(tx, tu, tp), tdyn.step(tx, tu, tp))


def test_env_golden(golden):
    """The reference's env golden (step, hand-written D, cost spec) at the
    JAX tests' f32 tolerances (tests/test_envs.py)."""
    g = golden("env_rocket")
    dyn = tr.make()
    p = from_numpy(np.asarray(jr.default_params()))
    x = from_numpy(g["x"], dtype=torch.float32)
    u = from_numpy(g["u"], dtype=torch.float32)
    np.testing.assert_allclose(dyn.step(x, u, p).numpy(), g["x_next"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dyn.jac_lanes(x, u, p).numpy(), g["D"], atol=2e-4, rtol=2e-4)
    q, c = tr.get_true_obj()
    np.testing.assert_allclose(q.numpy(), g["q"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(c.numpy(), g["p"], atol=1e-5, rtol=1e-5)


def test_true_obj_and_params_match_jax():
    for a, b in zip(jr.get_true_obj(), tr.get_true_obj()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tr.default_params().numpy(), np.asarray(jr.default_params()))
    for a, b in zip(jr.get_cost_matrices(2, 3), tr.get_cost_matrices(2, 3)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jd, td = jr.make(), tr.make()
    np.testing.assert_array_equal(td.lower.numpy(), np.asarray(jd.lower))
    np.testing.assert_array_equal(td.upper.numpy(), np.asarray(jd.upper))
    assert (td.mpc_eps, td.linesearch_decay, td.max_linesearch_iter) == (
        jd.mpc_eps, jd.linesearch_decay, jd.max_linesearch_iter)


def _golden_solve(g, dyn, grad_method):
    f64 = torch.float64
    cfg = P.ILQRConfig(n_state=13, n_ctrl=3, T=g["u"].shape[0], lqr_iter=20, eps=dyn.mpc_eps,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter, detach_unconverged=False,
                       exit_unconverged=False, grad_method=grad_method, backprop=False,
                       qp_solver="pnqp")
    return P.solve(cfg, from_numpy(g["x_init"]),
                   P.QuadCost(torch.diag(from_numpy(g["q"])), from_numpy(g["p"])), dyn,
                   params=tr.default_params(dtype=f64), u_lower=-20.0, u_upper=20.0)


def test_rocket_mpc_golden_f64(golden):
    """The reference's box +-20 rocket solve (tests/test_rocket_golden.py)."""
    g = golden("mpc_rocket_f64")
    res = _golden_solve(g, tr.make(), P.GradMethod.ANALYTIC)
    np.testing.assert_allclose(res.u.transpose(0, 1).numpy(), g["u"], atol=1e-6)
    np.testing.assert_allclose(res.x.transpose(0, 1).numpy(), g["x"], atol=1e-6)
    np.testing.assert_allclose(res.costs.numpy(), g["objs"], rtol=1e-6)


def test_rocket_mpc_norm_quat_golden_f64(golden):
    """normalize_quat=True with AUTO_DIFF, as the reference golden was
    made."""
    g = golden("mpc_rocket_norm_f64")
    res = _golden_solve(g, tr.make(normalize_quat=True), P.GradMethod.AUTO_DIFF)
    np.testing.assert_allclose(res.u.transpose(0, 1).numpy(), g["u"], atol=1e-6)
    np.testing.assert_allclose(res.x.transpose(0, 1).numpy(), g["x"], atol=1e-6)


def test_rocket_receding_golden_f64(golden):
    """Five unbounded closed-loop steps, each warm-started with the
    previous plan shifted by one (the reference demo's
    u <- cat(u[1:], u[-1:]))."""
    g = golden("rocket_receding_f64")
    dyn = tr.make()
    cfg = P.ILQRConfig(n_state=13, n_ctrl=3, T=20, lqr_iter=30, eps=1e-2,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter, detach_unconverged=False,
                       exit_unconverged=False, backprop=False)
    ep = receding_horizon(cfg, dyn, tr.default_params(dtype=torch.float64),
                          P.QuadCost(torch.diag(from_numpy(g["q"])), from_numpy(g["p"])),
                          from_numpy(g["x_init"]), n_steps=g["us"].shape[0])
    np.testing.assert_allclose(ep.us[0].numpy(), g["us"], atol=1e-6)
    np.testing.assert_allclose(ep.xs[0].numpy(), g["xs"], atol=1e-6)


def _f64_problem(B, seed):
    x0 = bench_start(B, seed).astype(np.float64)
    q, c = (np.asarray(a, np.float64) for a in jr.get_true_obj())
    return x0, q, c


@pytest.mark.parametrize("lower", ["scalar", "per_control"])
def test_mixed_bounds_match_jax_f64(lower):
    """A scalar or [3] lower bound beside a per-example, per-step upper
    bound [B,T,3]. The plain line search indexed both bounds by t only when
    the lower one was per-step, so this raised a shape error; JAX expands
    each bound on its own (dilqr_tpu/ops/rollout.py:141-148)."""
    B, T = 3, 5
    x0, q, c = _f64_problem(B, 0)
    rng = np.random.RandomState(1)
    hi = 0.05 + 0.3 * rng.rand(B, T, 3)
    lo = -0.2 if lower == "scalar" else np.array([-0.3, -0.05, -0.1])
    kw = dict(n_state=13, n_ctrl=3, T=T, lqr_iter=6, eps=1e-6, linesearch_decay=0.2,
              max_linesearch_iter=5, backprop=False, exit_unconverged=False)
    want = J.solve(J.ILQRConfig(backend="xla", **kw), jnp.asarray(x0),
                   J.QuadCost(jnp.diag(q), jnp.asarray(c)), jr.make(),
                   params=jnp.asarray(jr.default_params(), jnp.float64), u_lower=lo,
                   u_upper=jnp.asarray(hi))
    got = P.solve(P.ILQRConfig(**kw), from_numpy(x0), P.QuadCost(torch.diag(from_numpy(q)),
                                                                  from_numpy(c)),
                  tr.make(), params=tr.default_params(dtype=torch.float64),
                  u_lower=lo if lower == "scalar" else from_numpy(lo), u_upper=from_numpy(hi))
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs), atol=1e-6, rtol=0)
    assert (np.abs(got.u.numpy() - hi) < 1e-9).any()


def test_receding_horizon_per_control_bounds_matches_jax_f64():
    """Three closed-loop rocket steps with [3] bounds and the shifted warm
    start, against JAX's receding_horizon (one lax.scan) at f64."""
    B, T = 3, 6
    x0, q, c = _f64_problem(B, 0)
    hi = np.array([0.3, 0.05, 0.05])
    kw = dict(n_state=13, n_ctrl=3, T=T, lqr_iter=6, eps=1e-6, linesearch_decay=0.2,
              max_linesearch_iter=5, backprop=False, exit_unconverged=False)
    want = j_receding_horizon(J.ILQRConfig(backend="xla", **kw), jr.make(),
                              jnp.asarray(jr.default_params(), jnp.float64),
                              J.QuadCost(jnp.diag(q), jnp.asarray(c)), jnp.asarray(x0), 3,
                              u_lower=-hi, u_upper=hi)
    got = receding_horizon(P.ILQRConfig(**kw), tr.make(), tr.default_params(dtype=torch.float64),
                           P.QuadCost(torch.diag(from_numpy(q)), from_numpy(c)), from_numpy(x0),
                           3, u_lower=from_numpy(-hi), u_upper=from_numpy(hi))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    assert (np.abs(np.abs(got.us.numpy()) - hi) < 1e-9).mean() > 0.5


def test_reference_decides_per_1024_tile_with_three_controls():
    """Tiles are independent with the box-QP's per-tile Newton and Armijo
    votes too: each tile of a ragged 2-tile batch (tight per-control
    bounds, a quarter and more of the controls at a bound) gives what it
    gives solved alone, and the tiles stop at different iterations."""
    dyn = tr.make()
    params = tr.default_params()
    q, p = tr.get_true_obj()
    x0 = torch.from_numpy(np.concatenate([bench_start(1024, 0, 0.1), bench_start(6, 1, 10.0)]))
    hi = torch.tensor([0.3, 0.05, 0.05])
    cfg = P.ILQRConfig(n_state=13, n_ctrl=3, T=6, lqr_iter=8, eps=1e-3,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter, backprop=False)
    args = ((torch.diag(q), p), None, -hi, hi)
    whole = fused.ilqr_fused_reference(cfg, dyn, params, x0, *args)
    iters = []
    for sl in (slice(0, 1024), slice(1024, 1030)):
        alone = fused.ilqr_fused_reference(cfg, dyn, params, x0[sl], *args)
        for a, w in zip(alone[:4], whole[:4]):
            dim = 1 if a.dim() == 3 else 0
            want = w.narrow(dim, sl.start, sl.stop - sl.start)
            np.testing.assert_allclose(a.numpy(), want.numpy(), atol=1e-6, rtol=0)
        iters.append(int(alone[4]))
        at_bound = ((alone[1] - hi).abs() < 1e-6) | ((alone[1] + hi).abs() < 1e-6)
        assert at_bound.float().mean() > 0.25
    assert len(set(iters)) > 1, iters
    assert int(whole[4]) == max(iters)


def test_covered_rocket_configurations():
    """The kernel takes the rocket with normalize_quat False or True (the
    jvp sweep's RocketNorm), ANALYTIC or AUTO_DIFF, qp_solver "auto",
    static bounds (None, a scalar or [3]) or per-time ones, f32; not
    qp_solver "pnqp", FINITE_DIFF, bounds of another T or control count, or
    f64."""
    dyn, params = tr.make(), tr.default_params()
    q, p = tr.get_true_obj()
    cfg = P.ILQRConfig(n_state=13, n_ctrl=3, T=6, backprop=False)

    def cov(cfg=cfg, dyn=dyn, params=params, dtype=torch.float32, lo=dyn.lower, hi=dyn.upper):
        return fused.covered(cfg, dyn, params, dtype, (torch.diag(q), p), None, None, lo, hi)

    assert cov() and cov(lo=-1.0, hi=1.0) and cov(lo=None, hi=None)
    assert cov(dyn=tr.make(normalize_quat=True))
    assert cov(cfg=dataclasses.replace(cfg, grad_method=P.GradMethod.AUTO_DIFF))
    assert not cov(cfg=dataclasses.replace(cfg, grad_method=P.GradMethod.FINITE_DIFF))
    assert not cov(cfg=dataclasses.replace(cfg, qp_solver="pnqp"))
    assert cov(lo=-torch.ones(6, 1, 3), hi=torch.ones(6, 1, 3))
    assert not cov(lo=-torch.ones(7, 1, 3), hi=torch.ones(7, 1, 3))
    assert not cov(lo=-torch.ones(2), hi=torch.ones(2))
    assert not cov(dtype=torch.float64)
    assert not cov(params=params[:4])
    assert fused.static_bounds(torch.tensor([-1.0, -2.0, -3.0]), 4.0, 3) == (
        (-1.0, -2.0, -3.0), (4.0, 4.0, 4.0))
    assert fused.static_bounds(None, torch.tensor(2.0), 3) == (
        (-float("inf"),) * 3, (2.0, 2.0, 2.0))
    assert fused.static_bounds(-torch.ones(6, 3), torch.ones(6, 3), 3) is None


def test_rounding_witness_distances_and_cli_on_cpu(capsys):
    """tools/rounding_witness: ``distances`` counts u, cost and active-set
    differences per control and per step; the command runs on the CPU,
    where the plain version takes the kernel's place, so kernel-vs-plain
    is exactly zero."""
    T, B = 3, 2
    lo, hi = -torch.tensor([1.0, 0.5, 0.5]), torch.tensor([1.0, 0.5, 0.5])
    u = torch.zeros(T, B, 3)
    u[1, 0, 2] = 0.5  # at the bound in a only
    v = u.clone()
    v[1, 0, 2] = 0.4999
    x = torch.zeros(T, B, 13)
    a = (x, u, torch.tensor([1.0, 2.0]), torch.tensor([1e-4, 1e-2]), torch.tensor(3))
    b = (x, v, torch.tensor([1.0, 2.0005]), torch.tensor([1e-4, 1e-4]), torch.tensor(3))
    d = rounding_witness.distances(a, b, lo, hi, eps=1e-3)
    assert d["active_mismatch"] == [0, 0, 1] and d["active_mismatch_per_step"] == [0, 1, 0]
    assert d["converged"] == 1 and d["u_max_converged"] == pytest.approx([0.0, 0.0, 1e-4], abs=1e-7)
    assert d["cost_past_1e-4_per_tile"] == [1] and d["cost_rel_max"] == pytest.approx(2.5e-4, rel=1e-3)
    assert rounding_witness.main(["--B", "5", "--T", "4", "--lqr-iter", "2", "--eps", "0",
                               "--ladder", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "kernel vs plain" in ln]
    assert len(lines) == 2
    assert all("u max per control ['0.00e+00', '0.00e+00', '0.00e+00']" in ln for ln in lines)


def test_rocket_cpu_solve_launches_nothing():
    """A covered rocket solve on CPU tensors takes the plain loop (the
    kernel's plain version only through ilqr_fused itself), launches no
    kernel, and backend="cuda" refuses CPU tensors."""
    dyn, params = tr.make(), tr.default_params()
    q, p = tr.get_true_obj()
    x0 = torch.from_numpy(bench_start(3, 2))
    mpc = P.MPC(13, 3, 6, u_lower=dyn.lower, u_upper=dyn.upper, lqr_iter=3, eps=1e-3,
                backprop=False, exit_unconverged=False)
    before = fused.LAUNCHES
    x, u, costs = mpc(x0, P.QuadCost(torch.diag(q), p), dyn, params=params)
    assert fused.LAUNCHES == before
    assert x.shape == (3, 6, 13) and u.shape == (3, 6, 3) and torch.isfinite(costs).all()
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.MPC(13, 3, 6, u_lower=dyn.lower, u_upper=dyn.upper, backprop=False,
              backend="cuda")(x0, P.QuadCost(torch.diag(q), p), dyn, params=params)
