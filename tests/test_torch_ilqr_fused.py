"""The plain version of the whole-solve kernel (ops/cuda/ilqr_fused.
ilqr_fused_reference) against the JAX package's Pallas kernel run in
interpret mode (backend="pallas" on the CPU, as tests/test_pallas_kernels.py
runs it) -- cartpole and pendulum through the closed-form 1-D box-QP, the
rocket through the in-kernel projected-Newton box-QP with the rocket's +-20
box and with tight per-control bounds -- plus the kernel's per-tile
grouping and its dispatch rule. The CUDA kernel itself is held against the
same plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances are those of tests/test_pallas_kernels.py:79-84 (f32): u 2e-3,
x 5e-3, costs 1e-5, n_iter equal. The seeds are ones whose examples do not
reach the point where a converged example's line search accepts or rejects
a step on a one-ulp cost difference: there the two implementations round
the cost sum differently and an example's u may move by a step (~3e-3 on the
pendulum) while its cost agrees to 1e-7 -- pendulum seeds 0 and 2 do this
at B=6, T=8, and cartpole seeds 0 and 1 come within 1.2e-3 of the u bound
(measured); the seeds used here agree to 2e-4 in u. The rocket's start
(bench.py's, near hover) meets the same effect at seeds 0 and 2 for B=4
(u off by up to 1.8e-3, n_iter by one at eps=1e-3); seed 1 agrees to 3e-7."""
import dataclasses

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
from dilqr_tpu_torch.models import cartpole as tcart
from dilqr_tpu_torch.models import pendulum as tpend
from dilqr_tpu_torch.models import rocket as trock
from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused
from rocket_bench_start import bench_start

ENVS = {"cartpole": (jcart, tcart, 2), "pendulum": (jpend, tpend, 1)}


def _x0(name, B, seed):
    rng = np.random.RandomState(seed)
    th = rng.uniform(-2, 2, B).astype(np.float32)
    z = np.zeros(B, np.float32)
    if name == "pendulum":
        return np.stack([np.cos(th), np.sin(th), z], 1)
    return np.stack([z, z, np.cos(th), np.sin(th), z], 1)


def _cfg_kw(dyn, T, lqr_iter, eps):
    return dict(n_state=dyn.n_state, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=eps,
                linesearch_decay=dyn.linesearch_decay,
                max_linesearch_iter=dyn.max_linesearch_iter,
                exit_unconverged=False, detach_unconverged=False, backprop=False)


def _compare(jres, out):
    x, u, costs, _, n_iter = out
    np.testing.assert_allclose(u.transpose(0, 1).numpy(), np.asarray(jres.u), atol=2e-3)
    np.testing.assert_allclose(x.transpose(0, 1).numpy(), np.asarray(jres.x), atol=5e-3)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jres.costs), atol=1e-5, rtol=1e-5)
    assert int(n_iter) == int(jres.n_iter)


@pytest.mark.parametrize("eps", [0.0, 1e-3])
@pytest.mark.parametrize("name", list(ENVS))
def test_reference_matches_jax_kernel(name, eps):
    jm, tm, seed = ENVS[name]
    jdyn, tdyn = jm.make(), tm.make()
    params = np.asarray(jm.default_params())
    q, p = (np.asarray(a) for a in jm.get_true_obj())
    x0 = _x0(name, 6, seed)
    kw = _cfg_kw(jdyn, 8, 6, eps)
    jres = J.solve(J.ILQRConfig(backend="pallas", **kw), jnp.asarray(x0),
                   J.QuadCost(jnp.diag(q), jnp.asarray(p)), jdyn, params=jnp.asarray(params),
                   u_lower=jdyn.lower, u_upper=jdyn.upper)
    out = fused.ilqr_fused_reference(
        P.ILQRConfig(**kw), tdyn, from_numpy(params), from_numpy(x0),
        (torch.diag(from_numpy(q)), from_numpy(p)), None, tdyn.lower, tdyn.upper)
    _compare(jres, out)


@pytest.mark.parametrize("eps", [0.0, 1e-3])
@pytest.mark.parametrize("bounds", ["box", "tight"])
def test_rocket_reference_matches_jax_kernel(bounds, eps):
    """The rocket (nx=13, nu=3) through the box-QP variant: the +-20 box,
    which no control reaches from this start, and tight per-control bounds
    +-(0.3, 0.05, 0.05), where about half the controls end at a bound."""
    jdyn, tdyn = jrock.make(), trock.make()
    params = np.asarray(jrock.default_params())
    q, p = (np.asarray(a) for a in jrock.get_true_obj())
    B = 4
    x0 = bench_start(B, 1)
    hi = np.asarray(jdyn.upper) if bounds == "box" else np.array([0.3, 0.05, 0.05], np.float32)
    kw = dict(n_state=13, n_ctrl=3, T=6, lqr_iter=4, eps=eps,
              linesearch_decay=jdyn.linesearch_decay, max_linesearch_iter=jdyn.max_linesearch_iter,
              exit_unconverged=False, detach_unconverged=False, backprop=False)
    jres = J.solve(J.ILQRConfig(backend="pallas", **kw), jnp.asarray(x0),
                   J.QuadCost(jnp.diag(q), jnp.asarray(p)), jdyn, params=jnp.asarray(params),
                   u_lower=jnp.asarray(-hi), u_upper=jnp.asarray(hi))
    out = fused.ilqr_fused_reference(
        P.ILQRConfig(**kw), tdyn, from_numpy(params), from_numpy(x0),
        (torch.diag(from_numpy(q)), from_numpy(p)), None, from_numpy(-hi), from_numpy(hi))
    _compare(jres, out)
    at_bound = (np.abs(np.abs(np.asarray(jres.u)) - hi) < 1e-6).mean()
    assert at_bound == 0.0 if bounds == "box" else at_bound > 0.4


def test_reference_warm_start_and_per_time_cost():
    """A warm-started u_init and a per-timestep [T,n,n] cost, the case of
    tests/test_pallas_kernels.py:125."""
    jdyn, tdyn = jpend.make(), tpend.make()
    params = np.asarray(jpend.default_params())
    q, p = (np.asarray(a) for a in jpend.get_true_obj())
    B, T = 4, 6
    rng = np.random.RandomState(1)
    th = rng.uniform(-2, 2, B).astype(np.float32)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B, np.float32)], 1)
    scale = np.linspace(0.5, 2.0, T, dtype=np.float32)[:, None]
    C_t = np.stack([np.diag(s * q) for s in scale]).astype(np.float32)
    p_t = np.broadcast_to(p, (T, 4)).astype(np.float32)
    u0 = (0.1 * rng.randn(B, T, 1)).astype(np.float32)
    kw = _cfg_kw(jdyn, T, 4, 0.0)
    jres = J.solve(J.ILQRConfig(backend="pallas", **kw), jnp.asarray(x0),
                   J.QuadCost(jnp.asarray(C_t), jnp.asarray(p_t)), jdyn,
                   params=jnp.asarray(params), u_lower=jdyn.lower, u_upper=jdyn.upper,
                   u_init=jnp.asarray(u0))
    out = fused.ilqr_fused_reference(
        P.ILQRConfig(**kw), tdyn, from_numpy(params), from_numpy(x0),
        from_numpy((C_t, p_t)), from_numpy(u0).transpose(0, 1), tdyn.lower, tdyn.upper)
    _compare(jres, out)


def test_reference_decides_per_1024_tile():
    """Tiles are independent: each 1024-example tile of a ragged batch
    (zero-padded to 3 tiles) gives what it gives solved alone, the tiles
    stop at different iterations at eps > 0, and n_iter is their maximum --
    the JAX kernel's grouping (ilqr_fused.py:35-47)."""
    tdyn = tpend.make()
    params = tpend.default_params()
    q, p = tpend.get_true_obj()
    rng = np.random.RandomState(0)
    th = np.concatenate([rng.uniform(-0.3, 0.3, 1024), rng.uniform(2.5, 3.1, 1024),
                         rng.uniform(-2, 2, 6)]).astype(np.float32)
    x0 = torch.from_numpy(np.stack([np.cos(th), np.sin(th), np.zeros_like(th)], 1))
    cfg = P.ILQRConfig(**_cfg_kw(tdyn, 6, 8, 1e-3))
    args = ((torch.diag(q), p), None, tdyn.lower, tdyn.upper)
    whole = fused.ilqr_fused_reference(cfg, tdyn, params, x0, *args)
    iters = []
    for g in range(3):
        sl = slice(1024 * g, min(1024 * (g + 1), x0.shape[0]))
        alone = fused.ilqr_fused_reference(cfg, tdyn, params, x0[sl], *args)
        for a, w in zip(alone[:4], whole[:4]):
            dim = 1 if a.dim() == 3 else 0
            np.testing.assert_allclose(a.numpy(), w.narrow(dim, sl.start, sl.stop - sl.start).numpy(),
                                       atol=1e-6, rtol=0)
        iters.append(int(alone[4]))
    assert len(set(iters)) > 1, iters
    assert int(whole[4]) == max(iters)


def test_cpu_tensors_take_the_plain_version():
    """ilqr_fused on CPU tensors is ilqr_fused_reference and launches
    nothing; the dispatch admits the covered configuration only."""
    tdyn = tcart.make()
    params = tcart.default_params()
    q, p = tcart.get_true_obj()
    x0 = torch.from_numpy(_x0("cartpole", 5, 0))
    cfg = P.ILQRConfig(**_cfg_kw(tdyn, 6, 3, 1e-4))
    before = fused.LAUNCHES
    a = fused.ilqr_fused(cfg, tdyn, params, x0, (torch.diag(q), p), None, -100.0, 100.0)
    b = fused.ilqr_fused_reference(cfg, tdyn, params, x0, (torch.diag(q), p), None, -100.0, 100.0)
    assert fused.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)

    def cov(cfg=cfg, dyn=tdyn, params=params, dtype=torch.float32,
            cost_small=(torch.diag(q), p), lo=-100.0, hi=100.0, uz=None, du=None):
        return fused.covered(cfg, dyn, params, dtype, cost_small, uz, du, lo, hi)

    assert cov()
    assert cov(lo=None, hi=None) and cov(lo=torch.tensor([-1.0]), hi=torch.tensor([1.0]))
    assert not cov(dtype=torch.float64)
    # the MPC variants: a per-example cost, per-step bounds, a mask, delta_u
    assert cov(cost_small=None)
    assert cov(lo=torch.zeros(6, 5, 1), hi=torch.ones(6, 5, 1))
    assert cov(uz=torch.zeros(6, 5, 1, dtype=torch.bool)) and cov(du=0.4)
    assert cov(du=torch.tensor(0.4)) and not cov(du=torch.tensor([0.4]))
    assert not cov(lo=torch.zeros(7, 5, 1), hi=torch.ones(7, 5, 1))  # another T
    assert not cov(cfg=dataclasses.replace(cfg, qp_solver="pnqp"))
    # the jvp sweep: AUTO_DIFF, and the complex pendulum (no hand Jacobian)
    assert cov(cfg=dataclasses.replace(cfg, grad_method=P.GradMethod.AUTO_DIFF))
    assert cov(dyn=tpend.make(simple=False), params=tpend.default_params(simple=False),
               cfg=dataclasses.replace(cfg, n_state=3))
    assert not cov(cfg=dataclasses.replace(cfg, grad_method=P.GradMethod.FINITE_DIFF))
    assert cov(dyn=tpend.make(), params=tpend.default_params(),
               cfg=dataclasses.replace(cfg, n_state=3))


@pytest.mark.parametrize("B,cluster,want", [
    (1030, 0, (2048, 2, 8, 128, 16)),      # ragged: padded to 2 tiles, the default G
    (1030, 16, (2048, 2, 16, 64, 32)),
    (4096, 8, (4096, 4, 8, 128, 32)),
    (1024, 0, (1024, 1, 8, 128, 8)),
    (135168, 16, (135168, 132, 16, 64, 2112)),
])
def test_launch_geometry(B, cluster, want):
    """One 1024-example tile is one cluster of G blocks of 1024/G threads."""
    assert tuple(fused.geometry(B, cluster)) == want


@pytest.mark.parametrize("cluster", [2, 4, 32, 1024])
def test_launch_geometry_refuses_uninstantiated_clusters(cluster):
    """Cluster sizes the kernel has no instantiation for raise before a
    launch (the rocket's shared memory caps a block at 128 examples)."""
    with pytest.raises(ValueError, match="clusters"):
        fused.geometry(1024, cluster)
