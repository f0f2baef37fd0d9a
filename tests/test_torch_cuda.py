"""The CUDA kernels of the port against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc: they carry the ``cuda`` marker
and skip elsewhere. They import neither JAX nor the JAX package, so they
run without this directory's conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (f32): costs rtol 1e-4 and n_iter equal; u 2e-2 and x 1e-2, the
loose on-device bound of docs/DESIGN.md:103-107 (u moves by about 1e-2 at
bang-bang switching points between two equally converged optima); the
Riccati kernel within 2e-6 + 1e-5 max|plain| of its plain version (JAX's
2e-6 plus FMA contraction over a 20-step recursion)."""
import collections
import dataclasses
import os

import pytest
import torch

import dilqr_tpu_torch as P
from dilqr_tpu_torch.models import cartpole, nn_dynamics, pendulum, rocket
from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused
from dilqr_tpu_torch.ops.cuda import kkt_fused, riccati_fused
from dilqr_tpu_torch.tools.rounding_witness import distances
from rocket_bench_start import bench_start

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see the module docstring)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("env", ["cartpole", "pendulum"])
def test_kernel_matches_plain_version(dev, env):
    mod = {"cartpole": cartpole, "pendulum": pendulum}[env]
    dyn, params = mod.make(), mod.default_params(device=dev)
    q, p = mod.get_true_obj(device=dev)
    gen = torch.Generator().manual_seed(1)
    B, T = 1030, 12
    th = 0.5 * torch.randn(B, generator=gen) + (3.0 if env == "cartpole" else 0.0)
    z = torch.zeros(B)
    x0 = (torch.stack([z, z, th.cos(), th.sin(), z], 1) if env == "cartpole"
          else torch.stack([th.cos(), th.sin(), z], 1)).to(dev)
    cfg = P.ILQRConfig(n_state=dyn.n_state, n_ctrl=1, T=T, lqr_iter=8, eps=1e-3,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter, backprop=False)
    args = (cfg, dyn, params, x0, (torch.diag(q), p), None, dyn.lower, dyn.upper)
    before = fused.LAUNCHES
    kx, ku, kc, _, kn = fused.ilqr_fused(*args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    rx, ru, rc, _, rn = fused.ilqr_fused_reference(*args)
    assert int(kn) == int(rn)
    torch.testing.assert_close(kc, rc, rtol=1e-4, atol=1e-5)
    assert (ku - ru).abs().max().item() <= 2e-2
    assert (kx - rx).abs().max().item() <= 1e-2


@pytest.mark.parametrize("bounds", ["box", "tight"])
def test_rocket_kernel_matches_plain_version(dev, bounds):
    """The rocket (nu=3, the in-kernel box-QP) on a ragged 2-tile batch at
    the bench configuration, with the +-20 box and with bounds +-(8, 0.1,
    0.1) where every control sits at a bound in a fifth or more of its
    entries; the tolerances above, and on the examples that converged in
    both versions (du < eps), whose u the problem sets, u within 2e-3 and
    the active sets (|u - bound| < 1e-6) equal but for 1e-3 of each
    control's entries."""
    dyn, params = rocket.make(), rocket.default_params(device=dev)
    q, p = rocket.get_true_obj(device=dev)
    B, T = 1030, 20
    x0 = torch.from_numpy(bench_start(B, 3)).to(dev)
    hi = dyn.upper if bounds == "box" else torch.tensor([8.0, 0.1, 0.1])
    hi = hi.to(dev)
    cfg = P.ILQRConfig(n_state=13, n_ctrl=3, T=T, lqr_iter=15, eps=1e-3,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter, backprop=False)
    args = (cfg, dyn, params, x0, (torch.diag(q), p), None, -hi, hi)
    before = fused.LAUNCHES
    k_out = fused.ilqr_fused(*args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    r_out = fused.ilqr_fused_reference(*args)
    assert int(k_out[4]) == int(r_out[4])
    torch.testing.assert_close(k_out[2], r_out[2], rtol=1e-4, atol=1e-5)
    assert (k_out[1] - r_out[1]).abs().max().item() <= 2e-2
    assert (k_out[0] - r_out[0]).abs().max().item() <= 1e-2
    d = distances(k_out, r_out, -hi, hi, cfg.eps)
    assert d["converged"] > B // 2 and max(d["u_max_converged"]) <= 2e-3, d
    assert max(d["active_mismatch"]) <= 1e-3 * T * B, d
    if bounds == "tight":
        assert min(d["active_share"]) > 0.2, d


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("env", ["cartpole", "pendulum"])
def test_kernel_result_does_not_depend_on_the_cluster(dev, env):
    """Clusters of 8 and 16 blocks give the same bits of x, u, costs, du
    and n_iter at eps > 0 on a three-tile batch whose tiles stop at
    different iterations (each tile's votes do the work), and each agrees
    with the plain version at test_kernel_matches_plain_version's
    tolerances."""
    mod = {"cartpole": cartpole, "pendulum": pendulum}[env]
    dyn, params = mod.make(), mod.default_params(device=dev)
    q, p = mod.get_true_obj(device=dev)
    gen = torch.Generator().manual_seed(3)
    # tile 0 near (cartpole: at) the goal, tile 1 swing-ups, tile 2 ragged
    near = 0.3 * torch.randn(1024, generator=gen) if env == "pendulum" else torch.zeros(1024)
    th = torch.cat([near, 2.8 + 0.3 * torch.rand(1024, generator=gen),
                    4.0 * torch.rand(6, generator=gen) - 2.0])
    z = torch.zeros_like(th)
    x0 = (torch.stack([z, z, th.cos(), th.sin(), z], 1) if env == "cartpole"
          else torch.stack([th.cos(), th.sin(), z], 1)).to(dev)
    cfg = P.ILQRConfig(n_state=dyn.n_state, n_ctrl=1, T=12, lqr_iter=10, eps=1e-3,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter, backprop=False)
    args = (cfg, dyn, params, x0, (torch.diag(q), p), None, dyn.lower, dyn.upper)
    outs, iters = {}, {}
    for G in fused.CLUSTERS:
        outs[G], stats, _ = fused.ilqr_fused_probe(*args, cluster=G)
        iters[G] = stats[:, 0].tolist()
    assert all(_same_bits(outs[G], outs[8]) for G in outs), iters
    r = fused.ilqr_fused_reference(*args)
    assert int(outs[8][4]) == int(r[4])
    torch.testing.assert_close(outs[8][2], r[2], rtol=1e-4, atol=1e-5)
    assert (outs[8][1] - r[1]).abs().max().item() <= 2e-2
    assert (outs[8][0] - r[0]).abs().max().item() <= 1e-2
    # the tiles took different numbers of votes: they stopped apart
    assert len(set(iters[8])) > 1, iters


def test_rocket_result_does_not_depend_on_the_cluster(dev):
    """The rocket at bounds +-(8, 0.1, 0.1), where the box-QP's Newton and
    Armijo votes decide: clusters of 8 and 16 blocks (128 and 64 examples a
    block in shared memory) give the same bits, and agree with the plain
    version as test_rocket_kernel_matches_plain_version holds it."""
    dyn, params = rocket.make(), rocket.default_params(device=dev)
    q, p = rocket.get_true_obj(device=dev)
    B, T = 1030, 20
    x0 = torch.from_numpy(bench_start(B, 6)).to(dev)
    hi = torch.tensor([8.0, 0.1, 0.1], device=dev)
    cfg = P.ILQRConfig(n_state=13, n_ctrl=3, T=T, lqr_iter=15, eps=1e-3,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter, backprop=False)
    args = (cfg, dyn, params, x0, (torch.diag(q), p), None, -hi, hi)
    outs, stats = {}, {}
    for G in fused.CLUSTERS:
        outs[G], stats[G], _ = fused.ilqr_fused_probe(*args, cluster=G)
    assert _same_bits(outs[8], outs[16])
    assert torch.equal(stats[8][:, 0], stats[16][:, 0])  # the same votes
    # the box-QP votes inside every Riccati step: more than T votes a tile
    assert stats[8][:, 0].min().item() > cfg.T
    r = fused.ilqr_fused_reference(*args)
    k = outs[8]
    assert int(k[4]) == int(r[4])
    torch.testing.assert_close(k[2], r[2], rtol=1e-4, atol=1e-5)
    assert (k[1] - r[1]).abs().max().item() <= 2e-2
    d = distances(k, r, -hi, hi, cfg.eps)
    assert d["converged"] > B // 2 and max(d["u_max_converged"]) <= 2e-3, d
    assert max(d["active_mismatch"]) <= 1e-3 * T * B, d
    assert min(d["active_share"]) > 0.2, d


def test_rocket_fleet_runs_in_one_wave(dev):
    """Two blocks of 128 rockets share an SM (the split layout: F in device
    memory, Quu in registers, 221 shared floats an example): the card holds
    at least 16 rocket tiles at G = 8 at once, the hand Jacobian's library
    (env 2) and the renormalizing rocket's jvp library (env 7) alike, so a
    16,384-rocket launch runs in one wave, where one block an SM (15
    clusters) took two; the 131,072-example cartpole launch takes two (128
    tiles over its 77)."""
    for env in (2, 7):
        info = fused.kernel_info(env, 8)
        assert info["max_active_clusters"] >= 16, (env, info)
        assert info["dynamic_smem"] == 4 * fused.box_layout(13, 3).floats * 128, (env, info)
    dyn, params = rocket.make(), rocket.default_params(device=dev)
    q, p = rocket.get_true_obj(device=dev)
    cfg = P.ILQRConfig(n_state=13, n_ctrl=3, T=5, lqr_iter=2, eps=1e-3, backprop=False)
    x0 = torch.from_numpy(bench_start(16384, 8)).to(dev)
    fused.ilqr_fused(cfg, dyn, params, x0, (torch.diag(q), p), None, dyn.lower, dyn.upper)
    assert fused.WAVES == 1
    cdyn, cparams = cartpole.make(), cartpole.default_params(device=dev)
    cq, cp = cartpole.get_true_obj(device=dev)
    ccfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=5, lqr_iter=2, eps=1e-4, backprop=False)
    xc = torch.zeros(131072, 5, device=dev)
    xc[:, 2] = -1.0
    fused.ilqr_fused(ccfg, cdyn, cparams, xc, (torch.diag(cq), cp), None, -100.0, 100.0)
    assert fused.WAVES == 2


def test_cluster_launch_geometry(dev):
    """An uninstantiated cluster size raises before any launch; a launch
    spreads each tile over its cluster's blocks (every block reports an
    SM); the card can hold at least one cluster of each instantiation, and
    none uses local memory."""
    dyn, params = cartpole.make(), cartpole.default_params(device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    x0 = torch.zeros(4096, 5, device=dev)
    x0[:, 2] = -1.0
    cfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=10, lqr_iter=3, eps=1e-4, backprop=False)
    args = (cfg, dyn, params, x0, (torch.diag(q), p), None, -100.0, 100.0)
    before = fused.LAUNCHES
    with pytest.raises(ValueError, match="clusters"):
        fused.ilqr_fused(*args, cluster=32)
    assert fused.LAUNCHES == before
    _, _, smids = fused.ilqr_fused_probe(*args)
    assert fused.LAUNCHES == before + 1
    assert smids.shape == (32,) and smids.min().item() >= 0
    for env in (0, 1, 2):
        for G in fused.CLUSTERS:
            info = fused.kernel_info(env, G)
            assert info["max_active_clusters"] >= 1, (env, info)
            assert info["local_bytes"] == 0, (env, info)


def test_rocket_solve_dispatches_to_the_kernel(dev):
    """MPC with the rocket's [3] bounds and a warm start goes through the
    kernel once; backend="cuda" refuses the uncovered qp_solver "pnqp"."""
    dyn, params = rocket.make(), rocket.default_params(device=dev)
    q, p = rocket.get_true_obj(device=dev)
    x0 = torch.from_numpy(bench_start(1024, 4)).to(dev)
    mpc = P.MPC(13, 3, 10, u_lower=dyn.lower, u_upper=dyn.upper, lqr_iter=5, eps=1e-3,
                linesearch_decay=0.2, max_linesearch_iter=5, backprop=False,
                exit_unconverged=False)
    before = fused.LAUNCHES
    x, u, costs = mpc(x0, P.QuadCost(torch.diag(q), p), dyn, params=params,
                      u_init=0.1 * torch.ones(10, 3, device=dev))
    assert fused.LAUNCHES == before + 1
    assert u.shape == (1024, 10, 3) and u.is_cuda and torch.isfinite(costs).all()
    bad = P.MPC(13, 3, 10, u_lower=dyn.lower, u_upper=dyn.upper, backprop=False, backend="cuda")
    bad.cfg = dataclasses.replace(bad.cfg, qp_solver="pnqp")
    with pytest.raises(ValueError, match="not covered"):
        bad(x0, P.QuadCost(torch.diag(q), p), dyn, params=params)


def test_solve_dispatches_to_the_kernel(dev):
    dyn, params = cartpole.make(), cartpole.default_params(device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    x0 = torch.zeros(2048, 5, device=dev)
    x0[:, 2] = -1.0
    before = fused.LAUNCHES
    res = P.MPC(5, 1, 10, u_lower=-100.0, u_upper=100.0, lqr_iter=5, eps=1e-4,
                backprop=False, exit_unconverged=False)(x0, P.QuadCost(torch.diag(q), p),
                                                        dyn, params=params)
    assert fused.LAUNCHES == before + 1
    assert res[0].is_cuda and torch.isfinite(res[2]).all()
    # the plain loop stays on the card: backend="torch" launches nothing
    mpc = P.MPC(5, 1, 10, u_lower=-100.0, u_upper=100.0, lqr_iter=2, eps=1e-4,
                backprop=False, exit_unconverged=False, backend="torch")
    out = mpc(x0[:8], P.QuadCost(torch.diag(q), p), dyn, params=params)
    assert fused.LAUNCHES == before + 1 and out[0].is_cuda


VARIANTS = ("per-example cost", "per-time bounds", "u_zero_I boxed", "u_zero_I unboxed",
            "delta_u")


def _variant_problem(dev, env, variant, B=1030, T=12):
    """(cfg, dyn, params, x0, cost, lo, hi, kw) of one MPC variant: a
    per-example cost (weights in [1, 1.5]), per-time and per-example bounds
    that bind, a mask over about 35% of the controls with the box or
    without it, delta_u 0.2; eps=0 and 4 iterations."""
    mod = {"cartpole": cartpole, "pendulum": pendulum, "rocket": rocket}[env]
    dyn, params = mod.make(), mod.default_params(device=dev)
    q, p = mod.get_true_obj(device=dev)
    gen = torch.Generator().manual_seed(7)
    nx, nu = dyn.n_state, dyn.n_ctrl
    if env == "rocket":
        x0 = torch.from_numpy(bench_start(B, 6)).to(dev)
    else:
        th = 0.5 * torch.randn(B, generator=gen) + (3.0 if env == "cartpole" else 0.0)
        z = torch.zeros(B)
        x0 = (torch.stack([z, z, th.cos(), th.sin(), z], 1) if env == "cartpole"
              else torch.stack([th.cos(), th.sin(), z], 1)).to(dev)
    cfg = P.ILQRConfig(n_state=nx, n_ctrl=nu, T=T, lqr_iter=4, eps=0.0,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter, backprop=False)
    cost, lo, hi, kw = (torch.diag(q), p), dyn.lower, dyn.upper, {}
    if variant == "per-example cost":
        w = (1.0 + 0.5 * torch.rand(T, B, 1, generator=gen)).to(dev)
        n = nx + nu
        cost = ((torch.diag(q).expand(T, B, n, n) * w[..., None]).contiguous(),
                (p.expand(T, B, n) * w).contiguous())
    elif variant == "per-time bounds":
        r = torch.rand(T, B, nu, generator=gen).to(dev)
        hi = (torch.tensor([8.0, 0.05, 0.05], device=dev) + r * torch.tensor(
            [2.0, 0.1, 0.1], device=dev)) if nu == 3 else 0.1 + 0.5 * r
        lo = -hi
    elif variant.startswith("u_zero_I"):
        kw["u_zero_I"] = (torch.rand(T, B, nu, generator=gen) < 0.35).to(dev)
        if variant.endswith("unboxed"):
            lo = hi = None
    else:
        kw["delta_u"] = 0.2
    return cfg, dyn, params, x0, cost, lo, hi, kw


def _assert_variant(k, r, cfg):
    assert int(k[4]) == int(r[4])
    torch.testing.assert_close(k[2], r[2], rtol=1e-4, atol=1e-5)
    assert (k[1] - r[1]).abs().max().item() <= 2e-2
    assert (k[0] - r[0]).abs().max().item() <= 1e-2


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("env", ["cartpole", "rocket"])
def test_kernel_variants_match_plain_version(dev, env, variant):
    """The whole-solve kernel's MPC variants against the plain version on
    the same CUDA inputs (B=1030: two tiles, the second ragged), one launch
    each, the masked u exactly 0, and the same bits at every cluster size;
    eps=0 and 4 iterations, short of the f32 forks of a converged line
    search (ROADMAP C)."""
    cfg, dyn, params, x0, cost, lo, hi, kw = _variant_problem(dev, env, variant)
    before = fused.LAUNCHES
    k = fused.ilqr_fused(cfg, dyn, params, x0, cost, None, lo, hi, **kw)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    r = fused.ilqr_fused_reference(cfg, dyn, params, x0, cost, None, lo, hi, **kw)
    _assert_variant(k, r, cfg)
    if "u_zero_I" in kw:
        assert k[1][kw["u_zero_I"]].abs().max().item() == 0.0
    for G in fused.clusters(dyn.device_env):
        out = fused.ilqr_fused(cfg, dyn, params, x0, cost, None, lo, hi, **kw, cluster=G)
        assert all(torch.equal(a, b) for a, b in zip(out, k)), G


@pytest.mark.parametrize("env", ["cartpole", "pendulum", "rocket"])
def test_slew_rate_kernel_matches_plain_version(dev, env):
    """The slew-rate state (Passthrough<Env>) through augment_slew_rate:
    the kernel against its plain version, at every cluster size the
    instantiation has (the rocket's: 8 and 16, its F and q in the scratch)."""
    from dilqr_tpu_torch.core.solver import augment_slew_rate, canonicalize_cost

    cfg, dyn, params, x0, cost, lo, hi, _ = _variant_problem(dev, env, "slew")
    B, T, n = x0.shape[0], cfg.T, cfg.n_state + cfg.n_ctrl
    a_cfg, a_cost, a_dyn, a_params, a_x0 = augment_slew_rate(
        dataclasses.replace(cfg, slew_rate_penalty=1.0),
        canonicalize_cost(P.QuadCost(*cost), T, B, n), dyn, params, x0, None)
    args = (a_cfg, a_dyn, a_params, a_x0, (a_cost.C, a_cost.c), None, lo, hi)
    k = fused.ilqr_fused(*args)
    r = fused.ilqr_fused_reference(*args)
    _assert_variant(k, r, a_cfg)
    for G in fused.clusters(a_dyn.device_env):
        assert all(torch.equal(a, b) for a, b in zip(fused.ilqr_fused(*args, cluster=G), k))


def test_variant_solves_launch_the_kernel(dev):
    """backend="cuda" launches the whole-solve kernel once a solve on the
    MPC variants -- the slew rate (no Riccati launch), u_zero_I with
    delta_u, a per-example cost with per-time bounds -- and still refuses
    the slew rate of the learned MLP (no device code)."""
    dyn, params = cartpole.make(), cartpole.default_params(device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    gen = torch.Generator().manual_seed(8)
    B, T = 1024, 10
    th = 3.0 + 0.2 * torch.randn(B, generator=gen)
    z = torch.zeros(B)
    x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)
    kw = dict(lqr_iter=5, eps=1e-4, backprop=False, exit_unconverged=False, backend="cuda")
    mask = (torch.rand(B, T, 1, generator=gen) < 0.35).to(dev)
    w = (1.0 + 0.5 * torch.rand(B, T, 1, generator=gen)).to(dev)
    lanes = P.QuadCost((torch.diag(q).expand(B, T, 6, 6) * w[..., None]).contiguous(),
                       (p.expand(B, T, 6) * w).contiguous())
    hi_t = (0.2 + 0.6 * torch.rand(T, 1, generator=gen)).to(dev)
    for mpc, cost in (
            (P.MPC(5, 1, T, u_lower=-100.0, u_upper=100.0, slew_rate_penalty=1.0, **kw),
             P.QuadCost(torch.diag(q), p)),
            (P.MPC(5, 1, T, u_lower=-100.0, u_upper=100.0, u_zero_I=mask, delta_u=0.4, **kw),
             P.QuadCost(torch.diag(q), p)),
            (P.MPC(5, 1, T, u_lower=-hi_t, u_upper=hi_t, **kw), lanes)):
        before, ric_before = fused.LAUNCHES, riccati_fused.LAUNCHES
        x, u, costs = mpc(x0, cost, dyn, params=params)
        torch.cuda.synchronize()
        assert fused.LAUNCHES == before + 1 and riccati_fused.LAUNCHES == ric_before
        assert u.shape == (B, T, 1) and torch.isfinite(costs).all()
    assert u.abs().max().item() <= hi_t.max().item() + 1e-6
    mlp = nn_dynamics.make(5, 1)
    ws = nn_dynamics.init_params(5, 1, (8,), generator=torch.Generator().manual_seed(0),
                                 device=dev)
    bad = P.MPC(5, 1, T, u_lower=-2.0, u_upper=2.0, slew_rate_penalty=1.0, **kw)
    with pytest.raises(ValueError, match="not covered"):
        bad(x0[:8], P.QuadCost(torch.eye(6, device=dev), torch.zeros(6, device=dev)), mlp,
            params=ws)


def _kkt_problem(dev, nx, nu, T, B, seed):
    """Operands from random SPD costs, a contracting F (the T-step
    recursions' values stay of order one), half the controls frozen; and a
    cotangent."""
    gen = torch.Generator().manual_seed(seed)
    n = nx + nu
    A = torch.randn(T, B, n, n, generator=gen)
    C = A @ A.transpose(-1, -2) + 2.0 * torch.eye(n)
    F = (0.5 / n ** 0.5) * torch.randn(T - 1, B, nx, n, generator=gen)
    ops = kkt_fused.prepare(nx, nu, *(a.to(dev) for a in (
        C, torch.randn(T, B, n, generator=gen), F, torch.randn(T, B, nx, generator=gen),
        torch.randn(T, B, nu, generator=gen), torch.rand(T, B, nu, generator=gen) < 0.5)))
    return ops, torch.randn(T, B, nx, generator=gen).to(dev), torch.randn(T, B, nu, generator=gen).to(dev)


@pytest.mark.parametrize("nx,nu,T,B", [(4, 1, 6, 1030), (4, 2, 6, 1030), (4, 3, 6, 1030),
                                       (13, 3, 20, 1030), (5, 1, 200, 1030), (3, 1, 20, 33),
                                       (6, 1, 20, 1030), (16, 1, 20, 1030), (15, 2, 20, 1030),
                                       (14, 3, 20, 33)])
def test_kkt_kernel_matches_plain_version(dev, nx, nu, T, B):
    """The KKT-VJP kernel's whole call (one launch: the recursions and the
    dF/df/dC assembly) against kkt_fused_reference on the same operands, in
    full and "Ff" mode; per output max|kernel - plain| <= 1e-4 max|plain| +
    1e-5 (f32 recursions, FMA contraction). The shapes JAX's gate admits at
    its edges, ragged batches, and T=200, whose K/k/dtau outgrow shared
    memory."""
    ops, gx, gu = _kkt_problem(dev, nx, nu, T, B, nx * 100 + nu * 10 + T)
    for full in (True, False):
        before = kkt_fused.LAUNCHES
        got = kkt_fused.kkt_fused(ops, gx, gu, full)
        torch.cuda.synchronize()
        assert kkt_fused.LAUNCHES == before + 1
        want = kkt_fused.kkt_fused_reference(ops, gx, gu, full)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            assert torch.isfinite(g).all()
            assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5


@pytest.mark.parametrize("nx,nu", [(5, 1), (13, 3)])
def test_kkt_kernel_bits_do_not_depend_on_the_launch(dev, nx, nu):
    """Blocks of 64, 128 and 256 threads (2 to 64 teams a block), and K/k/
    dtau in the global store instead of shared memory, give the bits of
    the default launch: each example's arithmetic depends on its team size
    alone."""
    ops, gx, gu = _kkt_problem(dev, nx, nu, 20, 1030, 7 + nx)
    ref = kkt_fused.kkt_fused(ops, gx, gu, True)
    assert not kkt_fused.plan(ops)["global"]
    for block in kkt_fused.BLOCKS:
        for store in ("auto", "global"):
            out = kkt_fused.kkt_fused(ops, gx, gu, True, block=block, store=store)
            assert all(torch.equal(a, b) for a, b in zip(out, ref)), (block, store)


def test_slew_rate_ift_gradient_launches_the_kkt_kernel(dev):
    """The slew-rate cartpole (n_state 6, n_ctrl 1): its IFT backward now
    goes through the KKT kernel at (6,1) and agrees with the plain
    backward (backward_backend="torch", no KKT launch) on the same forward
    solution, max-norm rtol 1e-3 (f32 recursions; GMRES may stop one
    iteration apart)."""
    dyn, params = cartpole.make(), cartpole.default_params(device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    gen = torch.Generator().manual_seed(4)
    th = 3.0 + 0.1 * torch.randn(256, generator=gen)
    z = torch.zeros(256)
    x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)
    grads = {}
    for bb in ("auto", "torch"):
        cfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=20, lqr_iter=10, eps=1e-4,
                           linesearch_decay=0.5, max_linesearch_iter=2, exit_unconverged=False,
                           detach_unconverged=False, backward_mode=P.BackwardMode.IFT,
                           slew_rate_penalty=1.0, backward_backend=bb)
        pr = params.clone().requires_grad_(True)
        before = kkt_fused.LAUNCHES
        res = P.solve(cfg, x0, P.QuadCost(torch.diag(q), p), dyn, params=pr,
                      u_lower=-100.0, u_upper=100.0)
        (grads[bb],) = torch.autograd.grad((res.u ** 2).mean(), pr)
        torch.cuda.synchronize()
        assert (kkt_fused.LAUNCHES > before) == (bb == "auto")
    assert torch.isfinite(grads["auto"]).all() and grads["auto"].abs().max().item() > 0.0
    torch.testing.assert_close(grads["auto"], grads["torch"], rtol=1e-3,
                               atol=1e-3 * grads["torch"].abs().max().item())


@pytest.mark.parametrize("mode", ["IFT", "KKT"])
def test_gradient_through_both_kernels(dev, mode):
    """An IFT / KKT gradient of a cartpole solve goes through both kernels
    and agrees with the plain KKT recursions on the same forward solution
    (rtol 1e-3: f32 recursions; GMRES may stop one iteration apart)."""
    dyn, params = cartpole.make(), cartpole.default_params(device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    gen = torch.Generator().manual_seed(2)
    B = 1024
    th = 3.0 + 0.1 * torch.randn(B, generator=gen)
    z = torch.zeros(B)
    x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)
    grads = {}
    for bb in ("auto", "torch"):
        cfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=20, lqr_iter=20, eps=1e-4,
                           linesearch_decay=0.5, max_linesearch_iter=2, exit_unconverged=False,
                           detach_unconverged=False, backward_mode=P.BackwardMode[mode],
                           backward_backend=bb)
        pr = params.clone().requires_grad_(True)
        before = (fused.LAUNCHES, kkt_fused.LAUNCHES)
        res = P.solve(cfg, x0, P.QuadCost(torch.diag(q), p), dyn, params=pr,
                      u_lower=-100.0, u_upper=100.0)
        (grads[bb],) = torch.autograd.grad((res.u ** 2).mean(), pr)
        torch.cuda.synchronize()
        assert fused.LAUNCHES == before[0] + 1
        assert (kkt_fused.LAUNCHES > before[1]) == (bb == "auto")
    torch.testing.assert_close(grads["auto"], grads["torch"], rtol=1e-3, atol=1e-6)


def _riccati_problem(gen, T, B, nx, dev):
    """tests/test_pallas_kernels.py:15-23's random symmetric problems, with
    the control iterate at unit scale: about a third of the box gains at a
    bound. F's scale falls as 1/sqrt(n_state) past 8 states, so that V stays
    of order one over the horizon."""
    n = nx + 1
    A = torch.randn(T, B, n, n, generator=gen)
    C = A @ A.transpose(-1, -2) + 2.0 * torch.eye(n)
    f_scale = 0.3 / max(1.0, (nx / 8) ** 0.5)
    parts = (C, torch.randn(T, B, n, generator=gen),
             f_scale * torch.randn(T - 1, B, nx, n, generator=gen),
             torch.randn(T, B, 1, generator=gen), torch.rand(T, B, 1, generator=gen) < 0.3)
    return [a.to(dev) for a in parts]


RICCATI_MODES = {"free": {}, "box": dict(u_lower=-1.0, u_upper=1.0), "zero": None,
                 "delta_u": dict(u_lower=-1.0, u_upper=1.0, delta_u=0.2)}


def _riccati_kw(mode, uz):
    return {"u_zero_I": uz} if mode == "zero" else RICCATI_MODES[mode]


def _riccati_close(got, want, label=""):
    for g, w in zip(got, want):
        assert torch.isfinite(g).all(), label
        err = (g - w).abs().max().item()
        assert err <= 2e-6 + 1e-5 * w.abs().max().item(), (label, err)


@pytest.mark.parametrize("mode", list(RICCATI_MODES))
@pytest.mark.parametrize("nx", list(range(1, 10)) + [12, 16, 24, 31, 48])
def test_riccati_kernel_matches_plain_version(dev, nx, mode):
    """The Riccati kernel against riccati_fused_reference on a ragged batch:
    max|kernel - plain| <= 2e-6 + 1e-5 max|plain| on K and k (JAX's 2e-6,
    plus FMA contraction over T=20 steps), more than 10% of the box gains at
    a bound; n_state 1..9, 12, 16, 24, 31 (lane teams of 4 to 32) and 48
    (the looped form)."""
    gen = torch.Generator().manual_seed(10 * nx + len(mode))
    C, c, F, u, uz = _riccati_problem(gen, 20, 1030, nx, dev)
    kw = _riccati_kw(mode, uz)
    before = riccati_fused.LAUNCHES
    K, k = riccati_fused.riccati_fused(nx, C, c, F, u, **kw)
    torch.cuda.synchronize()
    assert riccati_fused.LAUNCHES == before + 1
    _riccati_close((K, k), riccati_fused.riccati_fused_reference(nx, C, c, F, u, **kw))
    if "u_lower" in kw:
        _, lb, ub = riccati_fused._operands(C, u, -1.0, 1.0, None, kw.get("delta_u"))
        at = ((k[..., 0] - lb).abs() <= 1e-6) | ((k[..., 0] - ub).abs() <= 1e-6)
        assert at.float().mean().item() > 0.1


@pytest.mark.parametrize("form", ["C expanded", "C transposed view", "bound tensor", "T=1",
                                  "T=2"])
def test_riccati_kernel_input_forms(dev, form):
    """The inputs as the callers hand them: C expanded from one matrix (T
    and B strides 0, read once a block), C a [B,T]-major view transposed to
    [T,B] (core/solver.py), a [T,B,1] lower bound tensor beside a number,
    and the shortest horizons (T=1 has no F), in box mode with delta_u and
    in zero mode, at n_state 5 and 12, B=1030."""
    for nx in (5, 12):
        T = {"T=1": 1, "T=2": 2}.get(form, 20)
        gen = torch.Generator().manual_seed(nx + len(form))
        C, c, F, u, uz = _riccati_problem(gen, T, 1030, nx, dev)
        if form == "C expanded":
            C = C[0, 0].expand_as(C)
        elif form == "C transposed view":
            C = C.transpose(0, 1).contiguous().transpose(0, 1)
        for kw in (dict(u_lower=-1.0, u_upper=1.0, delta_u=0.5), {"u_zero_I": uz}):
            if form == "bound tensor" and "u_lower" in kw:
                kw = dict(kw, u_lower=-1.0 - 0.1 * torch.rand(T, 1030, 1, generator=gen).to(dev))
            got = riccati_fused.riccati_fused(nx, C, c, F, u, **kw)
            _riccati_close(got, riccati_fused.riccati_fused_reference(nx, C, c, F, u, **kw),
                           (form, nx, list(kw)))


@pytest.mark.parametrize("nx", [5, 31, 48, 64])
def test_riccati_kernel_bits_do_not_depend_on_the_launch(dev, nx):
    """Teams take no decision together, so every block size (and, for the
    looped form past 31 states, the device-memory team store) gives the
    bits of the default launch; n_state 64 keeps its team memory in device
    memory at the default block (riccati_fused.plan)."""
    gen = torch.Generator().manual_seed(nx)
    C, c, F, u, _ = _riccati_problem(gen, 20, 1030, nx, dev)
    kw = dict(u_lower=-1.0, u_upper=1.0)
    ref = riccati_fused.riccati_fused(nx, C, c, F, u, **kw)
    p = riccati_fused.plan(nx, 1030)
    assert p["looped"] == (nx > 31) and p["global"] == (nx == 64)
    launches = [(b, "auto") for b in riccati_fused.BLOCKS]
    if p["looped"]:
        launches += [(b, "global") for b in riccati_fused.BLOCKS]
    for block, store in launches:
        got = riccati_fused.riccati_fused(nx, C, c, F, u, block=block, store=store, **kw)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (block, store)
    if nx == 64:
        _riccati_close(ref, riccati_fused.riccati_fused_reference(nx, C, c, F, u, **kw))


def test_riccati_call_is_one_device_operation(dev):
    """A call, box bounds and delta_u folded in the kernel, makes exactly one
    device operation: the kernel (torch.profiler, over 5 calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(3)
    C, c, F, u, uz = _riccati_problem(gen, 20, 1024, 5, dev)
    Cx = C[0, 0].expand_as(C)
    for kw in (dict(u_lower=-1.0, u_upper=1.0, delta_u=0.2), {"u_zero_I": uz}, {}):
        riccati_fused.riccati_fused(5, Cx, c, F, u, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                riccati_fused.riccati_fused(5, Cx, c, F, u, **kw)
            torch.cuda.synchronize()
        # the device's own activities: the profiler also gives host operators
        # device time, under the host operator's name
        events = prof.events()
        host = {e.name for e in events if e.device_type == DeviceType.CPU}
        names = [e.name for e in events if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False) and e.name not in host]
        assert names and all("riccati" in x for x in names), names


def test_kkt_backward_of_17_states_launches_the_riccati_kernel(dev):
    """n_state 17, one control: past the KKT kernel's gate (16), so the KKT
    VJP takes the plain scans, whose auxiliary LQR (u_zero_I mask, free of
    bounds) now launches the Riccati kernel; against backend "torch"."""
    from dilqr_tpu_torch.diff.kkt import make_kkt_vjp

    nx, T, B = 17, 8, 300
    gen = torch.Generator().manual_seed(17)
    C, c, F, u, uz = _riccati_problem(gen, T, B, nx, dev)
    x = torch.randn(T, B, nx, generator=gen).to(dev)
    gx = torch.randn(T, B, nx, generator=gen).to(dev)
    gu = torch.randn(T, B, 1, generator=gen).to(dev)
    out = {}
    for backend in ("auto", "torch"):
        before = (riccati_fused.LAUNCHES, kkt_fused.LAUNCHES)
        vjp = make_kkt_vjp(nx, 1, C, c, F, x, u, u_zero_I=uz, backend=backend)
        out[backend] = vjp(gx, gu)
        torch.cuda.synchronize()
        assert kkt_fused.LAUNCHES == before[1]
        assert (riccati_fused.LAUNCHES - before[0] > 0) == (backend == "auto")
    for name in ("dx_init", "dC", "dc", "dF", "df"):
        a, b = getattr(out["auto"], name), getattr(out["torch"], name)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item() + 1e-6)


def test_mlp_solve_launches_the_riccati_kernel_per_iteration(dev):
    """The learned cartpole model (hidden 100, 1,205 weights, its widths
    fixed: models/cartpole_mlp) runs the whole-solve kernel past JAX's 256
    weights, its pytree weights flattened by kernel_params: one launch a
    solve and no Riccati launch; backend="torch" launches nothing and runs
    the plain loop (counted in PLAIN_SOLVES). With random weights the
    problem is chaotic in f32 after a few iterations (chip_smoke.py's
    mlp_parity), so the two are held after 2: n_iter equal, costs within
    rtol 1e-4, u within 2e-2."""
    from dilqr_tpu_torch.core import ilqr as tilqr

    gen = torch.Generator().manual_seed(5)
    params = nn_dynamics.init_params(5, 1, (100,), generator=gen, device=dev)
    dyn = nn_dynamics.make(5, 1, hidden_sizes=(100,))
    q, p = cartpole.get_true_obj(device=dev)
    th = torch.pi + 0.3 * torch.randn(1030, generator=gen)
    z = torch.zeros(1030)
    x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)
    out = {}
    for lqr_iter in (2, 10):
        for backend in ("auto", "torch"):
            mpc = P.MPC(5, 1, 20, u_lower=-100.0, u_upper=100.0, lqr_iter=lqr_iter, eps=1e-4,
                        linesearch_decay=0.5, max_linesearch_iter=2, backprop=False,
                        exit_unconverged=False, backend=backend)
            before = (fused.LAUNCHES, riccati_fused.LAUNCHES, tilqr.PLAIN_SOLVES)
            res = mpc.solve(x0, P.QuadCost(torch.diag(q), p), dyn, params=params)
            torch.cuda.synchronize()
            kernel = backend == "auto"
            assert fused.LAUNCHES - before[0] == int(kernel)
            assert riccati_fused.LAUNCHES == before[1]
            assert tilqr.PLAIN_SOLVES - before[2] == int(not kernel)
            assert torch.isfinite(res.costs).all()
            out[lqr_iter, backend] = res
    a, b = out[2, "auto"], out[2, "torch"]
    assert int(a.n_iter) == int(b.n_iter) == 2
    torch.testing.assert_close(a.costs, b.costs, rtol=1e-4, atol=0)
    assert (a.u - b.u).abs().max().item() <= 2e-2


def _lqr_problem(gen, T, B, nx, nu, dev, dtype=torch.float64):
    """tests/test_parallel_riccati.py's well-conditioned random LQR problem."""
    n = nx + nu
    A = torch.randn(T, B, n, n, generator=gen, dtype=dtype)
    C = A @ A.transpose(-1, -2) + 3.0 * torch.eye(n, dtype=dtype)
    Fx = torch.eye(nx, dtype=dtype) + 0.08 * torch.randn(T - 1, B, nx, nx, generator=gen,
                                                         dtype=dtype)
    Fu = 0.4 * torch.randn(T - 1, B, nx, nu, generator=gen, dtype=dtype)
    parts = (C, torch.randn(T, B, n, generator=gen, dtype=dtype), torch.cat([Fx, Fu], -1),
             0.2 * torch.randn(T - 1, B, nx, generator=gen, dtype=dtype),
             torch.randn(B, nx, generator=gen, dtype=dtype),
             torch.rand(T, B, nu, generator=gen) < 0.3)
    return [a.to(dev) for a in parts]


@pytest.mark.parametrize("T,B,nx,nu,masked", [(20, 256, 5, 1, False), (20, 256, 5, 1, True),
                                              (20, 64, 13, 3, False), (512, 8, 4, 2, False)])
def test_parallel_riccati_matches_sequential_on_the_card(dev, T, B, nx, nu, masked):
    """plqr_backward and plqr_solve on CUDA tensors against the plain
    sequential recursion (backend "torch") and its open-loop rollout, at
    f64 within 1e-10 (tests/test_parallel_riccati.py's bar): the bench
    width, a u_zero_I mask, the rocket width (the combine's linalg.solve
    branch) and the long horizon JAX validated. No kernel launches."""
    from dilqr_tpu_torch.ops.parallel_riccati import plqr_backward, plqr_solve
    from dilqr_tpu_torch.ops.riccati import lqr_backward
    from dilqr_tpu_torch.ops.rollout import get_traj

    C, c, F, f, x0, uz = _lqr_problem(torch.Generator().manual_seed(6), T, B, nx, nu, dev)
    uz = uz if masked else None
    before = riccati_fused.LAUNCHES
    K, k = plqr_backward(nx, nu, C, c, F, f, uz)
    ref = lqr_backward(nx, nu, C, c, F, f, torch.zeros(T, B, nu, dtype=C.dtype, device=dev),
                       u_zero_I=uz, backend="torch")
    assert K.is_cuda and riccati_fused.LAUNCHES == before
    torch.testing.assert_close(K, ref.K, rtol=0, atol=1e-10)
    torch.testing.assert_close(k, ref.k, rtol=0, atol=1e-10)
    res = plqr_solve(nx, nu, C, c, F, f, x0, uz)
    x_ref = get_traj(T, res.u, x0, P.LinDx(F, f))
    torch.testing.assert_close(res.x, x_ref, rtol=0, atol=1e-10)


def test_riccati_parallel_ift_gradient_skips_the_kkt_kernel(dev):
    """riccati_parallel=True: the cartpole IFT backward's auxiliary solve
    and adjoints are associative scans, so no KKT launch; the forward
    still takes the whole-solve kernel (its gate does not look at the
    flag). Against the default gradient through the KKT kernel, max-norm
    rtol 1e-3 (f32 recursions; GMRES may stop one iteration apart)."""
    dyn, params = cartpole.make(), cartpole.default_params(device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    gen = torch.Generator().manual_seed(7)
    th = 3.0 + 0.1 * torch.randn(512, generator=gen)
    z = torch.zeros(512)
    x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)
    grads = {}
    for par in (False, True):
        cfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=20, lqr_iter=20, eps=1e-4,
                           linesearch_decay=0.5, max_linesearch_iter=2, exit_unconverged=False,
                           detach_unconverged=False, backward_mode=P.BackwardMode.IFT,
                           riccati_parallel=par)
        pr = params.clone().requires_grad_(True)
        before = (fused.LAUNCHES, kkt_fused.LAUNCHES)
        res = P.solve(cfg, x0, P.QuadCost(torch.diag(q), p), dyn, params=pr,
                      u_lower=-100.0, u_upper=100.0)
        (grads[par],) = torch.autograd.grad((res.u ** 2).mean(), pr)
        torch.cuda.synchronize()
        assert fused.LAUNCHES == before[0] + 1
        assert (kkt_fused.LAUNCHES > before[1]) == (not par)
    assert torch.isfinite(grads[True]).all()
    torch.testing.assert_close(grads[True], grads[False], rtol=1e-3,
                               atol=1e-3 * grads[False].abs().max().item())


def test_lstm_policy_on_the_card_matches_the_cpu(dev):
    """The mode-'nn' policy at the reference width (256) on the card
    against the same weights on the CPU at f32: controls within 1e-5 and
    parameter gradients within 1e-4 of their largest entry (the same
    products, summed in another order)."""
    from dilqr_tpu_torch.il.lstm import LSTMPolicy

    gen = torch.Generator().manual_seed(8)
    cpu = LSTMPolicy(5, 1, 20, generator=gen)
    card = LSTMPolicy(5, 1, 20, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(64, 5, generator=gen)
    w = torch.randn(64, 20, 1, generator=gen)
    u_cpu, u_card = cpu(x), card(x.to(dev))
    assert u_card.is_cuda and u_card.shape == (64, 20, 1)
    err = (u_card.cpu() - u_cpu).abs().max().item()
    assert err <= 1e-5 * max(1.0, u_cpu.abs().max().item()), err
    (u_cpu * w).sum().backward()
    (u_card * w.to(dev)).sum().backward()
    for (name, a), b in zip(cpu.named_parameters(), card.parameters()):
        err = (b.grad.cpu() - a.grad).abs().max().item()
        assert err <= 1e-4 * a.grad.abs().max().item(), (name, err)


LINDX_CASES = ("(3,2) box", "(3,2) unboxed", "(3,2) u_zero_I unboxed", "(3,2) delta_u",
               "(3,2) per-time bounds", "(3,2) example-invariant cost", "(3,2) slew rate",
               "(4,4) box", "(4,8) box", "(4,8) unboxed", "(15,2) box", "(6,1) box",
               "(15,1) u_zero_I unboxed")


def _lindx_case(dev, case, B=1030, T=10):
    """(cfg, LinDx, x0, cost, lo, hi, kw) of one LinDx case on _lqr_problem's
    random problem (f32): box +-0.5 (+-0.4 at 4 states), the 30% mask,
    delta_u 0.2, per-time and per-example bounds in [0.2, 0.8], one
    [n,n]+[n] cost, the slew rate 1.0 (augment_slew_rate: (5,2)); eps=0
    and 4 iterations."""
    from dilqr_tpu_torch.core.solver import augment_slew_rate

    nx, nu = (int(v) for v in case[1:case.index(")")].split(","))
    gen = torch.Generator().manual_seed(9 + nx + 10 * nu)
    C, c, F, f, x0, mask = _lqr_problem(gen, T, B, nx, nu, dev, torch.float32)
    cfg = P.ILQRConfig(n_state=nx, n_ctrl=nu, T=T, lqr_iter=4, eps=0.0, backprop=False)
    dyn, cost, kw = P.LinDx(F, f), (C, c), {}
    box = 0.4 if nx == 4 else 0.5
    lo, hi = -box, box
    if "unboxed" in case:
        lo = hi = None
    if "u_zero_I" in case:
        kw["u_zero_I"] = mask
    if "delta_u" in case:
        kw["delta_u"] = 0.2
    if "per-time" in case:
        hi = (0.2 + 0.6 * torch.rand(T, B, nu, generator=gen)).to(dev)
        lo = -hi
    if "example-invariant" in case:
        cost = (C[0, 0].contiguous(), c[0, 0].contiguous())
    if "slew" in case:
        cfg, a_cost, dyn, _, x0 = augment_slew_rate(
            dataclasses.replace(cfg, slew_rate_penalty=1.0), P.QuadCost(C, c), dyn, None, x0,
            None)
        cost = (a_cost.C, a_cost.c)
    return cfg, dyn, x0, cost, lo, hi, kw


@pytest.mark.parametrize("case", LINDX_CASES)
def test_lindx_kernel_matches_plain_version(dev, case):
    """A LinDx problem on the whole-solve kernel (LinDx<NX, NU>, its
    shape's library built at first use) against the plain version on the
    same CUDA inputs, one launch, the masked u exactly 0, and the same bits
    at every cluster size the shape has: the slice's (3,2) with its
    variants and slew rate, n_ctrl 4 and 8 (Gauss-Jordan), the gate's
    (15,2) (the split layout: F and q in the scratch, G=8 and 16), one
    control in registers (6,1) and in shared memory (15,1)."""
    cfg, dyn, x0, cost, lo, hi, kw = _lindx_case(dev, case)
    assert fused.covered(cfg, dyn, None, torch.float32, cost if cost[0].dim() == 2 else None,
                         kw.get("u_zero_I"), kw.get("delta_u"), lo, hi)
    before = fused.LAUNCHES
    k = fused.ilqr_fused(cfg, dyn, None, x0, cost, None, lo, hi, **kw)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    r = fused.ilqr_fused_reference(cfg, dyn, None, x0, cost, None, lo, hi, **kw)
    _assert_variant(k, r, cfg)
    if "u_zero_I" in kw:
        assert k[1][kw["u_zero_I"]].abs().max().item() == 0.0
    for G in fused.lindx_clusters(cfg.n_state, cfg.n_ctrl):
        out = fused.ilqr_fused(cfg, dyn, None, x0, cost, None, lo, hi, **kw, cluster=G)
        assert all(torch.equal(a, b) for a, b in zip(out, k)), G


def test_lindx_solves_launch_the_kernel_and_build_once(dev, monkeypatch):
    """backend="cuda" launches the whole-solve kernel once a LinDx solve
    (no Riccati launch), with and without the slew rate; a second solve at a
    built shape loads its library from the build directory and starts no
    nvcc; a shape past JAX's gate and n_ctrl 9 are refused."""
    from dilqr_tpu_torch.ops.cuda import build

    gen = torch.Generator().manual_seed(12)
    B, T = 1024, 10
    C, c, F, f, x0, _ = _lqr_problem(gen, T, B, 3, 2, dev, torch.float32)
    bm = lambda a: a.transpose(0, 1)  # noqa: E731
    cost, lin = P.QuadCost(bm(C), bm(c)), P.LinDx(bm(F), bm(f))
    kw = dict(u_lower=-0.5, u_upper=0.5, lqr_iter=4, eps=1e-4, backprop=False,
              exit_unconverged=False, backend="cuda")
    outs = []
    for mpc in (P.MPC(3, 2, T, **kw), P.MPC(3, 2, T, slew_rate_penalty=1.0, **kw)):
        before, ric_before = fused.LAUNCHES, riccati_fused.LAUNCHES
        outs.append(mpc(x0, cost, lin))
        torch.cuda.synchronize()
        assert fused.LAUNCHES == before + 1 and riccati_fused.LAUNCHES == ric_before
        assert outs[-1][1].shape == (B, T, 2) and torch.isfinite(outs[-1][2]).all()
    spec = fused.lindx_spec(3, 2, True)
    assert os.path.exists(build.library_path(spec))

    def no_nvcc(*a, **k):
        raise AssertionError("nvcc started for a shape that is built")

    monkeypatch.setattr(build.subprocess, "Popen", no_nvcc)
    monkeypatch.delitem(build._LOADED, spec)
    x, u, costs = P.MPC(3, 2, T, **kw)(x0, cost, lin)
    assert torch.equal(costs, outs[0][2])
    for nx, nu in ((16, 2), (3, 9)):
        n = nx + nu
        with pytest.raises(ValueError, match="not covered"):
            P.MPC(nx, nu, T, **kw)(torch.zeros(8, nx, device=dev),
                                   P.QuadCost(torch.eye(n, device=dev).expand(8, T, n, n),
                                              torch.zeros(8, T, n, device=dev)),
                                   P.LinDx(torch.zeros(8, T - 1, nx, n, device=dev)))


def test_lindx_ift_gradient_launches_both_kernels(dev):
    """The IFT gradient of a LinDx solve at (3,2): the whole-solve kernel
    forward, the KKT kernel backward, within 1e-3 (relative to the
    largest entry) of the plain backward's d/dF and d/df."""
    gen = torch.Generator().manual_seed(13)
    B, T = 1024, 10
    C, c, F, f, x0, _ = _lqr_problem(gen, T, B, 3, 2, dev, torch.float32)
    cfg = P.ILQRConfig(n_state=3, n_ctrl=2, T=T, lqr_iter=6, eps=1e-4,
                       detach_unconverged=False, backward_mode=P.BackwardMode.IFT)
    bm = lambda a: a.transpose(0, 1)  # noqa: E731

    def grad(c_):
        Fr, fr = bm(F).clone().requires_grad_(True), bm(f).clone().requires_grad_(True)
        res = P.solve(c_, x0, P.QuadCost(bm(C), bm(c)), P.LinDx(Fr, fr), u_lower=-0.5,
                      u_upper=0.5)
        return torch.autograd.grad((res.u ** 2).mean(), (Fr, fr))

    before = (fused.LAUNCHES, kkt_fused.LAUNCHES, riccati_fused.LAUNCHES)
    g = grad(cfg)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before[0] + 1 and kkt_fused.LAUNCHES > before[1]
    assert riccati_fused.LAUNCHES == before[2]
    g_ref = grad(dataclasses.replace(cfg, backward_backend="torch"))
    for a, b in zip(g, g_ref):
        assert torch.isfinite(a).all() and a.abs().max().item() > 0
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()


# the jvp sweep (JvpJac, csrc/ilqr_jvp.cu): (env, method)
JVP_CASES = (("cartpole", "AUTO_DIFF"), ("pendulum", "AUTO_DIFF"), ("rocket", "AUTO_DIFF"),
             ("complex pendulum", "ANALYTIC"), ("complex pendulum", "AUTO_DIFF"),
             ("rocket normalize_quat", "ANALYTIC"), ("rocket normalize_quat", "AUTO_DIFF"))
IL_PARAMS = (10.0, 1.0, 1.0, 1.0, 0.1)  # il/env.py "pendulum-complex"


def _jvp_problem(dev, env, method, B=1030, T=12):
    """(cfg, dyn, params, x0, cost, lo, hi) of one jvp-sweep case: the env's
    box (the pendulums' is their torque clamp), eps=0 and 4 iterations."""
    if env.startswith("rocket"):
        dyn = rocket.make(normalize_quat=env.endswith("normalize_quat"))
        params = rocket.default_params(device=dev)
        q, p = rocket.get_true_obj(device=dev)
        x0 = torch.from_numpy(bench_start(B, 9)).to(dev)
    else:
        gen = torch.Generator().manual_seed(10)
        th = 0.5 * torch.randn(B, generator=gen) + (3.0 if env == "cartpole" else 0.0)
        z = torch.zeros(B)
        if env == "cartpole":
            dyn, params = cartpole.make(), cartpole.default_params(device=dev)
            q, p = cartpole.get_true_obj(device=dev)
            x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1)
        else:
            dyn = pendulum.make(simple=env == "pendulum")
            params = (pendulum.default_params(device=dev) if env == "pendulum"
                      else torch.tensor(IL_PARAMS, device=dev))
            q, p = pendulum.get_true_obj(device=dev)
            x0 = torch.stack([th.cos(), th.sin(), z], 1)
        x0 = x0.to(dev)
    cfg = P.ILQRConfig(n_state=dyn.n_state, n_ctrl=dyn.n_ctrl, T=T, lqr_iter=4, eps=0.0,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter,
                       grad_method=P.GradMethod[method], backprop=False)
    lo, hi = dyn.lower, dyn.upper
    if isinstance(lo, torch.Tensor):
        lo, hi = lo.to(dev), hi.to(dev)
    return cfg, dyn, params, x0, (torch.diag(q), p), lo, hi


@pytest.mark.parametrize("slew", [False, True], ids=["plain", "slew"])
@pytest.mark.parametrize("env,method", JVP_CASES)
def test_jvp_kernel_matches_plain_version(dev, env, method, slew):
    """The jvp sweep's kernel (csrc/ilqr_jvp.cu) against its plain version
    (a batched torch.func.jvp a column) on the same CUDA inputs, one launch,
    the same bits at every cluster size its library has; with slew the
    slew-rate wrapper Passthrough<JvpJac<Env>> through augment_slew_rate."""
    from dilqr_tpu_torch.core.solver import augment_slew_rate, canonicalize_cost

    cfg, dyn, params, x0, cost, lo, hi = _jvp_problem(dev, env, method)
    if slew:
        B, T, n = x0.shape[0], cfg.T, cfg.n_state + cfg.n_ctrl
        cfg, a_cost, dyn, params, x0 = augment_slew_rate(
            dataclasses.replace(cfg, slew_rate_penalty=1.0),
            canonicalize_cost(P.QuadCost(*cost), T, B, n), dyn, params, x0, None)
        cost = (a_cost.C, a_cost.c)
    assert fused.uses_jvp(cfg.grad_method, dyn.device_env)
    args = (cfg, dyn, params, x0, cost, None, lo, hi)
    before = fused.LAUNCHES
    k = fused.ilqr_fused(*args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    _assert_variant(k, fused.ilqr_fused_reference(*args), cfg)
    for G in fused.clusters(dyn.device_env):
        assert all(torch.equal(a, b) for a, b in zip(fused.ilqr_fused(*args, cluster=G), k))


def test_jvp_solves_launch_the_kernel_and_refuse_the_rest(dev):
    """backend="cuda" launches the whole-solve kernel once a solve on the
    complex pendulum (MPC, ANALYTIC), cartpole under AUTO_DIFF and the
    renormalizing rocket under AUTO_DIFF, no Riccati launch; it refuses
    FINITE_DIFF, f64 and qp_solver "pnqp" on the complex pendulum."""
    pc = pendulum.make(simple=False)
    params = torch.tensor(IL_PARAMS, device=dev)
    q, p = pendulum.get_true_obj(device=dev)
    B, T = 1024, 10
    gen = torch.Generator().manual_seed(11)
    th = 1.5 * torch.randn(B, generator=gen)
    x0 = torch.stack([th.cos(), th.sin(), torch.zeros(B)], 1).to(dev)
    cost = P.QuadCost(torch.diag(q), p)
    kw = dict(u_lower=-2.0, u_upper=2.0, lqr_iter=5, eps=1e-3, backprop=False,
              exit_unconverged=False, backend="cuda")
    runs = [(P.MPC(3, 1, T, **kw), x0, cost, pc, params)]
    cp_q, cp_p = cartpole.get_true_obj(device=dev)
    z = torch.zeros(B)
    xc = torch.stack([z, z, (3.0 + th).cos(), (3.0 + th).sin(), z], 1).to(dev)
    runs.append((P.MPC(5, 1, T, **dict(kw, u_lower=-10.0, u_upper=10.0),
                       grad_method=P.GradMethod.AUTO_DIFF), xc,
                 P.QuadCost(torch.diag(cp_q), cp_p), cartpole.make(),
                 cartpole.default_params(device=dev)))
    r_q, r_p = rocket.get_true_obj(device=dev)
    runs.append((P.MPC(13, 3, T, **dict(kw, u_lower=-20.0, u_upper=20.0),
                       grad_method=P.GradMethod.AUTO_DIFF),
                 torch.from_numpy(bench_start(B, 11)).to(dev), P.QuadCost(torch.diag(r_q), r_p),
                 rocket.make(normalize_quat=True), rocket.default_params(device=dev)))
    for mpc, x, c, dyn, prm in runs:
        before, ric_before = fused.LAUNCHES, riccati_fused.LAUNCHES
        xs, us, costs = mpc(x, c, dyn, params=prm)
        torch.cuda.synchronize()
        assert fused.LAUNCHES == before + 1 and riccati_fused.LAUNCHES == ric_before
        assert torch.isfinite(costs).all() and us.shape == (B, T, dyn.n_ctrl)
    for change in (dict(grad_method=P.GradMethod.FINITE_DIFF), dict(qp_solver="pnqp")):
        bad = P.MPC(3, 1, T, **kw)
        bad.cfg = dataclasses.replace(bad.cfg, **change)
        with pytest.raises(ValueError, match="not covered"):
            bad(x0, cost, pc, params=params)
    with pytest.raises(ValueError, match="not covered"):
        P.MPC(3, 1, T, **kw)(x0.double(), P.QuadCost(torch.diag(q).double(), p.double()), pc,
                             params=params.double())


def test_jvp_ift_gradient_launches_both_kernels(dev):
    """The AUTO_DIFF IFT gradient of the complex pendulum with respect to
    its params: the whole-solve kernel forward (the jvp sweep), the KKT
    kernel at (3,1) backward, within 1e-3 (relative to the largest entry)
    of the plain backward's."""
    cfg, dyn, params, x0, cost, lo, hi = _jvp_problem(dev, "complex pendulum", "AUTO_DIFF",
                                                      B=1024)
    cfg = dataclasses.replace(cfg, eps=1e-3, lqr_iter=8, backprop=True, detach_unconverged=False,
                              backward_mode=P.BackwardMode.IFT)

    def grad(c):
        pr = params.clone().requires_grad_(True)
        res = P.solve(c, x0, P.QuadCost(*cost), dyn, params=pr, u_lower=lo, u_upper=hi)
        return torch.autograd.grad((res.u ** 2).mean(), pr)[0]

    before = (fused.LAUNCHES, kkt_fused.LAUNCHES)
    g = grad(cfg)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before[0] + 1 and kkt_fused.LAUNCHES > before[1]
    g_ref = grad(dataclasses.replace(cfg, backward_backend="torch"))
    assert torch.isfinite(g).all() and g.abs().max().item() > 0
    assert (g - g_ref).abs().max().item() <= 1e-3 * g_ref.abs().max().item()


MLP_CASES = ((3, 1, (8,), "sigmoid"), (3, 2, (16,), "sigmoid"))


def _mlp_problem(dev, nx, nu, hidden, act, B=1030, T=12):
    """(cfg, dyn, flat weights, x0, cost) of one MLP case: random weights
    from a seed, x0 = 0.3 randn, the identity cost, eps=0 and 4
    iterations (the random model is chaotic in f32 past a few)."""
    gen = torch.Generator().manual_seed(12)
    dyn = nn_dynamics.make(nx, nu, activation=act, hidden_sizes=hidden)
    ws = nn_dynamics.init_params(nx, nu, hidden, generator=gen, device=dev)
    x0 = (0.3 * torch.randn(B, nx, generator=gen)).to(dev)
    n = nx + nu
    cfg = P.ILQRConfig(n_state=nx, n_ctrl=nu, T=T, lqr_iter=4, eps=0.0, backprop=False)
    return cfg, dyn, ws, x0, (torch.eye(n, device=dev), torch.zeros(n, device=dev))


@pytest.mark.parametrize("slew", [False, True], ids=["plain", "slew"])
@pytest.mark.parametrize("nx,nu,hidden,act", MLP_CASES)
def test_mlp_kernel_matches_plain_version(dev, nx, nu, hidden, act, slew):
    """The small MLP's kernel (csrc/ilqr_mlp.cu, Mlp with its hand Jacobian
    Mlp::jac, one hidden layer) against its plain version on the same CUDA
    inputs with the flat weights, box +-0.5, one launch, the same bits at
    every cluster size its library has; with slew the slew-rate wrapper
    Passthrough<Mlp>."""
    from dilqr_tpu_torch.core.ilqr import kernel_params
    from dilqr_tpu_torch.core.solver import augment_slew_rate, canonicalize_cost

    cfg, dyn, ws, x0, cost = _mlp_problem(dev, nx, nu, hidden, act)
    if slew:
        B, T, n = x0.shape[0], cfg.T, nx + nu
        cfg, a_cost, dyn, ws, x0 = augment_slew_rate(
            dataclasses.replace(cfg, slew_rate_penalty=1.0),
            canonicalize_cost(P.QuadCost(*cost), T, B, n), dyn, ws, x0, None)
        cost = (a_cost.C, a_cost.c)
    flat = kernel_params(dyn, ws)
    assert fused.covered(cfg, dyn, flat, torch.float32, None if slew else cost, None, None,
                         -0.5, 0.5)
    args = (cfg, dyn, flat, x0, cost, None, -0.5, 0.5)
    before = fused.LAUNCHES
    k = fused.ilqr_fused(*args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    _assert_variant(k, fused.ilqr_fused_reference(*args), cfg)
    for G in fused.mlp_clusters(cfg.n_state, cfg.n_ctrl):
        assert all(torch.equal(a, b) for a, b in zip(fused.ilqr_fused(*args, cluster=G), k))


def test_mlp_solves_launch_the_kernel_and_hidden_100_does_not(dev):
    """MPC on the golden's shape (3, 2, (16,)) with its weights as the
    pytree: one whole-solve launch a solve and no Riccati launch; its IFT
    gradient with respect to the weights runs the kernel forward and the
    KKT kernel backward, within 1e-3 (relative to the largest entry) of the
    plain backward's. Hidden 100 at (3, 2) (903 weights, one hidden layer,
    past JAX's 256) takes one whole-solve launch too; two hidden layers of
    100 (past 256, each earlier hidden layer an array per thread) take
    none."""
    cfg, dyn, ws, x0, cost = _mlp_problem(dev, 3, 2, (16,), "sigmoid", B=1024, T=10)
    kw = dict(u_lower=-0.5, u_upper=0.5, lqr_iter=8, eps=1e-3, exit_unconverged=False)
    before, ric_before = fused.LAUNCHES, riccati_fused.LAUNCHES
    xs, us, costs = P.MPC(3, 2, 10, backprop=False, **kw)(x0, P.QuadCost(*cost), dyn, params=ws)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1 and riccati_fused.LAUNCHES == ric_before
    assert torch.isfinite(costs).all() and us.abs().max().item() <= 0.5 + 1e-6

    def grad(backend):
        wr = [tuple(a.clone().requires_grad_(True) for a in layer) for layer in ws]
        mpc = P.MPC(3, 2, 10, backward_mode=P.BackwardMode.IFT, **kw)
        mpc.cfg = dataclasses.replace(mpc.cfg, backward_backend=backend)
        _, u, _ = mpc(x0, P.QuadCost(*cost), dyn, params=wr)
        return torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            (u ** 2).mean(), [a for layer in wr for a in layer])])

    before = (fused.LAUNCHES, kkt_fused.LAUNCHES)
    g = grad("auto")
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before[0] + 1 and kkt_fused.LAUNCHES > before[1]
    g_ref = grad("torch")
    assert torch.isfinite(g).all() and g.abs().max().item() > 0
    assert (g - g_ref).abs().max().item() <= 1e-3 * g_ref.abs().max().item()
    for hidden, launches in (((100,), 1), ((100, 100), 0)):
        big = nn_dynamics.make(3, 2, hidden_sizes=hidden)
        wb = nn_dynamics.init_params(3, 2, hidden, generator=torch.Generator().manual_seed(13),
                                     device=dev)
        before = fused.LAUNCHES
        out = P.MPC(3, 2, 10, backprop=False, **dict(kw, lqr_iter=2))(x0, P.QuadCost(*cost), big,
                                                                      params=wb)
        torch.cuda.synchronize()
        assert fused.LAUNCHES == before + launches and torch.isfinite(out[2]).all()


def _profiled(fn):
    """The device events of fn in a window utils/profiling.profiled opens."""
    from dilqr_tpu_torch.utils.profiling import device_events, profiled

    with profiled() as prof:
        fn()
    return device_events(prof)


def test_profiler_records_every_kernel_launch(dev):
    """utils/profiling.profiled opens a window in which the device events
    (device_events) hold every whole-solve launch the wrapper counted, under
    the kernel's name: a burst of 20 launches, and the one-call window of
    an MPC call on a LinDx problem (phase 8's), whose one launch and the
    host's lanes transposes the profile must show."""
    dyn, params = cartpole.make(), cartpole.default_params(device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    gen = torch.Generator().manual_seed(14)
    th = 3.0 + 0.2 * torch.randn(4096, generator=gen)
    z = torch.zeros(4096)
    x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)
    cfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=20, lqr_iter=5, eps=1e-4, backprop=False)
    call = lambda: fused.ilqr_fused(cfg, dyn, params, x0, (torch.diag(q), p), None,  # noqa: E731
                                    -100.0, 100.0)
    call()
    torch.cuda.synchronize()

    def burst():
        for _ in range(20):
            call()

    before = fused.LAUNCHES
    events = _profiled(burst)
    assert fused.LAUNCHES - before == 20
    assert sum("ilqr_fused_kernel" in e.name for e in events) == 20

    C, c, F, f, xl, _ = _lqr_problem(gen, 10, 4096, 3, 2, dev, torch.float32)
    bm = lambda a: a.transpose(0, 1)  # noqa: E731
    mpc = P.MPC(3, 2, 10, u_lower=-0.5, u_upper=0.5, lqr_iter=8, eps=1e-4, backprop=False,
                exit_unconverged=False)
    cost, lin = P.QuadCost(bm(C), bm(c)), P.LinDx(bm(F), bm(f))
    mpc(xl, cost, lin)
    torch.cuda.synchronize()
    before = fused.LAUNCHES
    events = _profiled(lambda: mpc(xl, cost, lin))
    assert fused.LAUNCHES - before == 1
    assert sum("ilqr_fused_kernel" in e.name for e in events) == 1
    assert len(events) > 1


def test_kernel_solve_logs_its_spans_and_each_kernel_starts_after_its_launch(dev, monkeypatch):
    """Five MPC solves on kernel 1 in a ``profiled`` window: each logs
    ``solve`` around ``solve.canonicalize``, ``ilqr.gate``,
    ``ilqr_fused.prepare`` and ``ilqr_fused.launch``, each launch entry
    within 20 us of the profiler's ``dilqr.ilqr_fused.launch`` range, and
    each kernel's device interval starts after that range does."""
    from dilqr_tpu_torch.utils import profiling

    dyn, params = cartpole.make(), cartpole.default_params(device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    th = 3.0 + 0.2 * torch.randn(4096, generator=torch.Generator().manual_seed(19))
    z = torch.zeros(4096)
    x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)
    mpc = P.MPC(5, 1, 20, u_lower=-100.0, u_upper=100.0, lqr_iter=5, eps=1e-4,
                backprop=False, exit_unconverged=False)

    def solve():
        return mpc.solve(x0, P.QuadCost(torch.diag(q), p), dyn, params=params)

    solve()
    torch.cuda.synchronize()
    monkeypatch.setattr(profiling, "_SPAN_LOG", collections.deque())
    before = fused.LAUNCHES
    with profiling.profiled() as prof:
        for _ in range(5):
            solve()
    log = profiling.span_log()
    assert fused.LAUNCHES - before == 5
    assert [e[0] for e in log] == ["solve.canonicalize", "ilqr.gate", "ilqr_fused.prepare",
                                   "ilqr_fused.launch", "solve"] * 5
    # microseconds from the trace's start, the profiler's time_range
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name == "dilqr.ilqr_fused.launch")
    launches = [((s - t0) / 1e3, (t - t0) / 1e3) for name, s, t in log
                if name == "ilqr_fused.launch"]
    assert len(ranges) == 5
    for (a, b), (s, t) in zip(ranges, launches):
        assert -1 <= s - a <= 20 and -1 <= b - t <= 20, (s - a, b - t)
    kernels = sorted(e.time_range.start for e in profiling.device_events(prof)
                     if "ilqr_fused_kernel" in e.name)
    assert len(kernels) == 5
    assert all(k >= a for k, (a, _) in zip(kernels, ranges)), \
        [k - a for k, (a, _) in zip(kernels, ranges)]


def _sweep_problem(dev, B):
    dyn, params = cartpole.make(), cartpole.default_params(device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    th = 3.0 + 0.1 * torch.randn(B, generator=torch.Generator().manual_seed(14))
    z = torch.zeros(B)
    x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)
    mpc = P.MPC(5, 1, 12, u_lower=-100.0, u_upper=100.0, lqr_iter=10, eps=1e-4,
                linesearch_decay=dyn.linesearch_decay,
                max_linesearch_iter=dyn.max_linesearch_iter, exit_unconverged=False,
                backprop=False)
    return dyn, params, q, p, x0, mpc


def _candidate_bits(got, want, s):
    for name in ("x", "u", "costs", "full_du_norm"):
        assert torch.equal(getattr(got, name)[s], getattr(want, name)), name


def test_vmap_cost_sweep_is_one_launch_with_each_candidates_bits(dev):
    """torch.func.vmap over MPC.solve with 4 control weights at B=2048
    (whole tiles): the merged route, one whole-solve launch on the 8192
    folded examples, each candidate's x, u, costs and du the bits of its
    own solve, n_iter the max of the four (chip_smoke.py's phase 12 (a))."""
    from dilqr_tpu_torch.diff import modes

    dyn, params, q, p, x0, mpc = _sweep_problem(dev, 2048)
    ws = torch.logspace(-3, 0, 4, device=dev)

    def cost_of(w):
        return P.QuadCost(torch.diag(torch.cat([q[:-1], w[None]])), p)

    before, merged = fused.LAUNCHES, modes.VMAP_STATS["vmap_merged"]
    res = torch.func.vmap(lambda w: mpc.solve(x0, cost_of(w), dyn, params=params))(ws)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1 and modes.VMAP_STATS["vmap_merged"] == merged + 1
    its = []
    for s in range(4):
        own = mpc.solve(x0, cost_of(ws[s]), dyn, params=params)
        _candidate_bits(res, own, s)
        its.append(int(own.n_iter))
    assert res.n_iter.tolist() == [max(its)] * 4


def test_vmap_params_sweep_launches_once_a_candidate(dev):
    """A batched dynamics param takes the mapped route (the kernel reads one
    params vector a launch): one launch a candidate, each candidate the bits
    of its own solve (chip_smoke.py's phase 12 (c))."""
    from dilqr_tpu_torch.diff import modes

    dyn, params, q, p, x0, mpc = _sweep_problem(dev, 1030)
    ps = torch.stack([params, params * 1.1, params * 0.9])
    cost = P.QuadCost(torch.diag(q), p)
    before, mapped = fused.LAUNCHES, modes.VMAP_STATS["vmap_mapped"]
    res = torch.func.vmap(lambda pp: mpc.solve(x0, cost, dyn, params=pp))(ps)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 3 and modes.VMAP_STATS["vmap_mapped"] == mapped + 1
    for s in range(3):
        _candidate_bits(res, mpc.solve(x0, cost, dyn, params=ps[s]), s)


def _pergrad_problem(dev, B, T=12):
    """bench.py's cartpole at T=12, box +-100, lqr_iter 10, the IFT backward;
    imitation targets from a seed."""
    dyn, params = cartpole.make(), cartpole.default_params(device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    gen = torch.Generator().manual_seed(15)
    th = 3.0 + 0.1 * torch.randn(B, generator=gen)
    z = torch.zeros(B)
    x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)
    target = (0.5 * torch.randn(B, T, 1, generator=gen)).to(dev)
    cfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=T, lqr_iter=10, eps=1e-4,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter, exit_unconverged=False,
                       detach_unconverged=False, backward_mode=P.BackwardMode.IFT)

    def cost_of(w):
        return P.QuadCost(torch.diag(torch.cat([q[:-1], w[None]])), p)

    return dyn, params, p, x0, target, cfg, cost_of


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def test_vmap_grad_is_one_launch_and_one_folded_backward(dev):
    """vmap(grad) of an imitation loss over 3 control weights at B=2048
    (chip_smoke.py's phase 13 (a)): one whole-solve launch and one folded
    backward (the merged routes), with the hand-folded backward's KKT
    launches; the weights' gradients and the params' summed over the
    candidates within 1e-6 relative of the hand-folded backward's, the
    params' per candidate within 1e-6 of that backward with the params given
    per example and each candidate's examples summed."""
    from dilqr_tpu_torch.diff import modes

    S, B, T = 3, 2048, 12
    dyn, params, p, x0, target, cfg, cost_of = _pergrad_problem(dev, B, T)
    ws = torch.tensor([0.001, 0.03, 1.0], device=dev)
    box = dict(u_lower=-100.0, u_upper=100.0)

    def loss(pr, w):
        return ((P.solve(cfg, x0, cost_of(w), dyn, params=pr, **box).u - target) ** 2).sum()

    modes.VMAP_STATS.update(dict.fromkeys(modes.VMAP_STATS, 0))
    before = (fused.LAUNCHES, kkt_fused.LAUNCHES)
    g_p, g_w = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)), in_dims=(None, 0))(
        params, ws)
    torch.cuda.synchronize()
    n_kkt = kkt_fused.LAUNCHES - before[1]
    assert fused.LAUNCHES == before[0] + 1 and n_kkt > 0
    assert {k: v for k, v in modes.VMAP_STATS.items() if v} == {"vmap_merged": 1,
                                                                 "bwd_merged": 1}
    pr, wl = params.clone().requires_grad_(True), ws.clone().requires_grad_(True)
    C = torch.stack([cost_of(w).C for w in wl]).repeat_interleave(B, 0)
    before = kkt_fused.LAUNCHES
    r = P.solve(cfg, x0.repeat(S, 1), P.QuadCost(C[:, None].expand(-1, T, -1, -1),
                                                 p.expand(S * B, T, 6)), dyn, params=pr, **box)
    f_p, f_w = torch.autograd.grad(((r.u.reshape(S, B, T, 1) - target) ** 2).sum(), (pr, wl))
    torch.cuda.synchronize()
    assert kkt_fused.LAUNCHES - before == n_kkt
    assert _rel(g_w, f_w) <= 1e-6 and _rel(g_p.sum(0), f_p) <= 1e-6
    x_t, u_t = r.x.detach().transpose(0, 1), r.u.detach().transpose(0, 1)
    C_t = C.detach()[None].expand(T, -1, -1, -1)
    c_t = p.expand(T, S * B, 6)
    prob, _ = modes._problem(cfg, P.QuadCost(C_t, c_t), dyn, params)
    _, _, d_pe = modes._backward(prob, x_t, u_t, r.full_du_norm, -100.0, 100.0, (C_t, c_t),
                                 params.expand(S * B, -1), torch.zeros_like(x_t),
                                 2.0 * (u_t - target.transpose(0, 1).repeat(1, S, 1)))
    assert _rel(g_p, d_pe.unflatten(0, (S, B)).sum(1)) <= 1e-6


def test_jacrev_is_one_folded_backward(dev):
    """jacrev of the batch-mean terminal state (5 outputs) with respect to
    the params at B=1030 (chip_smoke.py's phase 13 (b)): one whole-solve
    launch and one backward folded over the 5 one-hot cotangents, within
    1e-5 relative of 5 autograd.grad calls on them."""
    from dilqr_tpu_torch.diff import modes

    dyn, params, p, x0, _, cfg, cost_of = _pergrad_problem(dev, 1030)
    cost = cost_of(torch.tensor(1e-3, device=dev))

    def terminal(pr):
        return P.solve(cfg, x0, cost, dyn, params=pr, u_lower=-100.0,
                       u_upper=100.0).x[:, -1].mean(0)

    modes.VMAP_STATS.update(dict.fromkeys(modes.VMAP_STATS, 0))
    before = fused.LAUNCHES
    jac = torch.func.jacrev(terminal)(params)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    assert {k: v for k, v in modes.VMAP_STATS.items() if v} == {"bwd_merged": 1}
    pr = params.clone().requires_grad_(True)
    out = terminal(pr)
    rows = torch.stack([torch.autograd.grad(out, pr, e, retain_graph=True)[0]
                        for e in torch.eye(5, device=dev)])
    assert jac.shape == (5, 4) and _rel(jac, rows) <= 1e-5


def test_unroll_and_delta_u_sweeps_keep_each_candidates_bits(dev):
    """chip_smoke.py's phase 13 (c) at B=256: vmap over the UNROLL solve and
    vmap(grad) through it on the plain loop (no kernel launch), each
    candidate the bits of its own solve and gradient; a delta_u sweep on the
    mapped route, one whole-solve launch a candidate, each candidate its
    own solve's bits."""
    import dataclasses

    dyn, params, p, x0, target, cfg, cost_of = _pergrad_problem(dev, 256)
    box = dict(u_lower=-100.0, u_upper=100.0)
    u_cfg = dataclasses.replace(cfg, lqr_iter=5, backward_mode=P.BackwardMode.UNROLL,
                                unroll=True)
    w2 = torch.tensor([0.01, 0.1], device=dev)

    def unrolled(w, pr=params):
        return P.solve(u_cfg, x0, cost_of(w), dyn, params=pr, **box)

    def loss(pr, w):
        return ((unrolled(w, pr).u - target) ** 2).sum()

    before = (fused.LAUNCHES, kkt_fused.LAUNCHES, riccati_fused.LAUNCHES)
    res = torch.func.vmap(unrolled)(w2)
    g = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(params, w2)
    torch.cuda.synchronize()
    assert (fused.LAUNCHES, kkt_fused.LAUNCHES, riccati_fused.LAUNCHES) == before
    for s in range(2):
        _candidate_bits(res, unrolled(w2[s]), s)
        assert torch.equal(g[s], torch.func.grad(loss)(params, w2[s]))
    d_cfg = dataclasses.replace(cfg, lqr_iter=5, backprop=False)
    dus = torch.tensor([0.5, 1.0, 2.0], device=dev)

    def trust(du):
        return P.solve(d_cfg, x0, cost_of(w2[0]), dyn, params=params, delta_u=du, **box)

    before = fused.LAUNCHES
    res = torch.func.vmap(trust)(dus)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 3
    for s in range(3):
        _candidate_bits(res, trust(dus[s]), s)


# ---- a user's own model and a callable cost, traced into C++ ----

def _traced_problem(dev, B, seed):
    import traced_models as tm

    gen = torch.Generator().manual_seed(seed)
    x0 = (2.0 * torch.rand(B, 4, generator=gen) - 1.0).to(dev)
    q = torch.tensor(tm.DP_COST, device=dev)
    return tm, x0, (torch.diag(q), torch.zeros(6, device=dev)), torch.tensor(tm.DP_PARAMS,
                                                                               device=dev)


@pytest.mark.parametrize("method", ["ANALYTIC", "AUTO_DIFF"])
def test_traced_model_kernel_matches_plain_version(dev, method):
    """The double pendulum (tests/traced_models.py, a user's own model) on
    its generated library (csrc/ilqr_user.cu) against the plain version at
    B=2048: costs and n_iter, x and u on the examples converged in both."""
    tm, x0, cost, params = _traced_problem(dev, 2048, 3)
    dyn = tm.double_pendulum()
    cfg = P.ILQRConfig(n_state=4, n_ctrl=2, T=12, lqr_iter=10, eps=1e-4,
                       grad_method=getattr(P.GradMethod, method), linesearch_decay=0.5,
                       max_linesearch_iter=4, backprop=False)
    args = (cfg, dyn, params, x0, cost, None, -tm.DP_BOX, tm.DP_BOX)
    assert fused.covered(cfg, dyn, params, torch.float32, cost, None, None, -tm.DP_BOX,
                         tm.DP_BOX)
    before = fused.LAUNCHES
    kx, ku, kc, kdu, kn = fused.ilqr_fused(*args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    rx, ru, rc, rdu, rn = fused.ilqr_fused_reference(*args)
    assert int(kn) == int(rn)
    rel = (kc - rc).abs() / rc.abs().clamp(min=1e-6)
    assert rel.max().item() <= 1e-2 and int((rel > 1e-4).sum()) <= 0.01 * x0.shape[0]
    conv = (kdu < cfg.eps) & (rdu < cfg.eps)
    assert bool(conv.any())
    assert (ku - ru).abs().amax(dim=(0, 2))[conv].max().item() <= 2e-2
    assert (kx - rx).abs().amax(dim=(0, 2))[conv].max().item() <= 1e-2


@pytest.mark.parametrize("with_params", [True, False])
def test_callable_cost_kernel_matches_plain_version(dev, with_params):
    """The pendulum with the callable costs of tests/traced_models.py on the
    callable-cost build of csrc/ilqr_fused.cu against the plain version at
    B=2048, and solve's dispatch to it (one launch)."""
    import traced_models as tm
    from dilqr_tpu_torch.core import ilqr as tilqr

    dyn, params = pendulum.make(), pendulum.default_params(device=dev)
    gen = torch.Generator().manual_seed(4)
    th = 4.0 * torch.rand(2048, generator=gen) - 2.0
    x0 = torch.stack([th.cos(), th.sin(), torch.zeros(2048)], 1).to(dev)
    cfg = P.ILQRConfig(n_state=3, n_ctrl=1, T=12, lqr_iter=8, eps=1e-4,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter, backprop=False)
    if with_params:
        cin = torch.tensor([0.5, 0.625, 0.75, 0.875, 0.15, -0.3, 0.06, 0.21], device=dev)
        fn = tm.pendulum_cost
    else:
        cin, fn = (), (lambda tau, _p: tm.pendulum_cost_plain(tau))
    cc = tilqr.callable_cost(cfg, (fn, cin))
    assert cc is not None
    args = (cfg, dyn, params, x0, cc, None, -2.0, 2.0)
    before = fused.LAUNCHES
    kx, ku, kc, kdu, kn = fused.ilqr_fused(*args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    rx, ru, rc, rdu, rn = fused.ilqr_fused_reference(*args)
    assert int(kn) == int(rn)
    rel = (kc - rc).abs() / rc.abs().clamp(min=1e-6)
    assert rel.max().item() <= 1e-2 and int((rel > 1e-4).sum()) <= 0.01 * x0.shape[0]
    conv = (kdu < cfg.eps) & (rdu < cfg.eps)
    assert (ku - ru).abs().amax(dim=(0, 2))[conv].max().item() <= 2e-2
    before = fused.LAUNCHES
    res = P.solve(cfg, x0, (fn, cin) if with_params else tm.pendulum_cost_plain, dyn,
                  params=params, u_lower=-2.0, u_upper=2.0)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    assert torch.equal(res.costs, kc)


def test_captured_weight_changed_in_place_reaches_the_kernel(dev):
    """A cost that captures a one-element CUDA tensor (a weight on the
    control) reads it at each launch: changed in place between two solves,
    the second solve takes the new value with no new trace, matches the
    plain version at the new value, and has the bits of a cost made with
    it."""
    import traced_models as tm
    from dilqr_tpu_torch.core import ilqr as tilqr
    from dilqr_tpu_torch.ops.cuda import traced

    dyn, params = pendulum.make(), pendulum.default_params(device=dev)
    gen = torch.Generator().manual_seed(6)
    th = 4.0 * torch.rand(2048, generator=gen) - 2.0
    x0 = torch.stack([th.cos(), th.sin(), torch.zeros(2048)], 1).to(dev)
    cfg = P.ILQRConfig(n_state=3, n_ctrl=1, T=12, lqr_iter=8, eps=1e-4,
                       linesearch_decay=dyn.linesearch_decay,
                       max_linesearch_iter=dyn.max_linesearch_iter, backprop=False)
    w = torch.full((), 0.1, device=dev)

    def cost(tau):
        return tm.pendulum_cost_plain(tau) + w * tau[3] * tau[3]

    def solve(f):
        return P.solve(cfg, x0, f, dyn, params=params, u_lower=-2.0, u_upper=2.0)

    first = solve(cost)
    w.fill_(2.0)
    n_traces, before = traced.TRACES, fused.LAUNCHES
    second = solve(cost)
    torch.cuda.synchronize()
    assert traced.TRACES == n_traces and fused.LAUNCHES == before + 1
    assert not torch.equal(first.u, second.u)
    cc = tilqr.callable_cost(cfg, (cost, None), dev)
    rx, ru, rc, rdu, rn = fused.ilqr_fused_reference(cfg, dyn, params, x0, cc, None, -2.0, 2.0)
    rel = (second.costs - rc).abs() / rc.abs().clamp(min=1e-6)
    assert rel.max().item() <= 1e-2 and int((rel > 1e-4).sum()) <= 0.01 * x0.shape[0]
    w2 = torch.full((), 2.0, device=dev)
    fresh = solve(lambda tau: tm.pendulum_cost_plain(tau) + w2 * tau[3] * tau[3])
    assert torch.equal(second.u, fresh.u) and torch.equal(second.costs, fresh.costs)


def test_traced_cartpole_matches_its_device_code(dev):
    """The port's cartpole step traced as a user's model (no device_env) under
    AUTO_DIFF against device env 0's jvp library: the same costs to 1e-4 on
    every example of bench.py's start and the same n_iter."""
    from dilqr_tpu_torch.models.base import Dynamics

    cp = cartpole.make()
    user = Dynamics(n_state=5, n_ctrl=1, step=cp.step, lower=cp.lower, upper=cp.upper,
                    linesearch_decay=cp.linesearch_decay,
                    max_linesearch_iter=cp.max_linesearch_iter)
    params = cartpole.default_params(device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    gen = torch.Generator().manual_seed(5)
    th = 3.0 + 0.1 * torch.randn(2048, generator=gen)
    z = torch.zeros(2048)
    x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)
    cfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=12, lqr_iter=10, eps=1e-4,
                       grad_method=P.GradMethod.AUTO_DIFF, linesearch_decay=0.5,
                       max_linesearch_iter=2, backprop=False)
    k = fused.ilqr_fused(cfg, user, params, x0, (torch.diag(q), p), None, -100.0, 100.0)
    e = fused.ilqr_fused(cfg, cp, params, x0, (torch.diag(q), p), None, -100.0, 100.0)
    assert int(k[4]) == int(e[4])
    torch.testing.assert_close(k[2], e[2], rtol=1e-4, atol=1e-5)


def test_traced_solves_launch_the_kernel_and_refuse_the_rest(dev):
    """MPC.solve on the double pendulum is one whole-solve launch; a step
    that captures an array takes none, and backend="cuda" raises for it."""
    tm, x0, cost, params = _traced_problem(dev, 1024, 6)
    kw = dict(u_lower=-tm.DP_BOX, u_upper=tm.DP_BOX, lqr_iter=4, eps=1e-4, backprop=False)
    before = fused.LAUNCHES
    res = P.MPC(4, 2, 8, **kw).solve(x0, P.QuadCost(*cost), tm.double_pendulum(), params=params)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1 and bool(torch.isfinite(res.costs).all())
    bad = tm.double_pendulum(tm.array_capture_step, tm.array_capture_step)
    before = fused.LAUNCHES
    res = P.MPC(4, 2, 8, **kw).solve(x0, P.QuadCost(*cost), bad, params=params)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before and bool(torch.isfinite(res.costs).all())
    with pytest.raises(ValueError, match="not covered"):
        P.MPC(4, 2, 8, backend="cuda", **kw).solve(x0, P.QuadCost(*cost), bad, params=params)


@pytest.mark.parametrize("model", ["LinDx", "MLP"])
def test_callable_cost_on_lindx_and_mlp_matches_plain_version(dev, model):
    """A callable cost with params on a LinDx problem (4, 2) and on the
    golden-shape MLP (3, 2, (16,)), each library built with the traced
    cost, against the plain version at B=2048."""
    import traced_models as tm
    from dilqr_tpu_torch.core import ilqr as tilqr

    gen = torch.Generator().manual_seed(7)
    B, T = 2048, 10
    cfg = P.ILQRConfig(n_state=4, n_ctrl=2, T=T, lqr_iter=6, eps=0.0, backprop=False,
                       exit_unconverged=False)
    if model == "LinDx":
        F = (0.1 * torch.randn(T - 1, B, 4, 6, generator=gen)
             + torch.cat([torch.eye(4), torch.zeros(4, 2)], 1)).to(dev)
        dyn, params = P.LinDx(F, None), None
        x0 = (2.0 * torch.rand(B, 4, generator=gen) - 1.0).to(dev)
        fn = tm.dp_cost
        cin = torch.tensor(tm.DP_COST + (0.1, -0.2, 0.3, 0.0), device=dev)
    else:
        cfg = dataclasses.replace(cfg, n_state=3)
        dyn = nn_dynamics.make(3, 2, activation="sigmoid", hidden_sizes=(16,))
        params = nn_dynamics.flat_params(nn_dynamics.init_params(3, 2, (16,), generator=gen,
                                                                 device=dev))
        x0 = torch.randn(B, 3, generator=gen).to(dev)
        fn = (lambda tau, p: 0.5 * (p[0] * (tau[0] ** 2 + tau[1] ** 2 + tau[2] ** 2)
                                    + p[1] * (tau[3] ** 2 + tau[4] ** 2)))
        cin = torch.tensor([1.0, 0.1], device=dev)
    cc = tilqr.callable_cost(cfg, (fn, cin))
    assert cc is not None
    assert fused.covered(cfg, dyn, params, torch.float32, None, None, None, -1.5, 1.5,
                         cost_callable=True)
    args = (cfg, dyn, params, x0, cc, None, -1.5, 1.5)
    before = fused.LAUNCHES
    kx, ku, kc, _, kn = fused.ilqr_fused(*args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    rx, ru, rc, _, rn = fused.ilqr_fused_reference(*args)
    assert int(kn) == int(rn)
    rel = (kc - rc).abs() / rc.abs().clamp(min=1e-6)
    assert rel.max().item() <= 1e-2 and int((rel > 1e-4).sum()) <= 0.01 * B
