"""The port's single-process parallel layer on the CPU: parallel/mesh.py's
sharded solve against the JAX package's (tests/test_sharding.py's cases),
the collectives audit, the batch-global decisions with and without an
active rank group, and the train step of a one-rank group.

The mesh is one CPU device repeated; JAX's is the conftest's 8 virtual CPU
devices. The port's sharded solve stops per chunk, as JAX's shard_map path
does, so it is held against that path (use_shard_map=True, backend "xla")
on a mesh of the same size. Tolerances: f64, u 1e-6 and x 1e-5 as
test_sharding.py:37; eps=0 equality to 1e-6 with the same n_iter, and at eps>0
each example's cost no worse than the one-device cost + 1e-5, as
test_sharding.py:246-282; the per-example inputs at test_sharding.py:284's
1e-5. Bits: a solve (and its IFT backward) under an active one-rank group
gives the same bits as with none, which issues no collective.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dilqr_tpu
import dilqr_tpu_torch as P
from dilqr_tpu.models import pendulum as jpendulum
from dilqr_tpu.parallel.mesh import batch_mesh as jbatch_mesh
from dilqr_tpu.parallel.mesh import sharded_solve as jsharded_solve
from dilqr_tpu_torch.models import pendulum
from dilqr_tpu_torch.parallel import audit, comm
from dilqr_tpu_torch.parallel import multihost as mh
from dilqr_tpu_torch.parallel.mesh import batch_mesh, shard_batch, sharded_solve
from dilqr_tpu_torch.tools.multihost_demo import one_process_step
from dilqr_tpu_torch.utils.optim import rmsprop

F64 = torch.float64
CPU = torch.device("cpu")


def _problem(B=16, T=10, eps=1e-4, **kw):
    """test_sharding.py's pendulum problem at f64, in both packages."""
    rng = np.random.RandomState(3)
    th = rng.uniform(-1.5, 1.5, B)
    x0 = np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], 1)
    dyn = pendulum.make()
    common = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=10, eps=eps,
                  linesearch_decay=dyn.linesearch_decay,
                  max_linesearch_iter=dyn.max_linesearch_iter, exit_unconverged=False,
                  detach_unconverged=False, backprop=False)
    common.update(kw)
    q, p = pendulum.get_true_obj(dtype=F64)
    port = (P.ILQRConfig(**common), torch.from_numpy(x0), P.QuadCost(torch.diag(q), p), dyn,
            pendulum.default_params(dtype=F64))
    jq, jp = jpendulum.get_true_obj()
    jax_ = (dilqr_tpu.ILQRConfig(**common, backend="xla"), jnp.asarray(x0),
            dilqr_tpu.QuadCost(jnp.diag(jnp.asarray(jq, jnp.float64)),
                               jnp.asarray(jp, jnp.float64)),
            jpendulum.make(), jnp.asarray(jpendulum.default_params(), jnp.float64))
    return port, jax_


BOX = dict(u_lower=-2.0, u_upper=2.0)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_solve_matches_single_device(n_dev):
    """Each mesh size against JAX's shard_map solve on as many devices, and
    the chunks placed and numbered as the mesh says."""
    (cfg, x0, cost, dyn, params), (jcfg, jx0, jcost, jdyn, jparams) = _problem()
    res = sharded_solve(batch_mesh([CPU] * n_dev), cfg, x0, cost, dyn, params=params, **BOX)
    assert len(res.shards) == n_dev and res.starts == tuple(range(0, 17, 16 // n_dev))
    assert all(r.u.shape[0] == 16 // n_dev and r.u.device == d
               for r, d in zip(res.shards, res.devices))
    got = res.gather()
    ref = jsharded_solve(jbatch_mesh(jax.devices()[:n_dev]), jcfg, jx0, jcost, jdyn,
                         params=jparams, use_shard_map=True, **BOX)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=1e-6)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=1e-5)
    assert int(got.n_iter) == int(ref.n_iter)
    if n_dev == 1:  # one chunk is the one-device solve
        one = P.solve(cfg, x0, cost, dyn, params=params, **BOX)
        assert all(torch.equal(getattr(got, f), getattr(one, f)) for f in one._fields)


def test_sharded_solve_eps0_equals_single_device():
    """eps=0: no chunk stops early, so the result is the one-device solve's
    (the port's and JAX's), with the same n_iter (test_sharding.py:246)."""
    (cfg, x0, cost, dyn, params), (jcfg, jx0, jcost, jdyn, jparams) = _problem(eps=0.0)
    got = sharded_solve(batch_mesh([CPU] * 8), cfg, x0, cost, dyn, params=params,
                        **BOX).gather()
    one = P.solve(cfg, x0, cost, dyn, params=params, **BOX)
    ref = dilqr_tpu.solve(jcfg, jx0, jcost, jdyn, params=jparams, **BOX)
    for a in (one.u.numpy(), np.asarray(ref.u)):
        np.testing.assert_allclose(got.u.numpy(), a, atol=1e-6)
    np.testing.assert_allclose(got.x.numpy(), one.x.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.costs.numpy(), one.costs.numpy(), atol=1e-6)
    assert int(got.n_iter) == int(one.n_iter) == int(ref.n_iter)


def test_sharded_solve_eps_cost_bound():
    """eps>0: a chunk may stop earlier than the whole batch would, but each
    example's best cost stays equal or better (test_sharding.py:270)."""
    (cfg, x0, cost, dyn, params), _ = _problem(B=16)
    got = sharded_solve(batch_mesh([CPU] * 8), cfg, x0, cost, dyn, params=params,
                        **BOX).gather()
    one = P.solve(cfg, x0, cost, dyn, params=params, **BOX)
    assert bool((got.costs <= one.costs + 1e-5).all())


def test_sharded_solve_per_example_inputs():
    """A per-example QuadCost, a batch-major LinDx and a [B,T,nu] warm start
    split on their batch axis (test_sharding.py:284-325), against the
    one-device solve and JAX's shard_map solve."""
    B, T, n, m = 16, 6, 3, 1
    rng = np.random.RandomState(5)
    x0 = rng.randn(B, n)
    qq = 0.3 * rng.randn(B, T, n + m, n + m)
    C = np.einsum("btij,btkj->btik", qq, qq) + 0.5 * np.eye(n + m)
    c = 0.1 * rng.randn(B, T, n + m)
    F = 0.3 * rng.randn(B, T - 1, n, n + m)
    f = 0.05 * rng.randn(B, T - 1, n)
    u0 = 0.1 * rng.randn(B, T, m)
    common = dict(n_state=n, n_ctrl=m, T=T, lqr_iter=6, eps=0.0, exit_unconverged=False,
                  detach_unconverged=False, backprop=False)
    t = torch.from_numpy
    cfg = P.ILQRConfig(**common)
    args = (t(x0), P.QuadCost(t(C), t(c)), P.LinDx(t(F), t(f)))
    got = sharded_solve(batch_mesh([CPU] * 8), cfg, *args, u_init=t(u0), **BOX).gather()
    one = P.solve(cfg, *args, u_init=t(u0), **BOX)
    np.testing.assert_allclose(got.u.numpy(), one.u.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.costs.numpy(), one.costs.numpy(), rtol=1e-5)
    a = jnp.asarray
    ref = jsharded_solve(jbatch_mesh(jax.devices()[:8]), dilqr_tpu.ILQRConfig(**common,
                         backend="xla"), a(x0), dilqr_tpu.QuadCost(a(C), a(c)),
                         dilqr_tpu.LinDx(a(F), a(f)), u_init=a(u0), use_shard_map=True, **BOX)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=1e-5)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(ref.costs), rtol=1e-5)


def test_sharded_solve_example_invariant_lindx():
    """An example-invariant LinDx F [T-1,n,m] whose T-1 = 3 does not divide
    by the mesh goes to every device whole (test_sharding.py:327), against
    the one-device solve of both packages."""
    B, T, n, m = 16, 4, 3, 1
    rng = np.random.RandomState(11)
    x0 = rng.randn(B, n)
    c = 0.1 * rng.randn(n + m)
    F = 0.3 * rng.randn(T - 1, n, n + m)
    common = dict(n_state=n, n_ctrl=m, T=T, lqr_iter=4, eps=0.0, exit_unconverged=False,
                  detach_unconverged=False, backprop=False)
    t = torch.from_numpy
    cfg = P.ILQRConfig(**common)
    args = (t(x0), P.QuadCost(torch.eye(n + m, dtype=F64), t(c)), P.LinDx(t(F), None))
    got = sharded_solve(batch_mesh([CPU] * 8), cfg, *args, **BOX).gather()
    one = P.solve(cfg, *args, **BOX)
    a = jnp.asarray
    ref = dilqr_tpu.solve(dilqr_tpu.ILQRConfig(**common, backend="xla"), a(x0),
                          dilqr_tpu.QuadCost(a(np.eye(n + m)), a(c)), dilqr_tpu.LinDx(a(F), None),
                          **BOX)
    for r in (one.u.numpy(), np.asarray(ref.u)):
        np.testing.assert_allclose(got.u.numpy(), r, atol=1e-6)


def test_shard_batch_and_batch_mesh():
    mesh = batch_mesh([CPU] * 4)
    parts = shard_batch(mesh, (torch.arange(8.0), {"u": torch.ones(8, 2)}, None))
    assert [p[0].tolist() for p in parts] == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    assert all(p[1]["u"].shape == (2, 2) and p[2] is None for p in parts)
    with pytest.raises(ValueError, match="equal chunks"):
        shard_batch(mesh, torch.zeros(6))
    if not torch.cuda.is_available():  # no default mesh without a card
        with pytest.raises(RuntimeError, match="CUDA"):
            batch_mesh()


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group of this process, torn down after the test."""
    mh.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cpu", timeout=60)
    try:
        yield mh.global_batch_mesh()
    finally:
        mh.shutdown()


def _grad_problem():
    (cfg, x0, cost, dyn, params), _ = _problem(B=8, T=8)
    return dataclasses.replace(cfg, backprop=True, backward_mode=P.BackwardMode.IFT,
                               lqr_iter=6), x0, cost, dyn, params


def _solve_and_grad(cfg, x0, cost, dyn, params, solve=P.solve):
    """A solve and its IFT gradient, each recorded on its own."""
    pr = params.clone().requires_grad_(True)
    with audit.recording() as fwd:
        res = solve(cfg, x0, cost, dyn, params=pr, **BOX)
    with audit.recording() as bwd:
        (g,) = torch.autograd.grad((res.u ** 2).mean(), pr)
    return res, g, fwd, bwd


def test_no_group_records_nothing_and_group_of_one_keeps_the_bits(one_rank):
    """With no rank group active a solve and its IFT backward issue no
    collective (the decisions are bool(flag), as before); under a one-rank
    group every decision, the backward's GMRES ones included, is an
    all-reduce of its flag, and the result has the same bits."""
    args = _grad_problem()
    res0, g0, fwd0, bwd0 = _solve_and_grad(*args)
    assert fwd0 == [] and bwd0 == []

    def in_group(cfg, x0, cost, dyn, params, **kw):
        return mh.multihost_solve(one_rank, cfg, x0, cost, dyn, params=params, **kw)

    res1, g1, fwd1, bwd1 = _solve_and_grad(*args, solve=in_group)
    assert all(torch.equal(getattr(res0, f), getattr(res1, f)) for f in res0._fields)
    assert torch.equal(g0, g1)
    assert {c.site for c in fwd1} == {"decide", "n_iter"} and fwd1[-1].site == "n_iter"
    assert bwd1 and {c.site for c in bwd1} == {"decide"}
    assert all(c.op == "all_reduce" and c.numel == 1 for c in fwd1 + bwd1)


def test_decide_reduces_only_inside_batch_global(one_rank):
    flag = torch.tensor(True)
    with audit.recording() as recs:
        assert comm.decide(flag) is True and comm.decide(~flag, "all") is False
        assert recs == []
        with comm.batch_global(one_rank):
            assert comm.decide(flag, "all") is True and comm.decide(~flag) is False
        with comm.batch_global(None):
            assert comm.decide(flag) is True
    assert [(c.op, c.site, c.numel) for c in recs] == [("all_reduce", "decide", 1)] * 2
    assert comm.active() is None


def test_audit_flags_a_per_example_all_gather(one_rank):
    """The audit passes a solve's flag reductions and flags a planted
    all-gather of per-example data."""
    (cfg, x0, cost, dyn, params), _ = _problem(B=8, T=8)
    with audit.recording() as recs:
        mh.multihost_solve(one_rank, cfg, x0, cost, dyn, params=params, **BOX)
        colls, big = audit.audit_collectives(list(recs), 8)
        assert colls and not big
        comm.all_gather(one_rank, torch.zeros(8, cfg.T), "planted")
    colls, big = audit.audit_collectives(recs, 8)
    assert len(colls) == len(recs) and [c.site for c in big] == ["planted"]
    assert big[0].op == "all_gather" and big[0].numel == 8 * cfg.T


def test_one_rank_distribution_helpers(one_rank):
    x = torch.arange(6.0).reshape(3, 2)
    (xl,), layout = mh.distribute_batch(one_rank, (x,))
    assert torch.equal(xl, x) and layout.counts == (3,) and layout.offset(0) == 0
    assert layout.total == 3
    (xp,), valid, B = mh.distribute_batch_padded(one_rank, (x,))
    assert B == 3 and torch.equal(xp, x) and bool(valid.all())
    assert torch.equal(mh.gather(one_rank, x), x)
    assert torch.equal(mh.replicate(one_rank, {"a": x})["a"], x)


def test_one_rank_train_step_matches_the_one_process_step(one_rank):
    """multihost_train_step on one rank against the one-process step (the
    same solve and IFT backward; the loss and gradient weighted by the
    example count and divided by it: 1e-12 at f64), and optim.rmsprop
    against optax.rmsprop over a pytree."""
    cfg, x0, cost, dyn, params = _grad_problem()
    q, p = pendulum.get_true_obj(dtype=F64)
    ue = 0.1 * torch.from_numpy(np.random.RandomState(5).randn(8, cfg.T, 1))
    opt = rmsprop(1e-2, decay=0.5)
    step = mh.multihost_train_step(one_rank, cfg, dyn, opt)
    with audit.recording() as recs:
        new, state, loss = step(params, opt.init(params), x0, ue, q, p)
    ref, ref_state, ref_loss = one_process_step(cfg, dyn, opt, params, opt.init(params), x0,
                                                ue, q, p)
    torch.testing.assert_close(new, ref, rtol=0, atol=1e-12)
    torch.testing.assert_close(state, ref_state, rtol=1e-12, atol=0)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-12, atol=0)
    assert (new - params).abs().max() > 0
    steps = [c for c in recs if c.site == "train_step"]
    assert len(steps) == 1 and steps[0].numel == params.numel() + 2

    jopt = optax.rmsprop(1e-2, decay=0.5)
    tree = {"a": np.array([1.0, -2.0]), "b": (np.array([[0.5]]),)}
    grads = {"a": np.array([0.3, 0.1]), "b": (np.array([[-2.0]]),)}
    jnew = optax.apply_updates(tree, jopt.update(grads, jopt.init(tree), tree)[0])
    tt = jax.tree_util.tree_map(torch.from_numpy, tree)
    tnew, _ = opt.update(tt, jax.tree_util.tree_map(torch.from_numpy, grads), opt.init(tt))
    np.testing.assert_allclose(tnew["a"].numpy(), np.asarray(jnew["a"]), atol=1e-12)
    np.testing.assert_allclose(tnew["b"][0].numpy(), np.asarray(jnew["b"][0]), atol=1e-12)


def test_initialize_refuses_what_it_cannot_do(tmp_path, monkeypatch):
    """No fallback: NCCL without a CUDA device, a CUDA device without CUDA,
    and no cluster at all raise; nothing is initialized."""
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises(ValueError, match="NCCL"):
        mh.initialize(store, 1, 0, device="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mh.initialize(store, 1, 0)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        mh.initialize()
    with pytest.raises(RuntimeError, match="initialize"):
        mh.global_batch_mesh()
    assert not torch.distributed.is_initialized()
