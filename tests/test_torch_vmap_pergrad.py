"""Per-candidate gradients through the port's solve: torch.func.vmap over
torch.func.grad, jacrev, vmap over a vjp and autograd.grad(...,
is_grads_batched=True), UNROLL under vmap and a batched delta_u, held
against the JAX package's jax.vmap(jax.grad(...)), jax.jacrev and jax.vmap
(XLA path, under jax.jit, which takes a third of eager's time for IFT) at
f64, 1e-6 of the largest entry (tests/test_torch_vmap_grad.py's bar). On
CPU tensors every backward takes the mapped route (one backward a
candidate, each with its own GMRES exit rule); the merged route (one
backward of S*B examples, the KKT kernel's) is driven through the kernels'
plain versions by letting both dispatches ignore the device. Inputs and
helpers are tests/test_torch_vmap.py's (T=5, B=4, S=3, lqr_iter 3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.models import pendulum as jpend
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.diff import kkt
from dilqr_tpu_torch.diff import modes as M
from dilqr_tpu_torch.models import pendulum as tpend
from dilqr_tpu_torch.ops.cuda import kkt_fused
from test_torch_vmap import B, S, T, _data, _kw, _on_cpu_kernel, _reset, _routes

BOX = dict(u_lower=-2.0, u_upper=2.0)


def _cfgs(mode, **kw):
    """(JAX's config on its XLA path, the port's) for a backward mode."""
    kw = _kw(backprop=True, unroll=mode == "UNROLL", **kw)
    return (J.ILQRConfig(backend="xla", backward_mode=getattr(J.BackwardMode, mode), **kw),
            P.ILQRConfig(backward_mode=getattr(P.BackwardMode, mode), **kw))


def _close(got, want, names, sym=()):
    """Each pair within 1e-6 of want's largest entry; the names in ``sym``
    (dC: the IFT/KKT cotangent is the symmetrized one) after symmetrizing."""
    for g, w, n in zip(got, want, names):
        g, w = g.detach().numpy(), np.asarray(w)
        if n in sym:
            g, w = 0.5 * (g + np.swapaxes(g, -1, -2)), 0.5 * (w + np.swapaxes(w, -1, -2))
        assert g.shape == w.shape, (n, g.shape, w.shape)
        err = np.abs(g - w).max() / max(1.0, np.abs(w).max())
        assert err <= 1e-6, f"{n}: rel err {err:.2e}"


def _loss(pkg, env, cfg, params, C, c, x0, s, wx, wu):
    r = pkg.solve(cfg, x0, pkg.QuadCost(C * s, c), env.make(), params=params, **BOX)
    return (r.u * wu).sum() + (r.x * wx).sum()


@pytest.mark.parametrize("mode", ["IFT", "KKT", "UNROLL"])
def test_vmap_grad_matches_jax_f64(mode):
    """vmap(grad(loss)) over S cost scales (each with its own loss weights)
    with respect to the shared params, the cost and the starts: one
    gradient a candidate, a candidate's param gradient summing its own
    examples, against jax.vmap(jax.grad(...)); the forward and the
    backward each take the mapped route once."""
    d = _data(3)
    jcfg, tcfg = _cfgs(mode)
    ins = (d["params"], np.diag(d["q"]), d["p"], d["x0"])
    per = (d["scales"], d["wx"], d["wu"])
    axes = (None,) * 4 + (0,) * 3
    want = jax.jit(jax.vmap(jax.grad(lambda *a: _loss(J, jpend, jcfg, *a),
                                        argnums=(0, 1, 2, 3)), in_axes=axes))(
        *(jnp.asarray(a) for a in ins + per))
    _reset()
    got = torch.func.vmap(torch.func.grad(lambda *a: _loss(P, tpend, tcfg, *a),
                                          argnums=(0, 1, 2, 3)),
                          in_dims=axes)(*(from_numpy(a) for a in ins + per))
    assert M.VMAP_STATS == _routes(vmap_mapped=1, bwd_mapped=1)
    _close(got, want, ("dparams", "dC", "dc", "dx_init"), sym=("dC",))


def test_lindx_sweep_vmap_grad_matches_jax_f64():
    """A LinDx F sweep's vmap(grad) (KKT, exact for constant F and f) with
    respect to the cost, the start, F and f, against JAX's."""
    d = _data(3)
    jcfg, tcfg = _cfgs("KKT")

    def loss(pkg, cfg, C, c, x0, F, f, s, wx, wu):
        r = pkg.solve(cfg, x0, pkg.QuadCost(C, c), pkg.LinDx(F * s, f), **BOX)
        return (r.u * wu).sum() + (r.x * wx).sum()

    ins = (np.diag(d["q"]), d["p"], d["x0"], d["F"], d["f"])
    per = (d["scales"], d["wx"], d["wu"])
    axes = (None,) * 5 + (0,) * 3
    argnums = (0, 1, 2, 3, 4)
    want = jax.jit(jax.vmap(jax.grad(lambda *a: loss(J, jcfg, *a), argnums=argnums),
                            in_axes=axes))(*(jnp.asarray(a) for a in ins + per))
    _reset()
    got = torch.func.vmap(torch.func.grad(lambda *a: loss(P, tcfg, *a), argnums=argnums),
                          in_dims=axes)(*(from_numpy(a) for a in ins + per))
    assert M.VMAP_STATS == _routes(vmap_mapped=1, bwd_mapped=1)
    _close(got, want, ("dC", "dc", "dx_init", "dF", "df"), sym=("dC",))


def _u_sums(pkg, env, cfg):
    """(params, x0) -> each example's summed control, [B]."""
    def f(params, x0, C, c):
        r = pkg.solve(cfg, x0, pkg.QuadCost(C, c), env.make(), params=params, **BOX)
        return r.u[..., 0].sum(-1)
    return f


def test_jacrev_matches_jax_f64():
    """jacrev of each example's summed control with respect to the params
    and the starts (IFT): one forward, then the backward vmapped over the B
    one-hot cotangents (mapped on the CPU), against jax.jacrev."""
    d = _data(3)
    jcfg, tcfg = _cfgs("IFT")
    ins = (d["params"], d["x0"], np.diag(d["q"]), d["p"])
    want = jax.jit(jax.jacrev(_u_sums(J, jpend, jcfg), argnums=(0, 1)))(
        *(jnp.asarray(a) for a in ins))
    _reset()
    got = torch.func.jacrev(_u_sums(P, tpend, tcfg), argnums=(0, 1))(
        *(from_numpy(a) for a in ins))
    assert M.VMAP_STATS == _routes(bwd_mapped=1)
    _close(got, want, ("d/dparams [B, 3]", "d/dx_init [B, B, 3]"))


@pytest.mark.parametrize("how", ["vmap_vjp", "is_grads_batched"])
def test_batched_vjps_are_the_jacrev_rows(how):
    """vmap over a torch.func.vjp, and autograd.grad with
    is_grads_batched=True (torch's older vmap, unwrapped by the backward by
    hand), give jacrev's rows, the same backwards one a row."""
    d = _data(3)
    _, tcfg = _cfgs("IFT")
    f = _u_sums(P, tpend, tcfg)
    ins = [from_numpy(a) for a in (d["params"], d["x0"], np.diag(d["q"]), d["p"])]
    rows = torch.func.jacrev(f, argnums=(0, 1))(*ins)
    eye = torch.eye(B, dtype=torch.float64)
    _reset()
    if how == "vmap_vjp":
        _, vjp = torch.func.vjp(lambda p_, x_: f(p_, x_, *ins[2:]), *ins[:2])
        got = torch.func.vmap(vjp)(eye)
    else:
        leaves = [a.clone().requires_grad_(True) for a in ins[:2]]
        got = torch.autograd.grad(f(*leaves, *ins[2:]), leaves, eye, is_grads_batched=True)
    assert M.VMAP_STATS == _routes(bwd_mapped=1)
    for g, w in zip(got, rows):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sweep", ["unroll_solve", "delta_u", "delta_u_grad"])
def test_unroll_and_delta_u_sweeps_match_jax_f64(sweep):
    """vmap over the UNROLL solve (cost scales; plain autograd through the
    loop in JAX, one solve a candidate here), a delta_u sweep (the mapped
    route: the kernel reads one static delta_u, and JAX keeps it out of its
    fold), and the KKT gradient through the delta_u sweep, against jax.vmap
    over JAX's XLA path."""
    d = _data(3)
    mode = "UNROLL" if sweep == "unroll_solve" else "KKT"
    jcfg, tcfg = _cfgs(mode)
    dus = np.array([0.1, 0.5, 1.0])

    def run(pkg, env, cfg, params, C, c, x0, v):
        if sweep == "unroll_solve":
            return pkg.solve(cfg, x0, pkg.QuadCost(C * v, c), env.make(), params=params, **BOX)
        return pkg.solve(cfg, x0, pkg.QuadCost(C, c), env.make(), params=params, delta_u=v,
                         **BOX)

    ins = (d["params"], np.diag(d["q"]), d["p"], d["x0"])
    vs = d["scales"] if sweep == "unroll_solve" else dus
    axes = (None,) * 4 + (0,)
    _reset()
    if sweep == "delta_u_grad":
        def loss(pkg, env, cfg, *a):
            r = run(pkg, env, cfg, *a)
            conv = jnp.asarray if pkg is J else from_numpy
            return (r.u * conv(d["wu"][0])).sum() + (r.x * conv(d["wx"][0])).sum()

        want = jax.jit(jax.vmap(jax.grad(lambda *a: loss(J, jpend, jcfg, *a), argnums=(0, 3)),
                                   in_axes=axes))(*(jnp.asarray(a) for a in ins + (vs,)))
        got = torch.func.vmap(torch.func.grad(lambda *a: loss(P, tpend, tcfg, *a),
                                              argnums=(0, 3)), in_dims=axes)(
            *(from_numpy(a) for a in ins + (vs,)))
        assert M.VMAP_STATS == _routes(vmap_mapped=1, bwd_mapped=1)
        _close(got, want, ("dparams", "dx_init"))
        return
    want = jax.jit(jax.vmap(lambda *a: run(J, jpend, jcfg, *a), in_axes=axes))(
        *(jnp.asarray(a) for a in ins + (vs,)))
    got = torch.func.vmap(lambda *a: run(P, tpend, tcfg, *a), in_dims=axes)(
        *(from_numpy(a) for a in ins + (vs,)))
    assert M.VMAP_STATS == _routes(vmap_mapped=1)
    _close([got.x, got.u, got.costs], [want.x, want.u, want.costs], ("x", "u", "costs"))
    if sweep == "delta_u":  # each candidate is the solve at its own delta_u
        for s, v in enumerate(from_numpy(dus)):
            one = run(P, tpend, tcfg, *(from_numpy(a) for a in ins), v)
            assert torch.equal(got.u[s], one.u) and torch.equal(got.x[s], one.x)


def _kkt_on_cpu(monkeypatch):
    """Let the KKT dispatch take the kernel's wrapper on CPU tensors, which
    runs its plain version (kkt_fused_reference) there: the stand-in for a
    covered shape on the card."""
    def use_kernel(T_, n_state, n_ctrl, like, backend="auto", parallel=False):
        return (backend != "torch" and not parallel
                and kkt_fused.covered(T_, n_state, n_ctrl, like.dtype))

    monkeypatch.setattr(kkt, "use_kernel", use_kernel)


@pytest.mark.parametrize("mode", ["IFT", "KKT", "jacrev"])
def test_merged_backward_is_the_hand_folded_backward(monkeypatch, mode):
    """The merged backward: vmap(grad) over S cost scales at f32, eps=0,
    through the kernels' plain versions -- one folded forward (the
    hand-folded solve's bits) and one folded backward, whose per-example
    cotangents (the starts, the cost) are the hand-folded backward's and
    whose per-candidate param cotangents are the hand-folded backward's with
    the per-candidate param reduction (modes._backward with the params given
    per example, each candidate's examples summed; their sum the whole
    gradient), all within 1e-6 of the largest entry. jacrev: one forward of
    B examples, its backward folded over the B one-hot cotangents (the saved
    trajectory tiled), against the one-hot loop."""
    _on_cpu_kernel(monkeypatch)
    _kkt_on_cpu(monkeypatch)
    d = _data(3)
    tc = lambda a: from_numpy(a, dtype=torch.float32)  # noqa: E731
    bwd = "IFT" if mode == "jacrev" else mode
    cfg = P.ILQRConfig(**_kw(eps=0.0, backprop=True, backward_mode=getattr(P.BackwardMode, bwd)))
    dyn = tpend.make()
    C, c, x0, params = tc(np.diag(d["q"])), tc(d["p"]), tc(d["x0"]), tc(d["params"])
    s, wx, wu = tc(d["scales"]), tc(d["wx"]), tc(d["wu"])
    _reset()
    if mode == "jacrev":
        got = torch.func.jacrev(_u_sums(P, tpend, cfg), argnums=(0, 1))(params, x0, C, c)
        assert M.VMAP_STATS == _routes(bwd_merged=1)
        pr, xl = params.clone().requires_grad_(True), x0.clone().requires_grad_(True)
        out = _u_sums(P, tpend, cfg)(pr, xl, C, c)
        rows = [torch.autograd.grad(out, (pr, xl), e, retain_graph=True)
                for e in torch.eye(B)]
        for g, w in zip(got, (torch.stack([r[i] for r in rows]) for i in range(2))):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * w.abs().max().item())
        return

    got = torch.func.vmap(torch.func.grad(lambda *a: _loss(P, tpend, cfg, *a),
                                          argnums=(0, 1, 2, 3)),
                          in_dims=(None,) * 4 + (0,) * 3)(params, C, c, x0, s, wx, wu)
    assert M.VMAP_STATS == _routes(vmap_merged=1, bwd_merged=1)
    # the hand-folded solve, its leaves per folded example
    pr = params.clone().requires_grad_(True)
    Cf = (C * s[:, None, None]).repeat_interleave(B, 0)[:, None].expand(-1, T, -1, -1)
    Cf, cf, xf = (a.clone().requires_grad_(True) for a in (Cf, c.expand(S * B, T, 4),
                                                            x0.repeat(S, 1)))
    r = P.solve(cfg, xf, P.QuadCost(Cf, cf), dyn, params=pr, **BOX)
    xs, us = r.x.reshape(S, B, T, 3), r.u.reshape(S, B, T, 1)
    fwd = torch.func.vmap(lambda s_: P.solve(dataclasses.replace(cfg, backprop=False), x0,
                                             P.QuadCost(C * s_, c), dyn, params=params,
                                             **BOX))(s)
    for n in ("x", "u", "costs", "full_du_norm"):
        a = getattr(fwd, n)
        assert torch.equal(a.reshape((S * B,) + a.shape[2:]), getattr(r, n)), n
    dC, dc, dx, whole = torch.autograd.grad((xs * wx).sum() + (us * wu).sum(), (Cf, cf, xf, pr))
    Ct, ct = Cf.detach().transpose(0, 1), cf.detach().transpose(0, 1)
    prob, _ = M._problem(cfg, P.QuadCost(Ct, ct), dyn, params)
    # [S, B, T, k] -> [T, S*B, k], candidate-major
    fold = lambda a: a.permute(2, 0, 1, 3).reshape(T, S * B, -1)  # noqa: E731
    *_, d_pe = M._backward(prob, r.x.detach().transpose(0, 1), r.u.detach().transpose(0, 1),
                           r.full_du_norm, -2.0, 2.0, (Ct, ct), params.expand(S * B, -1),
                           fold(wx), fold(wu))
    g_params, g_C, g_c, g_x0 = got
    want = (d_pe.unflatten(0, (S, B)).sum(1), dC.reshape(S, B, T, 4, 4).sum((1, 2))
            * s[:, None, None], dc.reshape(S, B, T, 4).sum((1, 2)), dx.reshape(S, B, 3))
    for g, w, n in zip((g_params, g_C, g_c, g_x0), want, ("dparams", "dC", "dc", "dx_init")):
        err = ((g - w).abs().max() / w.abs().max()).item()
        assert err <= 1e-6, f"{n}: rel err {err:.2e}"
    err = ((g_params.sum(0) - whole).abs().max() / whole.abs().max()).item()
    assert err <= 1e-6, f"the candidates' param gradients do not sum to the whole: {err:.2e}"


@pytest.mark.parametrize("mode", ["IFT", "KKT", "UNROLL"])
def test_unvmapped_gradients_keep_their_bits(mode):
    """Without vmap the backward is the same computation as before it
    became a Function: IFT and KKT through _SolveBackward equal a direct
    _backward call on the forward's outputs, bit for bit, and their
    gradient of a gradient raises. UNROLL takes both of its routes --
    plain autograd through the loop outside torch.func, _Unrolled (the loop
    recomputed in its backward) under torch.func.vjp -- and both equal
    plain autograd through prob.primal, bit for bit."""
    d = _data(3)
    _, cfg = _cfgs(mode)
    cfg = dataclasses.replace(cfg, detach_unconverged=False)
    dyn = tpend.make()
    rng = np.random.RandomState(5)
    gx, gu = from_numpy(rng.randn(T, B, 3)), from_numpy(rng.randn(T, B, 1))
    base = (from_numpy(d["x0"]), from_numpy(np.diag(d["q"])).expand(T, B, 4, 4),
            from_numpy(d["p"]).expand(T, B, 4), from_numpy(d["params"]))
    u0 = torch.zeros(T, B, 1, dtype=torch.float64)

    def run(x0, Ct, ct, params):
        x, u, _, du, _ = M.solve_with_grad(cfg, P.QuadCost(Ct, ct), dyn, params, x0, u0, -2.0,
                                           2.0, None, None)
        run.du = du
        return x, u

    ins = [a.clone().requires_grad_(True) for a in base]
    x, u = run(*ins)
    got = [torch.autograd.grad((x, u), ins, (gx, gu), retain_graph=True)]
    prob, _ = M._problem(cfg, P.QuadCost(*base[1:3]), dyn, base[3])
    if mode == "UNROLL":
        _reset()
        got.append(torch.func.vjp(run, *base)[1]((gx, gu)))
        assert M.VMAP_STATS == _routes()  # a vjp, not a vmap
        ref = [a.clone().requires_grad_(True) for a in base]
        xr, ur, *_ = prob.primal(ref[0], u0, -2.0, 2.0, None, None, None, tuple(ref[1:3]),
                                 ref[3])
        want = torch.autograd.grad((xr, ur), ref, (gx, gu))
    else:
        dxi, (dC, dc), dp = M._backward(prob, x.detach(), u.detach(), run.du, -2.0, 2.0,
                                        base[1:3], base[3], gx, gu)
        want = (dxi, dC, dc, dp)
        with pytest.raises(RuntimeError, match="not differentiable"):
            (g,) = torch.autograd.grad((x * gx).sum(), ins[3], create_graph=True)
            torch.autograd.grad(g.sum(), ins[3])
    for route in got:
        for g, w, n in zip(route, want, ("dx_init", "dC", "dc", "dparams")):
            assert torch.equal(g, w), n
