"""torch.func.vmap over the port's solve, held against jax.vmap over the JAX
package's (tests/test_vmap_fused.py, tests/test_fused_fuzz.py:109-129),
case for case: cost, x_init and params sweeps and a nested vmap on the
pendulum, a batched bound, u_init, LinDx F, the slew rate, MPC.__call__
with exit_unconverged and backprop=False (the gradients of a sweep:
tests/test_torch_vmap_grad.py). On CPU tensors the solve runs the plain loop, so the sweep
takes the mapped route (one solve a candidate, each with its own stopping
rule, as JAX's vmap over its XLA while_loop); the merged route (the sweep
folded into one solve of S*B examples, the whole-solve kernel's) is driven
here through the kernel's plain version by letting the dispatch ignore the
device. Inputs are made with numpy from a seed, T=5, B=4, lqr_iter 3.

Tolerances: 1e-6 at f64 against JAX's XLA path (tests/test_torch_solve.py);
the merged route against JAX's merged Pallas route (interpret mode) at
tests/test_torch_ilqr_fused.py's f32 bars (u 2e-3, x 5e-3, costs 1e-5);
the merged route against the hand-folded solve: the same bits."""
import dataclasses
import importlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.models import pendulum as jpend
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.core import ilqr
from dilqr_tpu_torch.diff import modes as M
from dilqr_tpu_torch.models import pendulum as tpend
from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused

importlib.import_module("dilqr_tpu.ops.pallas.ilqr_fused")
jfused = sys.modules["dilqr_tpu.ops.pallas.ilqr_fused"]

B, T, S = 4, 5, 3


def _data(seed=0):
    rng = np.random.RandomState(seed)
    th = rng.uniform(-1.0, 1.0, B)
    q, p = (np.asarray(a, np.float64) for a in jpend.get_true_obj())
    return dict(
        x0=np.stack([np.cos(th), np.sin(th), 0.3 * rng.randn(B)], 1),
        params=np.asarray(jpend.default_params(), np.float64), q=q, p=p,
        scales=np.linspace(0.5, 2.0, S), shifts=0.1 * rng.randn(S, B, 3),
        his=np.array([0.5, 1.0, 2.0]), u0=0.3 * rng.randn(S, B, T, 1),
        F=np.concatenate([np.eye(3) + 0.1 * rng.randn(T - 1, 3, 3), 0.1 + 0.1 * rng.randn(
            T - 1, 3, 1)], -1), f=0.05 * rng.randn(T - 1, 3), wx=rng.randn(S, B, T, 3),
        wu=rng.randn(S, B, T, 1))


def _kw(**kw):
    dyn = jpend.make()
    base = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=3, eps=1e-4,
                linesearch_decay=dyn.linesearch_decay,
                max_linesearch_iter=dyn.max_linesearch_iter,
                exit_unconverged=False, detach_unconverged=False, backprop=False)
    base.update(kw)
    return base


def _sides(dtype=torch.float64):
    """(numpy -> JAX array, numpy -> tensor), both at the test's dtype."""
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (lambda a: jnp.asarray(a, jd)), (lambda a: from_numpy(a, dtype=dtype))


def _reset():
    M.VMAP_STATS.update(dict.fromkeys(M.VMAP_STATS, 0))
    jfused.DISPATCH_STATS.update(fused=0, vmap_merged=0, vmap_mapped=0)


def _routes(**moved):
    """VMAP_STATS after _reset when the routes named moved: every other
    count 0 (the backward's too)."""
    return dict(dict.fromkeys(M.VMAP_STATS, 0), **moved)


# the sweeps of tests/test_vmap_fused.py: (the swept input, what one solve
# returns). Each function takes the package, its env module, the problem
# and the swept value.
def _cost_sweep(pkg, env, d, s, cfg):
    dyn = env.make()
    return pkg.solve(cfg, d["x0"], pkg.QuadCost(d["C"] * s, d["p"]), dyn, params=d["params"],
                     u_lower=-2.0, u_upper=2.0)


def _x_init_sweep(pkg, env, d, dx, cfg):
    return pkg.solve(cfg, d["x0"] + dx, pkg.QuadCost(d["C"], d["p"]), env.make(),
                     params=d["params"], u_lower=-2.0, u_upper=2.0)


def _params_sweep(pkg, env, d, pp, cfg):
    return pkg.solve(cfg, d["x0"], pkg.QuadCost(d["C"], d["p"]), env.make(), params=pp,
                     u_lower=-2.0, u_upper=2.0)


def _bound_sweep(pkg, env, d, h, cfg):
    return pkg.solve(cfg, d["x0"], pkg.QuadCost(d["C"], d["p"]), env.make(),
                     params=d["params"], u_lower=-h, u_upper=h)


def _u_init_sweep(pkg, env, d, u0, cfg):
    return pkg.solve(cfg, d["x0"], pkg.QuadCost(d["C"], d["p"]), env.make(),
                     params=d["params"], u_init=u0, u_lower=-2.0, u_upper=2.0)


def _lindx_sweep(pkg, env, d, s, cfg):
    # F [T-1, nx, n] and f [T-1, nx], each example's
    return pkg.solve(cfg, d["x0"], pkg.QuadCost(d["C"], d["p"]), pkg.LinDx(d["F"] * s, d["f"]),
                     u_lower=-2.0, u_upper=2.0)


def _slew_sweep(pkg, env, d, s, cfg):
    return _cost_sweep(pkg, env, d, s, dataclasses.replace(cfg, slew_rate_penalty=1.0))


SWEEPS = {"cost": (_cost_sweep, "scales"), "x_init": (_x_init_sweep, "shifts"),
          "params": (_params_sweep, None), "bound": (_bound_sweep, "his"),
          "u_init": (_u_init_sweep, "u0"), "lindx": (_lindx_sweep, "scales"),
          "slew": (_slew_sweep, "scales")}


def _swept(d, key):
    return d[key] if key else np.stack([d["params"], d["params"] * np.array([1.1, 0.9, 1.05]),
                                        d["params"] * 0.95])


def _problem(d, conv):
    out = {k: conv(d[k]) for k in ("x0", "params", "p")}
    out["C"] = conv(np.diag(d["q"]))
    out["f"], out["F"] = conv(d["f"]), conv(d["F"])
    return out


def _assert_close(got, want, names=("x", "u", "costs")):
    for n in names:
        np.testing.assert_allclose(getattr(got, n).numpy(), np.asarray(getattr(want, n)),
                                   atol=1e-6, rtol=0, err_msg=n)


@pytest.mark.parametrize("sweep", list(SWEEPS))
def test_vmap_sweep_matches_jax_xla_f64(sweep):
    """Each sweep on the plain loop (the mapped route, counted) against
    jax.vmap over JAX's XLA solve, x, u and costs at f64. The LinDx sweep
    solves F's candidates as LinDx problems; the slew rate solves the
    augmented problem under each candidate."""
    fn, key = SWEEPS[sweep]
    d = _data()
    jc, tc = _sides()
    _reset()
    jcfg = J.ILQRConfig(backend="xla", **_kw())
    jd = _problem(d, jc)
    want = jax.vmap(lambda v: fn(J, jpend, jd, v, jcfg))(jc(_swept(d, key)))
    td = _problem(d, tc)
    got = torch.func.vmap(lambda v: fn(P, tpend, td, v, P.ILQRConfig(**_kw())))(
        tc(_swept(d, key)))
    assert M.VMAP_STATS == _routes(vmap_mapped=1)
    _assert_close(got, want)
    assert tuple(got.n_iter.shape) == (S,)


def test_nested_vmap_matches_jax_xla_f64():
    """vmap of vmap (test_vmap_fused.py:97-116): the rule maps the inner
    level's 2 candidates first, and each candidate's apply re-enters it at
    the outer level."""
    d = _data()
    jc, tc = _sides()
    jcfg, tcfg = J.ILQRConfig(backend="xla", **_kw()), P.ILQRConfig(**_kw())
    jd, td = _problem(d, jc), _problem(d, tc)

    def run(pkg, env, dd, cfg, s, dx):
        return pkg.solve(cfg, dd["x0"] + dx, pkg.QuadCost(dd["C"] * s, dd["p"]), env.make(),
                         params=dd["params"], u_lower=-2.0, u_upper=2.0).costs

    shifts = d["shifts"][:2]
    want = jax.vmap(lambda s: jax.vmap(lambda dx: run(J, jpend, jd, jcfg, s, dx))(
        jc(shifts)))(jc(d["scales"]))
    _reset()
    got = torch.func.vmap(lambda s: torch.func.vmap(lambda dx: run(P, tpend, td, tcfg, s, dx))(
        tc(shifts)))(tc(d["scales"]))
    assert got.shape == (S, 2, B) and M.VMAP_STATS["vmap_mapped"] == 1 + 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("what", ["mpc_exit_unconverged", "backprop_false"])
def test_vmap_mpc_call_matches_jax_xla_f64(what):
    """MPC.__call__ under vmap: with exit_unconverged=True (MPC's default)
    it warns per candidate where the tensors are real and does not raise;
    with backprop=False nothing requires grad. x, u, costs as JAX's."""
    d = _data()
    jc, tc = _sides()
    kw = dict(u_lower=-2.0, u_upper=2.0, lqr_iter=3, eps=1e-4, linesearch_decay=0.2,
              max_linesearch_iter=10, exit_unconverged=what == "mpc_exit_unconverged",
              backprop=what != "backprop_false")
    jd, td = _problem(d, jc), _problem(d, tc)
    jm = J.MPC(3, 1, T, **kw)
    jm.cfg = dataclasses.replace(jm.cfg, backend="xla")
    want = jax.vmap(lambda s: jm(jd["x0"], J.QuadCost(jd["C"] * s, jd["p"]), jpend.make(),
                                 params=jd["params"]))(jc(d["scales"]))
    tm = P.MPC(3, 1, T, **kw)
    params = td["params"].clone().requires_grad_(True)
    _reset()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = torch.func.vmap(lambda s: tm(td["x0"], P.QuadCost(td["C"] * s, td["p"]),
                                           tpend.make(), params=params))(tc(d["scales"]))
    msgs = [str(w.message) for w in rec if "did not converge" in str(w.message)]
    if what == "mpc_exit_unconverged":
        assert len(msgs) == S and all(m.endswith("mpc.py:323-324)") and f"/{B} " in m
                                      for m in msgs), msgs
    else:
        assert not msgs and not got[1].requires_grad
    assert M.VMAP_STATS["vmap_mapped"] == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-6, rtol=0)


def _on_cpu_kernel(monkeypatch):
    """Let the dispatch take the whole-solve kernel on CPU tensors: its
    plain version (ilqr_fused_reference) runs, as the kernel's stand-in."""
    def use_kernel(cfg, cost, dyn, params, x_init, u_zero_I, delta_u, cost_small, u_lower,
                   u_upper, u_init_zero=False):
        return cfg.backend != "torch" and isinstance(cost, P.QuadCost) and fused.covered(
            cfg, dyn, params, x_init.dtype, cost_small, u_zero_I, delta_u, u_lower, u_upper,
            u_init_zero=u_init_zero)

    monkeypatch.setattr(ilqr, "use_kernel", use_kernel)


def test_merged_route_matches_jax_pallas_vmap(monkeypatch):
    """The merged route's fold and unfold: a sweep over the cost, the start
    and a scalar bound at once, folded into one solve of S*B examples
    through the kernel's plain version at f32 and eps=0, against jax.vmap
    over JAX's Pallas solve (interpret mode), which merges it too."""
    _on_cpu_kernel(monkeypatch)
    d = _data(1)
    jc, tc = _sides(torch.float32)
    kw = _kw(eps=0.0)
    jd, td = _problem(d, jc), _problem(d, tc)

    def run(pkg, env, dd, cfg, s, dx, h):
        return pkg.solve(cfg, dd["x0"] + dx, pkg.QuadCost(dd["C"] * s, dd["p"]), env.make(),
                         params=dd["params"], u_lower=-h, u_upper=h)

    args = ("scales", "shifts", "his")
    _reset()
    want = jax.vmap(lambda *a: run(J, jpend, jd, J.ILQRConfig(backend="pallas", **kw), *a))(
        *(jc(0.1 * d[k] if k == "shifts" else d[k]) for k in args))
    assert jfused.DISPATCH_STATS["vmap_merged"] == 1
    got = torch.func.vmap(lambda *a: run(P, tpend, td, P.ILQRConfig(**kw), *a))(
        *(tc(0.1 * d[k] if k == "shifts" else d[k]) for k in args))
    assert M.VMAP_STATS == _routes(vmap_merged=1)
    for n, atol in (("u", 2e-3), ("x", 5e-3), ("costs", 1e-5)):
        np.testing.assert_allclose(getattr(got, n).numpy(), np.asarray(getattr(want, n)),
                                   atol=atol, rtol=1e-5 if n == "costs" else 0, err_msg=n)
    # one solve: its n_iter, the max over every candidate, broadcast by vmap
    assert got.n_iter.tolist() == [int(want.n_iter.max())] * S


@pytest.mark.parametrize("sweep", ["cost_and_x_init", "bound_u_init_params_shared", "lindx"])
def test_merged_route_has_the_hand_folded_bits(monkeypatch, sweep):
    """The merged route is the hand-folded solve of S*B examples,
    candidate-major (example s*B + b), bit for bit: the compact cost
    promoted to the per-example pair, a batched bound as [T, S*B, nu], a
    batched warm start and a LinDx F folded along the example axis. With
    B = 4 every candidate shares the one tile, hence eps=0."""
    _on_cpu_kernel(monkeypatch)
    _reset()
    d = _data(2)
    _, tc = _sides(torch.float32)
    td = _problem(d, tc)
    cfg = P.ILQRConfig(**_kw(eps=0.0))
    dyn = tpend.make()
    C, p = td["C"], td["p"]
    if sweep == "cost_and_x_init":
        s, dx = tc(d["scales"]), tc(d["shifts"])
        got = torch.func.vmap(lambda s_, dx_: P.solve(
            cfg, td["x0"] + dx_, P.QuadCost(C * s_, p), dyn, params=td["params"],
            u_lower=-2.0, u_upper=2.0))(s, dx)
        Cf = (C * s[:, None, None]).repeat_interleave(B, 0)[:, None].expand(-1, T, -1, -1)
        want = P.solve(cfg, (td["x0"] + dx).reshape(S * B, 3), P.QuadCost(Cf, p.expand(
            S * B, T, 4)), dyn, params=td["params"], u_lower=-2.0, u_upper=2.0)
    elif sweep == "bound_u_init_params_shared":
        h, u0 = tc(d["his"]), tc(d["u0"])
        got = torch.func.vmap(lambda h_, u_: P.solve(
            cfg, td["x0"], P.QuadCost(C, p), dyn, params=td["params"], u_init=u_,
            u_lower=-h_, u_upper=h_))(h, u0)
        hf = h.repeat_interleave(B)[:, None, None].expand(-1, T, 1)
        want = P.solve(cfg, td["x0"].repeat(S, 1), P.QuadCost(C, p), dyn, params=td["params"],
                       u_init=u0.reshape(S * B, T, 1), u_lower=-hf, u_upper=hf)
    else:
        s = tc(d["scales"])
        F, f = td["F"], td["f"]
        got = torch.func.vmap(lambda s_: P.solve(
            cfg, td["x0"], P.QuadCost(C, p), P.LinDx(F * s_, f), u_lower=-2.0, u_upper=2.0))(s)
        Ff = (F * s[:, None, None, None]).repeat_interleave(B, 0)
        want = P.solve(cfg, td["x0"].repeat(S, 1), P.QuadCost(C, p), P.LinDx(Ff, f),
                       u_lower=-2.0, u_upper=2.0)
    assert M.VMAP_STATS == _routes(vmap_merged=1)
    for n in ("x", "u", "costs", "full_du_norm"):
        a = getattr(got, n)
        assert torch.equal(a.reshape((S * B,) + a.shape[2:]), getattr(want, n)), n
    assert got.n_iter.tolist() == [int(want.n_iter)] * S


def test_zero_dim_bound_keeps_the_static_bounds(monkeypatch):
    """A 0-d tensor bound stays a tensor through canonicalize_bound (so that
    a vmap over it is a batched bound) and reaches the kernel as the number
    would: the same static bounds in prepare, no per-example bound tensor,
    and the same bits through the kernel's plain version and the plain loop."""
    _on_cpu_kernel(monkeypatch)
    d = _data(4)
    _, tc = _sides(torch.float32)
    td = _problem(d, tc)
    dyn = tpend.make()
    cost = P.QuadCost(td["C"], td["p"])
    lo, hi = torch.tensor(-1.5), torch.tensor(1.5)
    cfg = P.ILQRConfig(**_kw())
    a, b = (fused.prepare(cfg, dyn, td["params"], td["x0"], (td["C"], td["p"]), None, l, h,
                          None, None, fused.TILE) for l, h in ((lo, hi), (-1.5, 1.5)))
    assert (a.lo, a.hi, a.lb, a.ub) == (b.lo, b.hi, None, None) == ((-1.5,), (1.5,), None, None)
    for backend in ("auto", "torch"):  # the kernel's plain version, the plain loop
        c = dataclasses.replace(cfg, backend=backend)
        got = P.solve(c, td["x0"], cost, dyn, params=td["params"], u_lower=lo, u_upper=hi)
        want = P.solve(c, td["x0"], cost, dyn, params=td["params"], u_lower=-1.5, u_upper=1.5)
        for n in ("x", "u", "costs", "full_du_norm"):
            assert torch.equal(getattr(got, n), getattr(want, n)), (backend, n)


def test_unroll_under_vmap_maps_each_candidate():
    """BackwardMode.UNROLL under vmap no longer raises torch's
    data-dependent control-flow error: the unrolled solve is a Function
    (diff/modes._Unrolled) whose vmap rule maps, one plain-loop solve a
    candidate with its own stopping rule, each with its own solve's bits."""
    d = _data()
    _, tc = _sides()
    td = _problem(d, tc)
    cfg = P.ILQRConfig(**_kw(backprop=True, backward_mode=P.BackwardMode.UNROLL, unroll=True))
    _reset()
    got = torch.func.vmap(lambda s: _cost_sweep(P, tpend, td, s, cfg).u)(tc(d["scales"]))
    assert M.VMAP_STATS == _routes(vmap_mapped=1)
    for s, scale in enumerate(tc(d["scales"])):
        assert torch.equal(got[s], _cost_sweep(P, tpend, td, scale, cfg).u)
