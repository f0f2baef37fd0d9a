"""The gradients of a torch.func.vmap sweep over the port's solve: the IFT
and KKT gradients of a loss summed over a cost sweep against jax.grad of
the JAX package's summed jax.vmap (XLA path) at f64, rtol 1e-6 of the
largest entry (tests/test_torch_grad.py's bar), and the merged route's
one backward of S*B examples against the hand-folded solve's. Inputs and
helpers are tests/test_torch_vmap.py's (T=5, B=4, lqr_iter 3); the file
stands apart so that the JAX gradient's compile runs beside that one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.models import pendulum as jpend
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.diff import modes as M
from dilqr_tpu_torch.models import pendulum as tpend
from test_torch_vmap import (B, S, T, _data, _kw, _on_cpu_kernel, _problem, _reset, _routes,
                             _sides)


@pytest.mark.parametrize("mode", ["IFT", "KKT"])
def test_vmap_sweep_grads_match_jax_f64(mode):
    """The gradient of a loss summed over a cost sweep, with respect to the
    shared params, the cost and the starts, against jax.grad of JAX's
    summed jax.vmap (XLA path) at f64."""
    d = _data(3)
    kw = _kw(backprop=True, lqr_iter=3)

    def jloss(params, C, c, x0):
        cfg = J.ILQRConfig(backend="xla", backward_mode=getattr(J.BackwardMode, mode), **kw)
        r = jax.vmap(lambda s: J.solve(cfg, x0, J.QuadCost(C * s, c), jpend.make(),
                                       params=params, u_lower=-2.0, u_upper=2.0))(
            jnp.asarray(d["scales"]))
        return jnp.sum(r.u * d["wu"]) + jnp.sum(r.x * d["wx"])

    ins = (d["params"], np.diag(d["q"]), d["p"], d["x0"])
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in ins))
    cfg = P.ILQRConfig(backward_mode=getattr(P.BackwardMode, mode), **kw)
    tins = [from_numpy(a).requires_grad_(True) for a in ins]
    params, C, c, x0 = tins
    r = torch.func.vmap(lambda s: P.solve(cfg, x0, P.QuadCost(C * s, c), tpend.make(),
                                          params=params, u_lower=-2.0, u_upper=2.0))(
        from_numpy(d["scales"]))
    loss = (r.u * from_numpy(d["wu"])).sum() + (r.x * from_numpy(d["wx"])).sum()
    got = torch.autograd.grad(loss, tins)
    for g, w, n in zip(got, want, ("dparams", "dC", "dc", "dx_init")):
        g, w = g.numpy(), np.asarray(w)
        if n == "dC":  # the IFT/KKT dC is the symmetrized cotangent
            g, w = 0.5 * (g + g.T), 0.5 * (w + w.T)
        err = np.abs(g - w).max() / max(1.0, np.abs(w).max())
        assert err <= 1e-6, f"{n}: rel err {err:.2e}"


def test_merged_route_grads_are_the_hand_folded_solves(monkeypatch):
    """Through the merged route autograd records one solve of S*B examples
    and one backward: its IFT gradients equal the hand-folded solve's."""
    _on_cpu_kernel(monkeypatch)
    d = _data(3)
    _, tc = _sides(torch.float32)
    td = _problem(d, tc)
    cfg = P.ILQRConfig(**_kw(eps=0.0, backprop=True, backward_mode=P.BackwardMode.IFT))
    dyn = tpend.make()
    s = tc(d["scales"])
    wx, wu = tc(d["wx"]), tc(d["wu"])

    def grads(fold):
        params = td["params"].clone().requires_grad_(True)
        x0 = td["x0"].clone().requires_grad_(True)
        if fold:
            Cf = (td["C"] * s[:, None, None]).repeat_interleave(B, 0)[:, None].expand(
                -1, T, -1, -1)
            r = P.solve(cfg, x0.repeat(S, 1), P.QuadCost(Cf, td["p"].expand(S * B, T, 4)), dyn,
                        params=params, u_lower=-2.0, u_upper=2.0)
            xs, us = r.x.reshape(S, B, T, 3), r.u.reshape(S, B, T, 1)
        else:
            r = torch.func.vmap(lambda s_: P.solve(cfg, x0, P.QuadCost(td["C"] * s_, td["p"]),
                                                   dyn, params=params, u_lower=-2.0,
                                                   u_upper=2.0))(s)
            xs, us = r.x, r.u
        return torch.autograd.grad((xs * wx).sum() + (us * wu).sum(), (params, x0))

    _reset()
    got = grads(False)
    assert M.VMAP_STATS == _routes(vmap_merged=1)
    for g, w in zip(got, grads(True)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
