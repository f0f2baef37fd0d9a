"""The plain reference (benchmark/reference, benchmark/configs/*.py) against
the port's plain path at a tiny size, in float64 on the CPU: one tile, so
that both decide over the same examples."""
from __future__ import annotations

import pytest
import torch

import cpu_cells  # noqa: F401

from benchmark.problem import Problem


def _port_solve(prob, x0, u0):
    import dilqr_tpu_torch as P

    mpc, dyn, cost = prob.program()
    return mpc.solve(x0, cost, dyn, params=prob.params, u_init=u0)


@pytest.mark.parametrize("name,B,tol", [("cartpole", 16, 1e-9), ("rocket", 8, 1e-6)])
def test_reference_solve_matches_port_plain_loop(name, B, tol):
    prob = Problem(name, "cpu")
    for k in ("params", "q", "p"):
        setattr(prob, k, getattr(prob, k).double())
    gen = torch.Generator().manual_seed(5)
    x0 = prob.start(gen, B).double()
    u0 = 0.3 * torch.randn(B, prob.T, prob.nu, generator=gen, dtype=torch.float64)
    ref = prob.solve_reference(x0, u0, tile=B)
    res = _port_solve(prob, x0, u0)
    rel = ((ref.costs - res.costs).abs() / ref.costs.abs().clamp(min=1.0)).max()
    assert rel < tol, rel
    assert (ref.u.transpose(0, 1) - res.u).abs().max() < 1e3 * tol


def test_models_match_port_models():
    from dilqr_tpu_torch.models import cartpole, rocket

    gen = torch.Generator().manual_seed(1)
    for name, mod, nx, nu in (("cartpole", cartpole, 5, 1), ("rocket", rocket, 13, 3)):
        prob = Problem(name, "cpu")
        x = prob.start(gen, 32).double()
        u = 10 * torch.randn(32, nu, generator=gen, dtype=torch.float64)
        p = prob.params.double()
        d = mod.make()
        torch.testing.assert_close(prob.model.step(x, u, p), d.kernel_step(x, u, p),
                                   rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(prob.model.jac(x, u, p), d.jac_lanes(x, u, p),
                                   rtol=1e-12, atol=1e-12)
        jx, ju = torch.func.vmap(torch.func.jacfwd(
            lambda a, b: prob.model.step(a, b, p), argnums=(0, 1)))(x, u)
        torch.testing.assert_close(prob.model.jac(x, u, p), torch.cat([jx, ju], -1),
                                   rtol=1e-9, atol=1e-9)


def test_tile_one_lets_each_example_stop_by_itself():
    prob = Problem("cartpole", "cpu")
    gen = torch.Generator().manual_seed(2)
    x0 = prob.start(gen, 8)
    whole = prob.solve_reference(x0, None, tile=8)
    each = prob.solve_reference(x0, None, tile=1)
    assert (each.iters <= whole.iters).all()
    assert int(whole.iters.min()) == int(whole.iters.max())
    assert (each.trials >= each.iters).all()
