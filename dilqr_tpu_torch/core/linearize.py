"""Dynamics linearization and cost quadraticization (counterpart of
``dilqr_tpu/core/linearize.py``):

 * ANALYTIC / AUTO_DIFF: forward-mode derivatives of the env step at every
   (t, b) point (batched ``torch.func.jvp`` sweeps);
 * FINITE_DIFF: central differences with ``fd_eps``;
 * approximate_cost: per-point Hessian/gradient of a callable cost, with
   the gradient re-centred so that ``C tau + c`` reproduces it.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Tuple

import torch
from torch.func import grad, hessian, jvp, vmap

from ..types import GradMethod
from ..utils.batch import bmv


def _jacobian(step_fn, method: GradMethod, fd_eps: float):
    """Jacobian of x' = step(x, u, params) at every point of a batch
    x [..., nx], u [..., nu] -> (R [..., nx, nx], S [..., nx, nu]).

    Forward mode runs as one batched ``torch.func.jvp`` per input
    direction -- what jacfwd does -- on the whole batch: jacfwd applied per
    point promotes float32 results to float64 (0-dim tensors times python
    floats lose their weak type under forward AD), which the batched form
    does not."""
    if method in (GradMethod.ANALYTIC, GradMethod.AUTO_DIFF, GradMethod.ANALYTIC_CHECK):

        def jac(x, u, params):
            f = lambda x_, u_: step_fn(x_, u_, params)  # noqa: E731
            cols = []
            for j in range(x.shape[-1] + u.shape[-1]):
                e = torch.zeros(x.shape[-1] + u.shape[-1], dtype=x.dtype, device=x.device)
                e[j] = 1.0
                tx = e[: x.shape[-1]].expand_as(x)
                tu = e[x.shape[-1]:].expand_as(u)
                cols.append(jvp(f, (x, u), (tx, tu))[1])
            D = torch.stack(cols, -1)
            return D[..., : x.shape[-1]], D[..., x.shape[-1]:]

        return jac

    if method is GradMethod.FINITE_DIFF:

        def jac(x, u, params):
            def cols(v, fn):
                out = []
                for j in range(v.shape[-1]):
                    e = torch.zeros(v.shape[-1], dtype=v.dtype, device=v.device)
                    e[j] = fd_eps
                    out.append((fn(v + e) - fn(v - e)) / (2.0 * fd_eps))
                return torch.stack(out, -1)

            R = cols(x, lambda xv: step_fn(xv, u, params))
            S = cols(u, lambda uv: step_fn(x, uv, params))
            return R, S

        return jac

    raise ValueError(f"Unsupported grad method {method}")


def linearize_dynamics(
    step_fn: Callable,
    params,
    x: torch.Tensor,
    u: torch.Tensor,
    method: GradMethod = GradMethod.ANALYTIC,
    jacobian_fn: Optional[Callable] = None,
    fd_eps: float = 1e-4,
    linearize_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linearize around a trajectory x [T,B,nx], u [T,B,nu]. Returns
    F [T-1,B,nx,nx+nu] and the affine residual f = x' - R x - S u
    [T-1,B,nx]. ``linearize_fn`` overrides the function differentiated
    (the env's un-clamped physics) while ``step_fn`` gives x'."""
    T = x.shape[0]
    xf, uf = x[: T - 1], u[: T - 1]
    lin_f = linearize_fn if linearize_fn is not None else step_fn
    if jacobian_fn is not None and method in (GradMethod.ANALYTIC, GradMethod.ANALYTIC_CHECK):
        jac = jacobian_fn
    else:
        jac = _jacobian(lin_f, method, fd_eps)
    R, S = jac(xf, uf, params)

    if method is GradMethod.ANALYTIC_CHECK:
        Rn, Sn = _jacobian(lin_f, GradMethod.FINITE_DIFF, fd_eps)(xf, uf, params)
        err = max(float((R - Rn).abs().max()), float((S - Sn).abs().max()))
        if err > 1e-2 * fd_eps ** 0.5:
            warnings.warn(
                f"ANALYTIC_CHECK: analytic vs finite-difference Jacobian max err {err:.3e}"
            )

    new_x = step_fn(xf, uf, params)
    f = new_x - bmv(R, xf) - bmv(S, uf)
    return torch.cat([R, S], -1), f


def approximate_cost(cost_fn: Callable, x: torch.Tensor, u: torch.Tensor):
    """Quadraticize a callable cost_fn(tau[n]) -> scalar around tau = (x, u).
    Returns (C [T,B,n,n], c [T,B,n], costs [T,B]) with c = grad - H tau."""
    tau = torch.cat([x, u], -1)

    def point(tv):
        H = hessian(cost_fn)(tv)
        g = grad(cost_fn)(tv)
        return H, g - H @ tv, cost_fn(tv)

    return vmap(vmap(point))(tau)
