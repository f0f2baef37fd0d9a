"""Forward rollout, objective evaluation and the batched line search
(counterpart of ``dilqr_tpu/ops/rollout.py``):

 * trial rollout: u'_t = u_t + K_t (x'_t - x_t) + alpha k_t, optionally
   zero-masked (u_zero_I), trust-region'd (delta_u) and clamped to the box,
   stepping the true nonlinear dynamics;
 * the line search repeats while ANY example's total cost worsened,
   decaying only the worsened examples' alpha;
 * full_du_norm comes from the first (alpha=1) trial; over-shrunk alphas
   are un-decayed once at exit for the mean_alphas diagnostic.

All tensors are time-major [T, B, ...].
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..types import LinDx, QuadCost
from ..utils.batch import bdot, bmv, bquad, clamp


class LqrForOut(NamedTuple):
    objs: torch.Tensor  # [T, B]
    full_du_norm: torch.Tensor  # [B]
    alpha_du_norm: torch.Tensor  # [B]
    mean_alphas: torch.Tensor  # []
    costs: torch.Tensor  # [B]


def _lin_step(F_t, f_t, x, u):
    nxt = bmv(F_t, torch.cat([x, u], -1))
    return nxt if f_t is None else nxt + f_t


def _step(dynamics, t, x, u):
    if isinstance(dynamics, LinDx):
        return _lin_step(dynamics.F[t], None if dynamics.f is None else dynamics.f[t], x, u)
    step_fn, params = dynamics
    return step_fn(x, u, params)


def point_cost(cost, tau: torch.Tensor, t: Optional[int] = None) -> torch.Tensor:
    """Objective of tau [..., n]: a QuadCost (time-major [T,B,...], at step
    t, or all steps when t is None) or a callable cost(tau[n]) -> scalar."""
    if isinstance(cost, QuadCost):
        C, c = (cost.C, cost.c) if t is None else (cost.C[t], cost.c[t])
        return 0.5 * bquad(tau, C) + bdot(tau, c)
    fn = cost
    for _ in range(tau.dim() - 1):
        fn = torch.func.vmap(fn)
    return fn(tau)


def get_traj(T: int, u: torch.Tensor, x_init: torch.Tensor, dynamics) -> torch.Tensor:
    """Open-loop rollout. u: [T, B, nu]; returns x: [T, B, nx]."""
    xs = [x_init]
    for t in range(T - 1):
        xs.append(_step(dynamics, t, xs[-1], u[t]))
    return torch.stack(xs)


def get_cost(T: int, u, cost, dynamics=None, x_init=None, x=None) -> torch.Tensor:
    """Total per-example objective [B]."""
    if x is None:
        if x_init is None:
            raise ValueError("get_cost needs x or x_init")
        x = get_traj(T, u, x_init, dynamics)
    return point_cost(cost, torch.cat([x, u], -1)).sum(0)


def lqr_forward(
    T: int,
    n_state: int,
    n_ctrl: int,
    x_init: torch.Tensor,
    cost,
    dynamics,
    x: torch.Tensor,
    u: torch.Tensor,
    K: torch.Tensor,
    k: torch.Tensor,
    u_lower=None,
    u_upper=None,
    u_zero_I: Optional[torch.Tensor] = None,
    delta_u=None,
    linesearch_decay: float = 0.2,
    max_linesearch_iter: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, LqrForOut]:
    """Closed-loop rollout with batched backtracking line search.
    x, u: current iterate [T,B,...]; K, k: gains (t ascending). Returns
    (new_x, new_u, LqrForOut)."""
    B = x_init.shape[0]
    boxed = u_lower is not None
    old_cost = get_cost(T, u, cost, dynamics, x=x)

    def trial(alphas):
        xs, us, objs = [], [], []
        new_xt = x_init
        for t in range(T):
            new_ut = bmv(K[t], new_xt - x[t]) + u[t] + alphas[:, None] * k[t]
            if u_zero_I is not None:
                new_ut = torch.where(u_zero_I[t], torch.zeros_like(new_ut), new_ut)
            if boxed:
                # each bound on its own: one may be per-step [T,B,nu] while
                # the other is a scalar or [nu]
                lo, hi = (v[t] if isinstance(v, torch.Tensor) and v.dim() == 3 else v
                          for v in (u_lower, u_upper))
                if delta_u is not None:
                    lo = clamp(u[t] - delta_u, lo, None)
                    hi = clamp(u[t] + delta_u, None, hi)
                new_ut = clamp(new_ut, lo, hi)
            objs.append(point_cost(cost, torch.cat([new_xt, new_ut], -1), t))
            xs.append(new_xt)
            us.append(new_ut)
            if t < T - 1:
                new_xt = _step(dynamics, t, new_xt, new_ut)
        objs = torch.stack(objs)
        return torch.stack(xs), torch.stack(us), objs, objs.sum(0)

    def du_norm(new_u):
        return torch.linalg.vector_norm((u - new_u).transpose(0, 1).reshape(B, -1), dim=-1)

    alphas = torch.ones(B, dtype=x_init.dtype, device=x_init.device)
    new_x, new_u, objs, current_cost = trial(alphas)
    full_du_norm = du_norm(new_u)
    alphas = torch.where(current_cost > old_cost, alphas * linesearch_decay, alphas)
    i = 1
    while i < max_linesearch_iter and bool((current_cost > old_cost).any()):
        new_x, new_u, objs, current_cost = trial(alphas)
        alphas = torch.where(current_cost > old_cost, alphas * linesearch_decay, alphas)
        i += 1

    alphas_rep = torch.where(current_cost > old_cost, alphas / linesearch_decay, alphas)
    return new_x, new_u, LqrForOut(
        objs, full_du_norm, du_norm(new_u), alphas_rep.mean(), current_cost)
