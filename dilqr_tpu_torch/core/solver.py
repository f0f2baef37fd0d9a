"""Public batched iLQR solve: canonicalization, input validation and
dispatch to the differentiation modes (counterpart of
``dilqr_tpu/core/solver.py``).

The public API is batch-major ([B, T, ...]). Broadcast rules for QuadCost
follow the reference (mpc.py:205-226), u_init warm-start handling
mpc.py:230-236. The slew-rate penalty needs ``models/ctrl_passthrough``,
which a later slice ports (ROADMAP.md, queue A item 4).
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..diff.modes import solve_with_grad
from ..types import ILQRConfig, LinDx, QuadCost, SolveResult


def canonicalize_cost(cost, T: int, B: int, n_tau: int):
    """Broadcast QuadCost to time-major [T, B, ...].
    Accepted: C [n,n] | [T,n,n] | [B,T,n,n]; c [n] | [T,n] | [B,T,n]."""
    if not isinstance(cost, QuadCost):
        return cost
    C, c = cost
    if C.dim() == 2:
        C = C.expand(T, B, n_tau, n_tau)
    elif C.dim() == 3:
        C = C[:, None].expand(T, B, n_tau, n_tau)
    else:
        C = C.transpose(0, 1)
    if c.dim() == 1:
        c = c.expand(T, B, n_tau)
    elif c.dim() == 2:
        c = c[:, None].expand(T, B, n_tau)
    else:
        c = c.transpose(0, 1)
    return QuadCost(C, c)


def canonicalize_lindx(dyn, T: int, B: int):
    """LinDx arrives batch-major [B, T-1, ...]; convert to time-major."""
    if not isinstance(dyn, LinDx):
        return dyn
    F = dyn.F.transpose(0, 1) if dyn.F.dim() == 4 else dyn.F[:, None].expand(
        (T - 1, B) + tuple(dyn.F.shape[1:]))
    f = dyn.f
    if f is not None:
        f = f.transpose(0, 1) if f.dim() == 3 else f[:, None].expand(
            (T - 1, B) + tuple(f.shape[1:]))
    return LinDx(F, f)


def canonicalize_u_init(u_init, T: int, B: int, n_ctrl: int, like: torch.Tensor):
    """None -> zeros; [T, nu] -> expand batch; [B, T, nu] -> time-major."""
    if u_init is None:
        return torch.zeros(T, B, n_ctrl, dtype=like.dtype, device=like.device)
    u_init = torch.as_tensor(u_init, device=like.device).to(like.dtype)
    if u_init.dim() == 2:
        return u_init[:, None].expand(T, B, n_ctrl)
    return u_init.transpose(0, 1)


def canonicalize_bound(v, T: int, B: int, n_ctrl: int, like: torch.Tensor):
    """Scalar -> python float; [nu] -> tensor [nu]; [T,nu] | [B,T,nu] ->
    time-major [T,B,nu]. Python floats are what the kernel takes as its
    static bounds."""
    if v is None:
        return None
    if isinstance(v, (int, float, np.floating, np.integer)):
        return float(v)
    v = torch.as_tensor(v, device=like.device).to(like.dtype)
    if v.dim() == 0:
        return float(v)
    if v.dim() == 1:
        return v
    if v.dim() == 2:
        return v[:, None].expand(T, B, n_ctrl)
    return v.transpose(0, 1)


def solve(
    cfg: ILQRConfig,
    x_init: torch.Tensor,
    cost,
    dynamics,
    params=None,
    u_init: Optional[torch.Tensor] = None,
    u_lower=None,
    u_upper=None,
    u_zero_I: Optional[torch.Tensor] = None,
    delta_u=None,
    prev_ctrl=None,
) -> SolveResult:
    """Batched iLQR solve.

    Args (batch-major):
      x_init: [B, n_state]; the whole solve runs on its device and dtype.
      cost: QuadCost (broadcastable, see canonicalize_cost), a callable
            cost_fn(tau) -> scalar, or (cost_fn, cost_params) called as
            cost_fn(tau, cost_params).
      dynamics: LinDx, or a models.base.Dynamics with ``params``.
      u_init: warm start [B, T, nu] (or [T, nu]); zeros otherwise.
      u_lower/u_upper: box bounds (scalar or [nu]/[T,nu]/[B,T,nu]).
      u_zero_I: [B, T, nu] bool mask forcing u coords to zero.
      delta_u: per-iteration trust region on u.
      prev_ctrl: the previous action, read only by the slew-rate penalty.
    Returns SolveResult with batch-major x [B,T,nx], u [B,T,nu].
    """
    B = x_init.shape[0]
    T, nx, nu = cfg.T, cfg.n_state, cfg.n_ctrl

    if x_init.dim() != 2 or x_init.shape[1] != nx:
        raise ValueError(f"x_init must be [n_batch, n_state={nx}], got {tuple(x_init.shape)}")
    if (u_lower is None) != (u_upper is None):
        raise ValueError("u_lower and u_upper must both be set or both None")
    if delta_u is not None and u_lower is None:
        raise ValueError("delta_u requires box bounds (u_lower/u_upper)")
    if cfg.slew_rate_penalty is not None:
        raise NotImplementedError(
            "slew_rate_penalty needs models/ctrl_passthrough, which is not "
            "ported yet: see ROADMAP.md, queue A item 4")

    dev, dtype = x_init.device, x_init.dtype
    if isinstance(cost, QuadCost):
        cost = QuadCost(cost.C.to(dev, dtype), cost.c.to(dev, dtype))
    # a (cost_fn, cost_params) pair passes through as it is: the backward
    # returns the cost parameters' gradients
    if isinstance(dynamics, LinDx):
        dynamics = LinDx(dynamics.F.to(dev, dtype),
                         None if dynamics.f is None else dynamics.f.to(dev, dtype))
    elif params is not None:
        params = torch.as_tensor(params, device=dev).to(dtype)

    # hints for the kernel: the user's compact example-invariant cost and a
    # known-zeros warm start; only exactly conforming pairs qualify
    cost_small = None
    if isinstance(cost, QuadCost):
        Cs_, cs_ = cost.C, cost.c
        if (Cs_.dim() == 2 and cs_.dim() == 1) or (
            Cs_.dim() == 3 and cs_.dim() == 2
            and Cs_.shape[0] == T and cs_.shape[0] == T
        ):
            cost_small = (Cs_, cs_)
    u_init_zero = u_init is None

    cost = canonicalize_cost(cost, T, B, cfg.n_tau)
    dynamics = canonicalize_lindx(dynamics, T, B)
    u_init_tm = canonicalize_u_init(u_init, T, B, nu, x_init)
    lb = canonicalize_bound(u_lower, T, B, nu, x_init)
    ub = canonicalize_bound(u_upper, T, B, nu, x_init)
    uz = u_zero_I.transpose(0, 1).to(dev) if u_zero_I is not None else None

    x, u, costs, full_du_norm, n_iter = solve_with_grad(
        cfg, cost, dynamics, params, x_init, u_init_tm, lb, ub, uz, delta_u,
        cost_small=cost_small, u_init_zero=u_init_zero,
    )

    converged = full_du_norm < cfg.eps
    if cfg.exit_unconverged:
        n_bad = int((~converged).sum())
        if n_bad:
            warnings.warn(
                f"iLQR did not converge for {n_bad}/{B} examples "
                "(exit_unconverged is set; the reference asserts here, "
                "mpc.py:323-324)"
            )
    return SolveResult(
        x=x.transpose(0, 1),
        u=u.transpose(0, 1),
        costs=costs.detach(),
        converged=converged,
        full_du_norm=full_du_norm.detach(),
        n_iter=n_iter,
    )
