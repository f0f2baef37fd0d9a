"""Public batched iLQR solve: canonicalization, input validation, the
slew-rate augmentation and dispatch to the differentiation modes
(counterpart of ``dilqr_tpu/core/solver.py``).

The public API is batch-major ([B, T, ...]). Broadcast rules for QuadCost
follow the reference (mpc.py:205-226), u_init warm-start handling
mpc.py:230-236. The slew-rate penalty becomes an up-front problem
transformation to the augmented state (u_{t-1}, x) (reference
mpc.py:339-445).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as tnf
from torch.utils import _pytree as pytree

from ..diff.modes import solve_with_grad
from ..models import ctrl_passthrough
from ..types import ILQRConfig, LinDx, QuadCost, SolveResult
from ..utils.profiling import span


def params_to(params, device, dtype):
    """Dynamics params on ``device``: a tensor or numpy array becomes one
    tensor of ``dtype``, as before; any other pytree (the MLP's
    [(W, b), ...], the affine model's dict) keeps its structure, each
    tensor or numpy leaf moved and the floating ones cast to ``dtype``."""
    if isinstance(params, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(params, device=device).to(dtype)

    def leaf(a):
        if not isinstance(a, (torch.Tensor, np.ndarray)):
            return a
        a = torch.as_tensor(a, device=device)
        return a.to(dtype) if a.is_floating_point() else a

    return pytree.tree_map(leaf, params)


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
    """A number -> python float; a 0-d tensor stays one (no host read: under
    vmap it may be a sweep's bound) and [nu] too; [T,nu] | [B,T,nu] ->
    time-major [T,B,nu]. The kernel reads a number, 0-d or [nu] bound as
    its static bounds (ops/cuda/ilqr_fused.static_bounds)."""
    if v is None:
        return None
    if isinstance(v, (int, float, np.floating, np.integer)):
        return float(v)
    v = torch.as_tensor(v, device=like.device).to(like.dtype)
    if v.dim() <= 1:
        return v
    if v.dim() == 2:
        return v[:, None].expand(T, B, n_ctrl)
    return v.transpose(0, 1)


def augment_slew_rate(cfg: ILQRConfig, cost, dyn, params, x_init, prev_ctrl):
    """Rewrite the problem over the augmented state (u_{t-1}, x) so that the
    slew-rate penalty 0.5 pen ||u_t - u_{t-1}||^2 becomes quadratic cost
    blocks (reference mpc.py:339-445). cost and dyn are time-major
    (canonicalized). Returns (aug_cfg, aug_cost, aug_dyn, params,
    aug_x_init)."""
    nx, nu, T = cfg.n_state, cfg.n_ctrl, cfg.T
    n_aug = nu + nx + nu  # (u_{t-1}, x, u)
    B, dtype, dev = x_init.shape[0], x_init.dtype, x_init.device

    # 0.5 pen ||u - u_{t-1}||^2 on (u_{t-1}, x, u)
    eye = cfg.slew_rate_penalty * torch.eye(nu, dtype=dtype, device=dev)
    slew_C = torch.zeros(n_aug, n_aug, dtype=dtype, device=dev)
    slew_C[:nu, :nu] = eye
    slew_C[-nu:, -nu:] = eye
    slew_C[:nu, -nu:] = -eye
    slew_C[-nu:, :nu] = -eye

    if isinstance(cost, QuadCost):
        C, c = cost
        aug_cost = QuadCost(slew_C + tnf.pad(C, (nu, 0, nu, 0)),
                            tnf.pad(c, (nu, 0)))
    else:
        # the true cost on (x, u) plus the slew quadratic (reference
        # SlewRateCost, mpc.py:36-52)
        def aug_cost(tau_aug):
            return cost(tau_aug[nu:]) + 0.5 * tau_aug @ slew_C @ tau_aug

    if isinstance(dyn, LinDx):
        # rows [u_{t-1}' = u_t | x' = F tau (+ f)] over (u_{t-1}, x, u)
        # (reference mpc.py:381-395)
        Fm = dyn.F
        Tm1, Bb = Fm.shape[0], Fm.shape[1]
        top = torch.cat([torch.zeros(Tm1, Bb, nu, nu + nx, dtype=dtype, device=dev),
                         torch.eye(nu, dtype=dtype, device=dev).expand(Tm1, Bb, nu, nu)], -1)
        aug_dyn = LinDx(torch.cat([top, tnf.pad(Fm, (nu, 0))], -2),
                        None if dyn.f is None else tnf.pad(dyn.f, (nu, 0)))
    else:
        aug_dyn = ctrl_passthrough.make(dyn)

    prev_u0 = (torch.zeros(B, nu, dtype=dtype, device=dev) if prev_ctrl is None
               else torch.as_tensor(prev_ctrl, device=dev).to(dtype).expand(B, nu))
    aug_x_init = torch.cat([prev_u0, x_init], -1)
    aug_cfg = dataclasses.replace(cfg, n_state=nu + nx, slew_rate_penalty=None)
    return aug_cfg, aug_cost, aug_dyn, params, aug_x_init


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
    with span("solve"):
        with span("solve.canonicalize"):
            B = x_init.shape[0]
            T, nx, nu = cfg.T, cfg.n_state, cfg.n_ctrl

            if x_init.dim() != 2 or x_init.shape[1] != nx:
                raise ValueError(f"x_init must be [n_batch, n_state={nx}], "
                                 f"got {tuple(x_init.shape)}")
            if (u_lower is None) != (u_upper is None):
                raise ValueError("u_lower and u_upper must both be set or both None")
            if delta_u is not None and u_lower is None:
                raise ValueError("delta_u requires box bounds (u_lower/u_upper)")

            dev, dtype = x_init.device, x_init.dtype
            if isinstance(cost, QuadCost):
                cost = QuadCost(cost.C.to(dev, dtype), cost.c.to(dev, dtype))
            # a (cost_fn, cost_params) pair passes through as it is: the
            # backward returns the cost parameters' gradients
            if isinstance(dynamics, LinDx):
                dynamics = LinDx(dynamics.F.to(dev, dtype),
                                 None if dynamics.f is None else dynamics.f.to(dev, dtype))
            elif params is not None:
                params = params_to(params, dev, dtype)

            # hints for the kernel: the user's compact example-invariant cost
            # and a known-zeros warm start; only exactly conforming pairs
            # qualify
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

            unaug = None
            if cfg.slew_rate_penalty is not None:
                cfg, cost, dynamics, params, x_init = augment_slew_rate(
                    cfg, cost, dynamics, params, x_init, prev_ctrl)
                unaug = nu  # strip the first nu state coordinates on return
                cost_small = None  # the augmented cost is rebuilt at [T,B,...]

        x, u, costs, full_du_norm, n_iter = solve_with_grad(
            cfg, cost, dynamics, params, x_init, u_init_tm, lb, ub, uz, delta_u,
            cost_small=cost_small, u_init_zero=u_init_zero,
        )
        if unaug is not None:
            x = x[:, :, unaug:]

        # exit_unconverged warns inside the solve (diff/modes.py), where the
        # tensors are real under torch.func.vmap
        return SolveResult(
            x=x.transpose(0, 1),
            u=u.transpose(0, 1),
            costs=costs.detach(),
            converged=full_du_norm < cfg.eps,
            full_du_norm=full_du_norm.detach(),
            n_iter=n_iter,
        )
