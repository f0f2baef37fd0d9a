"""The batched iLQR outer loop (counterpart of ``dilqr_tpu/core/ilqr.py``):

 * each iteration: open-loop rollout of the current u, linearization,
   delta-space cost shift ``c_back = C tau + c``, one Riccati backward and
   a line-searched forward;
 * per-example best-so-far tracking with the best_cost_eps tolerance;
 * stop when max(full_du_norm) < eps or no improvement for
   not_improved_lim iterations; both decisions are the whole batch's, over
   every rank of an open ``parallel.comm.batch_global``.

``ilqr_loop`` sends a covered configuration on CUDA tensors to the
whole-solve CUDA kernel (``ops/cuda/ilqr_fused.py``; an MLP's weights
[(W, b), ...] flattened into its params vector, ``kernel_params``; a
user's own model and a callable cost traced into C++ by
``ops/cuda/traced.py``, the cost as the (cost_fn, cost_params) pair
``cost_struct`` the solve hands down, ``callable_cost``) and
everything else to
the plain loop below on the tensors' own device, whose Riccati backward
``ops/riccati.lqr_backward`` takes the CUDA Riccati kernel where that one
covers it (``ops/cuda/riccati_fused.py``). The choice depends on the
configuration and the device alone; nothing falls back after a failure.
``PLAIN_SOLVES`` counts the solves that took the plain loop, beside
``ilqr_fused.LAUNCHES``, which counts those that took the kernel.

All arrays are time-major [T, B, ...] here; ``core/solver.py`` transposes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.nn_dynamics import flat_params, weight_limit
from ..ops.cuda import ilqr_fused as fused
from ..ops.cuda import traced
from ..ops.riccati import lqr_backward
from ..ops.rollout import get_traj, lqr_forward
from ..parallel.comm import decide
from ..types import GradMethod, ILQRConfig, LinDx, QuadCost
from ..utils.batch import bmv
from ..utils.logging import table_log
from ..utils.profiling import span
from .linearize import approximate_cost, linearize_dynamics

# solves ilqr_loop ran in the plain loop (ops/cuda/ilqr_fused.LAUNCHES
# counts those it launched the kernel for)
PLAIN_SOLVES = 0


class ILQRInternal(NamedTuple):
    x: torch.Tensor  # [T, B, nx] best trajectory
    u: torch.Tensor  # [T, B, nu]
    costs: torch.Tensor  # [B]
    full_du_norm: torch.Tensor  # [B] of the best iterate
    n_iter: torch.Tensor  # [] int


def _linearize(cfg: ILQRConfig, dyn, params, x, u):
    if isinstance(dyn, LinDx):
        return dyn.F, dyn.f
    # ANALYTIC differentiates the un-clamped physics; AUTO_DIFF the clamped
    # forward, so saturated controls get zero Jacobian columns
    lin_fn = None if cfg.grad_method is GradMethod.AUTO_DIFF else dyn.linearize_point
    return linearize_dynamics(
        dyn.step, params, x, u, method=cfg.grad_method,
        jacobian_fn=dyn.jacobian, fd_eps=cfg.fd_eps, linearize_fn=lin_fn,
    )


def _quadraticize(cost, x, u):
    if isinstance(cost, QuadCost):
        return cost.C, cost.c
    C, c, _ = approximate_cost(cost, x, u)
    return C, c


def lqr_step(cfg: ILQRConfig, cost, dyn, params, x_init, x, u,
             u_lower=None, u_upper=None, u_zero_I=None, delta_u=None):
    """One backward+forward iLQR sweep. Returns (new_x, new_u, LqrForOut,
    n_qp_iter)."""
    F, _ = _linearize(cfg, dyn, params, x, u)
    C, c = _quadraticize(cost, x, u)
    c_back = bmv(C, torch.cat([x, u], -1)) + c  # delta-space shift
    ric = lqr_backward(
        cfg.n_state, cfg.n_ctrl, C, c_back, F, None, u,
        u_lower=u_lower, u_upper=u_upper, u_zero_I=u_zero_I, delta_u=delta_u,
        pnqp_iter=cfg.pnqp_iter, qp_solver=cfg.qp_solver,
        # the Riccati kernel has no autograd rule: UNROLL stays plain
        backend="torch" if cfg.unroll else cfg.backend,
        parallel=cfg.riccati_parallel,
    )
    dyn_roll = dyn if isinstance(dyn, LinDx) else (dyn.step, params)
    new_x, new_u, out = lqr_forward(
        cfg.T, cfg.n_state, cfg.n_ctrl, x_init, cost, dyn_roll, x, u,
        ric.K, ric.k, u_lower=u_lower, u_upper=u_upper, u_zero_I=u_zero_I,
        delta_u=delta_u, linesearch_decay=cfg.linesearch_decay,
        max_linesearch_iter=cfg.max_linesearch_iter,
    )
    return new_x, new_u, out, ric.n_total_qp_iter


def kernel_params(dyn, params):
    """The params the kernel reads: pytree params (the MLP's [(W, b), ...])
    flattened into one vector where ``flat_params`` takes them, as JAX
    flattens them for its kernel (dilqr_tpu/core/ilqr.py:186-195), up to the
    port's own limit for the model (``nn_dynamics.weight_limit``: past JAX's
    256 for a net of one hidden layer); any other params as they are. The
    plain loop and the backward keep the pytree."""
    if isinstance(dyn, LinDx):
        return params
    flat = flat_params(params, weight_limit(getattr(dyn, "device_mlp", None)))
    return params if flat is None else flat


def callable_cost(cfg: ILQRConfig, cost_struct, device=None):
    """The kernel's form of a (cost_fn, cost_params) pair, or None (JAX's
    probe, dilqr_tpu/core/ilqr.py:196-205): flat params or none (an empty
    tuple, or None for a cost of tau alone), and a cost that traces
    (``traced.cost``, JAX's cost_lane_compatible). ``device``: where the
    solve runs, on which the trace's samples are made."""
    if cost_struct is None:
        return None
    fn, cin = cost_struct
    unary = cin is None
    empty = unary or (isinstance(cin, (tuple, list)) and len(cin) == 0)
    if not (empty or (isinstance(cin, torch.Tensor) and cin.dim() == 1)):
        return None
    trace = traced.cost(fn, cfg.n_tau, None if empty else cin.shape[0], unary=unary,
                        device=device)
    return None if trace is None else fused.CallableCost(trace, fn, None if empty else cin)


def use_kernel(cfg: ILQRConfig, cost, dyn, params, x_init, u_zero_I, delta_u,
               cost_small, u_lower, u_upper, u_init_zero: bool = False,
               cost_callable=None) -> bool:
    """Backend dispatch. "torch" never takes the kernel; "auto" takes it
    for CUDA tensors in the covered configuration; "cuda" must take it and
    raises where it cannot. ``params``: the kernel's (kernel_params);
    ``cost_callable``: a callable cost's kernel form (``callable_cost``),
    with which a cost that is no QuadCost may take the kernel. The device
    is read first: CPU tensors never reach ``covered``, which may trace."""
    if cfg.backend == "torch":
        return False
    if not x_init.is_cuda:
        if cfg.backend == "cuda":
            raise ValueError(
                "backend='cuda' needs CUDA tensors; CPU tensors take "
                "backend='auto' or 'torch'")
        return False
    ok = (isinstance(cost, QuadCost) or cost_callable is not None) and fused.covered(
        cfg, dyn, params, x_init.dtype, cost_small, u_zero_I, delta_u,
        u_lower, u_upper, u_init_zero=u_init_zero, cost_callable=cost_callable is not None)
    if cfg.backend == "cuda" and not ok:
        raise ValueError(
            "backend='cuda': this configuration is not covered by the "
            "CUDA kernel (see ops/cuda/ilqr_fused.covered)")
    return ok


def ilqr_loop(
    cfg: ILQRConfig,
    cost,
    dyn,
    params,
    x_init: torch.Tensor,
    u_init: torch.Tensor,
    u_lower=None,
    u_upper=None,
    u_zero_I=None,
    delta_u=None,
    cost_small=None,
    u_init_zero: bool = False,
    cost_struct=None,
) -> ILQRInternal:
    """Run up to cfg.lqr_iter iterations with best tracking and the
    reference's stopping rule. u_init: [T, B, nu] (already broadcast).
    cost_small: the user's example-invariant (C, c), [n,n]+[n] or
    [T,n,n]+[T,n], when there is one; u_init_zero: the warm start is known
    to be zeros; cost_struct: a callable cost's (cost_fn, cost_params),
    whose trace the kernel runs where it can (the plain loop calls
    ``cost``). All three are hints for the kernel, read (and a model or
    cost traced) only for CUDA tensors."""
    global PLAIN_SOLVES
    with span("ilqr.gate"):
        kparams = kernel_params(dyn, params)
        card = cfg.backend != "torch" and x_init.is_cuda
        cc = callable_cost(cfg, cost_struct, x_init.device) \
            if card and not isinstance(cost, QuadCost) else None
        on_card = use_kernel(cfg, cost, dyn, kparams, x_init, u_zero_I, delta_u,
                             cost_small, u_lower, u_upper, u_init_zero,
                             **({} if cc is None else {"cost_callable": cc}))
    if on_card:
        # a callable cost's trace; the user's example-invariant cost where
        # there is one; else the per-example [T, B, ...] pair
        return ILQRInternal(*fused.ilqr_fused(
            cfg, dyn, kparams, x_init,
            cc if cc is not None else cost_small if cost_small is not None
            else (cost.C, cost.c),
            None if u_init_zero else u_init,
            u_lower=u_lower, u_upper=u_upper, u_zero_I=u_zero_I, delta_u=delta_u,
        ))

    PLAIN_SOLVES += 1
    T, B = cfg.T, x_init.shape[0]
    dyn_roll = dyn if isinstance(dyn, LinDx) else (dyn.step, params)
    inf = torch.full((B,), float("inf"), dtype=x_init.dtype, device=x_init.device)
    u = u_init
    bx = torch.zeros(T, B, cfg.n_state, dtype=x_init.dtype, device=x_init.device)
    bu = torch.zeros(T, B, cfg.n_ctrl, dtype=x_init.dtype, device=x_init.device)
    bc, bdu, cur_du = inf, inf, inf
    nni = 0
    i = 0
    while i < cfg.lqr_iter:
        # NaN compares False, so a NaN max does not stop, as in the reference
        if decide(cur_du.max() < cfg.eps, "all") or nni > cfg.not_improved_lim:
            break
        x = get_traj(T, u, x_init, dyn_roll)
        new_x, new_u, out, _ = lqr_step(
            cfg, cost, dyn, params, x_init, x, u, u_lower=u_lower,
            u_upper=u_upper, u_zero_I=u_zero_I, delta_u=delta_u)
        if cfg.verbose >= 1:
            # the reference's per-iteration table (mpc.py:287-297), with the
            # columns in JAX's order: jax.debug.callback hands its keyword
            # arguments back sorted by name
            table_log("ilqr", [(k, float(v), "{:.4e}") for k, v in (
                ("du_max", out.full_du_norm.max()), ("iter", i),
                ("mean_alpha", out.mean_alphas), ("mean_cost", out.costs.mean()))])
        improved = out.costs <= bc + cfg.best_cost_eps
        bx = torch.where(improved[None, :, None], new_x, bx)
        bu = torch.where(improved[None, :, None], new_u, bu)
        bc = torch.where(improved, out.costs, bc)
        bdu = torch.where(improved, out.full_du_norm, bdu)
        # the reference increments, then resets if any example improved,
        # except on the very first iteration (mpc.py:266, 281)
        nni = 0 if (i > 0 and decide(improved.any())) else nni + 1
        u, cur_du = new_u, out.full_du_norm
        i += 1
    return ILQRInternal(bx, bu, bc, bdu,
                        torch.tensor(i, dtype=torch.int32, device=x_init.device))
