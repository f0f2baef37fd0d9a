"""Differentiation-mode dispatch (counterpart of ``dilqr_tpu/diff/modes.py``):
wires the forward iLQR solve to its backward through a
``torch.autograd.Function``.

Three modes (types.BackwardMode):
  KKT    -- the O(T) module-KKT VJP of the last LQR subproblem plus the
            linearization chain;
  IFT    -- fixed-point implicit differentiation, matrix-free (diff/ift.py);
  UNROLL -- plain autograd through the plain loop (cfg.unroll must be
            True); the gradient oracle.

The Function's differentiable inputs are x_init, the cost inputs and the
dynamics inputs; the warm start, bounds and masks are arguments too but
get no gradient, as the reference detaches its bounds. Inside the Function
the forward is the same ``ilqr_loop`` as without a backward (backprop=False
runs the Function under no_grad), so a covered configuration on CUDA
tensors runs the whole-solve kernel; it gets the detached cost and params,
and the gradient flows through the canonical broadcast cost. The
Function's vmap rule takes ``torch.func.vmap`` over the solve: a sweep
folded into one solve where that runs the kernel, else one solve a
candidate (``VMAP_STATS`` counts which). UNROLL stays plain autograd
through the plain loop and has no vmap rule.
"""
from __future__ import annotations

import inspect
import warnings
from typing import Optional

import torch
from torch.utils import _pytree as pytree

from ..core import ilqr
from ..core.ilqr import ilqr_loop
from ..core.linearize import approximate_cost, linearize_dynamics
from ..models.base import Dynamics
from ..parallel import comm
from ..types import BackwardMode, ILQRConfig, LinDx, QuadCost
from ..utils.batch import bmv
from .ift import solve_adjoint_dense, solve_adjoint_fixed_point
from .kkt import make_kkt_vjp

ACTIVE_TOL = 1e-8  # reference lqr_step.py:325-326


def _active_set(u, lb, ub):
    """Frozen box active set, from the bounds alone (the reference ignores
    any forward u_zero_I here)."""
    if lb is None:
        return None
    return ((u - lb).abs() <= ACTIVE_TOL) | ((u - ub).abs() <= ACTIVE_TOL)


def _linearize_for_vjp(cfg: ILQRConfig, dyn_static: Dynamics):
    """The differentiable linearization map (X, U, params) -> (F, f) of the
    backward chains: the forward's linearization with the env's un-clamped
    physics for every grad method."""

    def lin(x, u, params):
        return linearize_dynamics(
            dyn_static.step, params, x, u, method=cfg.grad_method,
            jacobian_fn=dyn_static.jacobian, fd_eps=cfg.fd_eps,
            linearize_fn=dyn_static.linearize_point)

    return lin


class _Problem:
    """What the Function closes over: the configuration and the static
    parts of the cost and dynamics. Everything that may be a tensor -- the
    warm start, the bounds, the mask, the compact-cost hint -- is an
    argument of the Function instead, so that ``torch.func.vmap`` sees its
    batch dimension."""

    def __init__(self, cfg, quad, cost_fn, lin, dyn_static, treedef, n_cost, delta_u,
                 u_init_zero):
        self.cfg, self.quad, self.cost_fn = cfg, quad, cost_fn
        self.lin, self.dyn_static, self.treedef = lin, dyn_static, treedef
        self.n_cost, self.delta_u, self.u_init_zero = n_cost, delta_u, u_init_zero

    def cost_obj(self, cost_in):
        if self.quad:
            return QuadCost(*cost_in)
        return lambda tau: self.cost_fn(tau, cost_in)

    def dyn_obj(self, dyn_in):
        """(the dynamics ilqr_loop takes, its params)."""
        return (LinDx(*dyn_in), None) if self.lin else (self.dyn_static, dyn_in)

    def primal(self, x_init, u_init, lb, ub, uz, cost_small, cost_in, dyn_in):
        dyn_obj, p = self.dyn_obj(dyn_in)
        cfg = self.cfg
        out = ilqr_loop(cfg, self.cost_obj(cost_in), dyn_obj, p, x_init, u_init,
                        u_lower=lb, u_upper=ub, u_zero_I=uz, delta_u=self.delta_u,
                        cost_small=cost_small, u_init_zero=self.u_init_zero)
        if cfg.exit_unconverged:
            # a host read, so here, where the tensors are real (under vmap:
            # the folded sweep or one candidate)
            n_bad = int((~(out.full_du_norm < cfg.eps)).sum())  # NaN counts
            if n_bad:
                warnings.warn(
                    f"iLQR did not converge for {n_bad}/{x_init.shape[0]} examples "
                    "(exit_unconverged is set; the reference asserts here, "
                    "mpc.py:323-324)"
                )
        return out.x, out.u, out.costs, out.full_du_norm, out.n_iter


# which route each torch.func.vmap over the solve took (JAX's DISPATCH_STATS,
# dilqr_tpu/ops/pallas/ilqr_fused.py:1509)
VMAP_STATS = {"vmap_merged": 0, "vmap_mapped": 0}


def _fold(prob: _Problem, S: int, args, batched):
    """The merged route's arguments: the mapped axis (at 0 of every batched
    argument) folded into the example batch, candidate-major (example s*B +
    b), unbatched per-example arguments tiled S times (JAX's merge and
    tile, ilqr_fused.py:1623-1632); None when the folded solve would not
    take the whole-solve kernel."""
    if not prob.quad or (not prob.lin and any(batched[7 + prob.n_cost:])):
        return None  # a batched params leaf: the kernel reads one params vector

    def fold(a, b, axis):
        if a is None:
            return None
        a = a if b else a.expand(S, *a.shape)
        return a.movedim(0, axis).flatten(axis, axis + 1)

    x_init, u_init, lb, ub, uz, Cs, cs, *leaves = args
    bx, bu0, blb, bub, buz, bCs, bcs, *bl = batched
    T, nu = prob.cfg.T, prob.cfg.n_ctrl
    B = x_init.shape[1] if bx else x_init.shape[0]

    def bound(v, b):
        if b:  # [S], [S, nu] or [S, T, B, nu] -> [T, S*B, nu]
            v = v.reshape(S, 1, 1, -1) if v.dim() <= 2 else v
            return fold(v.expand(S, T, B, nu), True, 1)
        if isinstance(v, torch.Tensor) and v.dim() == 3:
            return fold(v, False, 1)  # per-example bounds: S copies
        return v  # None, a number, 0-d or [nu]: the same for every example

    # a batched compact cost goes as the per-example pair (JAX's promotion
    # to lane costs, :1647-1669)
    small = bCs or bcs
    out = [fold(x_init, bx, 0), fold(u_init, bu0, 1), bound(lb, blb), bound(ub, bub),
           fold(uz, buz, 1), None if small else Cs, None if small else cs]
    # C, c and a LinDx's F, f are time-major; params pass as they are
    n_time = prob.n_cost + (len(leaves) - prob.n_cost if prob.lin else 0)
    out += [fold(a, b, 1) if i < n_time else a for i, (a, b) in enumerate(zip(leaves, bl))]
    cost_in, dyn_in = pytree.tree_unflatten(out[7:], prob.treedef)
    dyn, params = prob.dyn_obj(dyn_in)
    x_f, _, lb_f, ub_f, uz_f, Cs_f, cs_f = out[:7]
    if not ilqr.use_kernel(prob.cfg, QuadCost(*cost_in), dyn, ilqr.kernel_params(dyn, params),
                           x_f, uz_f, prob.delta_u, None if Cs_f is None else (Cs_f, cs_f),
                           lb_f, ub_f, prob.u_init_zero):
        return None
    return out


class _SolveWithGrad(torch.autograd.Function):
    """custom-VJP counterpart: forward = the solve, backward = KKT or IFT,
    and a vmap rule that folds a sweep into one solve.

    apply(prob, x_init, u_init, lb, ub, uz, Cs, cs, *leaves): leaves are
    the flattened (cost inputs, dynamics inputs), the differentiable ones;
    (Cs, cs) is the compact-cost hint or (None, None)."""

    @staticmethod
    def forward(*args):
        prob, x_init, u_init, lb, ub, uz, Cs, cs, *leaves = args
        cost_in, dyn_in = pytree.tree_unflatten(
            [a.detach() if isinstance(a, torch.Tensor) else a for a in leaves], prob.treedef)
        return prob.primal(x_init.detach(), u_init, lb, ub, uz,
                           None if Cs is None else (Cs, cs), cost_in, dyn_in)

    @staticmethod
    def setup_context(ctx, inputs, output):
        prob, _, _, lb, ub, _, _, _, *leaves = inputs
        x, u, costs, du, n_iter = output
        ctx.mark_non_differentiable(costs, du, n_iter)
        ctx.prob = prob
        ctx.mesh = comm.active()  # the backward's GMRES decides over the same ranks
        kept = (lb, ub, *leaves)
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in kept]
        ctx.others = [None if t else a for a, t in zip(kept, ctx.is_tensor)]
        ctx.save_for_backward(x, u, du, *[a for a, t in zip(kept, ctx.is_tensor) if t])

    @staticmethod
    def backward(ctx, g_x, g_u, *_):
        x, u, du_norm, *tens = ctx.saved_tensors
        it = iter(tens)
        lb, ub, *leaves = [next(it).detach() if t else o
                           for t, o in zip(ctx.is_tensor, ctx.others)]
        prob = ctx.prob
        cost_in, dyn_in = pytree.tree_unflatten(leaves, prob.treedef)
        with comm.batch_global(ctx.mesh):
            d_x_init, d_cost_in, d_dyn_in = _backward(prob, x, u, du_norm, lb, ub, cost_in,
                                                      dyn_in, g_x, g_u)
        grads = pytree.tree_leaves((d_cost_in, d_dyn_in), is_leaf=lambda a: a is None)
        if len(grads) != len(leaves):
            raise RuntimeError("internal: cotangent structure differs from the inputs'")
        return (None, d_x_init) + (None,) * 6 + tuple(grads)

    @staticmethod
    def vmap(info, in_dims, prob, *args):
        """torch.func.vmap over the solve (JAX's _maybe_vmap_route,
        ilqr_fused.py:1523-1699). merged: when the folded sweep takes the
        whole-solve kernel and no dynamics param is batched, one solve of
        S*B examples -- one launch, and under autograd one backward --
        unfolded after; n_iter is that solve's, the max over every
        candidate. mapped otherwise (batched params; the plain loop): one
        solve a candidate, each with its own stopping rule, as JAX's vmap
        over its while_loop gives. A nested vmap comes back here through
        the inner apply."""
        S = info.batch_size
        args = [a if d is None else a.movedim(d, 0) for a, d in zip(args, in_dims[1:])]
        batched = [d is not None for d in in_dims[1:]]
        folded = _fold(prob, S, args, batched)
        if folded is not None:
            VMAP_STATS["vmap_merged"] += 1
            x, u, costs, du, n_iter = _SolveWithGrad.apply(prob, *folded)
            B = costs.shape[0] // S
            return ((x.unflatten(1, (S, B)), u.unflatten(1, (S, B)), costs.unflatten(0, (S, B)),
                     du.unflatten(0, (S, B)), n_iter), (1, 1, 0, 0, None))
        VMAP_STATS["vmap_mapped"] += 1
        outs = [_SolveWithGrad.apply(prob, *[a[s] if b else a for a, b in zip(args, batched)])
                for s in range(S)]
        return tuple(torch.stack(o) for o in zip(*outs)), (0,) * 5


# Function.apply binds its arguments to forward's signature on every call
# (the setup_context form): one signature computed once, of *args alone,
# keeps that off each serving solve's host time
_SolveWithGrad.forward.__signature__ = inspect.signature(_SolveWithGrad.forward)


def _backward(prob: _Problem, x, u, du_norm, lb, ub, cost_in, dyn_in, g_x, g_u):
    """Cotangents of (x_init, cost_in, dyn_in) for the output cotangents
    (g_x, g_u) [T, B, ...] (modes.py:173-348)."""
    cfg = prob.cfg
    nx, nu = cfg.n_state, cfg.n_ctrl
    if cfg.detach_unconverged:
        conv = (du_norm < cfg.eps)[None, :, None]
        g_x = torch.where(conv, g_x, torch.zeros_like(g_x))
        g_u = torch.where(conv, g_u, torch.zeros_like(g_u))

    # --- problem data at the solution ---
    if prob.quad:
        C, c = cost_in
        cost_pullback = None
    elif not pytree.tree_leaves(cost_in):  # no cost parameters to differentiate
        C, c, _ = approximate_cost(lambda tau: prob.cost_fn(tau, cost_in), x, u)
        cost_pullback = lambda _: (cost_in,)  # noqa: E731
    else:
        (C, c), cost_pullback = torch.func.vjp(
            lambda cp: approximate_cost(lambda tau: prob.cost_fn(tau, cp), x, u)[:2],
            cost_in)

    if prob.lin:
        F, f = dyn_in
        lin_pullback = None
    else:
        lin_map = _linearize_for_vjp(cfg, prob.dyn_static)
        if cfg.backward_mode is not BackwardMode.IFT and not cfg.kkt_grad_through_F:
            # reference-compat KKT chain: F enters as a constant; the params
            # chain of f is only the new_x evaluation. f + (F - sg(F)) tau
            # has f's value, and its params cotangent drops dF/dtheta
            base_lin = lin_map

            def lin_map(x_, u_, p_):
                F_, f_ = base_lin(x_, u_, p_)
                Fc = F_.detach()
                tau = torch.cat([x_, u_], -1)[:-1]
                return Fc, f_ + bmv(F_ - Fc, tau)

        (F, f), lin_pullback = torch.func.vjp(lin_map, x, u, dyn_in)

    I = _active_set(u, lb, ub)
    # the KKT-VJP operator is built once; each GMRES iteration applies it
    vjp_fn = make_kkt_vjp(nx, nu, C, c, F, x, u, u_zero_I=I, with_f=True,
                          backend=cfg.backward_backend or cfg.backend,
                          parallel=cfg.riccati_parallel)

    if cfg.backward_mode is BackwardMode.IFT and not prob.lin:

        def sT_Ff(w):
            kg = vjp_fn(w[0], w[1], wants="Ff")
            return kg.dF, kg.df

        def lT_xu(dF, df):
            dX, dU, _ = lin_pullback((dF, df))
            return dX, dU

        if cfg.ift_solver == "dense":
            w = solve_adjoint_dense(sT_Ff, lT_xu, (g_x, g_u))
        else:
            w, res_b, b_norm_b = solve_adjoint_fixed_point(
                sT_Ff, lT_xu, (g_x, g_u), tol=cfg.backward_tol,
                restart=cfg.ift_restart, maxiter=cfg.ift_maxiter)
            # per-example accounting: one ill-conditioned example in an
            # easy batch is detected and repaired on its own
            bad_b = res_b > cfg.backward_tol * (b_norm_b + 1e-30)
            n_bad = int(bad_b.sum())
            if n_bad:
                ratio = res_b / (b_norm_b + 1e-30)
                i = int(ratio.argmax())
                warnings.warn(
                    f"IFT GMRES adjoint did not converge for {n_bad}/{bad_b.shape[0]} "
                    f"examples (worst: example {i}, residual {float(res_b[i]):.3e} vs tol "
                    f"{cfg.backward_tol:.1e} * ||b||={float(b_norm_b[i]):.3e})"
                    + ("; falling back to the dense probing solve for those examples"
                       if cfg.ift_fallback else
                       "; gradients may be inaccurate -- set ift_solver='dense' or "
                       "raise ift_maxiter"))
                if cfg.ift_fallback:
                    # the dense probe is exact; only the failing examples
                    # take its answer
                    wd = solve_adjoint_dense(sT_Ff, lT_xu, (g_x, g_u))
                    m = bad_b[None, :, None]
                    w = (torch.where(m, wd[0], w[0]), torch.where(m, wd[1], w[1]))
        kg = vjp_fn(w[0], w[1])
    else:
        kg = vjp_fn(g_x, g_u)

    # --- chain to the differentiable inputs ---
    if prob.quad:
        d_cost_in = (kg.dC, kg.dc)
    else:
        (d_cost_in,) = cost_pullback((kg.dC, kg.dc))
    if prob.lin:
        d_dyn_in = (kg.dF, kg.df if dyn_in[1] is not None else None)
    else:
        _, _, d_dyn_in = lin_pullback((kg.dF, kg.df))
    return kg.dx_init, d_cost_in, d_dyn_in


def solve_with_grad(cfg: ILQRConfig, cost, dyn, params, x_init, u_init, lb, ub, uz,
                    delta_u, cost_small=None, u_init_zero: bool = False):
    """Returns time-major (x, u, costs, full_du_norm, n_iter).

    cost: QuadCost, (cost_fn, cost_params) or a parameterless callable.
    cost_small / u_init_zero: forward-only hints for the kernel; cost_small
    gets no gradient -- the backward differentiates the canonical broadcast
    cost tensors."""
    lin = isinstance(dyn, LinDx)
    quad = isinstance(cost, QuadCost)
    cost_fn = None
    if quad:
        cost_in = tuple(cost)
    elif isinstance(cost, tuple):
        cost_fn, cost_in = cost
    else:
        base = cost
        cost_fn = lambda tau, _p: base(tau)  # noqa: E731
        cost_in = ()
    dyn_in = tuple(dyn) if lin else params
    leaves, treedef = pytree.tree_flatten((cost_in, dyn_in))
    prob = _Problem(cfg, quad, cost_fn, lin, None if lin else dyn, treedef,
                    len(pytree.tree_leaves(cost_in)), delta_u, u_init_zero)
    Cs, cs = (None, None) if cost_small is None else cost_small

    if cfg.backprop and cfg.backward_mode is BackwardMode.UNROLL:
        if not cfg.unroll:
            raise ValueError("BackwardMode.UNROLL requires cfg.unroll=True")
        x, u, costs, du, n_iter = prob.primal(x_init, u_init, lb, ub, uz, cost_small, cost_in,
                                              dyn_in)
        if cfg.detach_unconverged:
            m = (du.detach() < cfg.eps)[None, :, None]
            x = torch.where(m, x, x.detach())
            u = torch.where(m, u, u.detach())
        return x, u, costs.detach(), du.detach(), n_iter

    args = (prob, x_init, u_init, lb, ub, uz, Cs, cs, *leaves)
    if not cfg.backprop:
        with torch.no_grad():
            return _SolveWithGrad.apply(*args)
    return _SolveWithGrad.apply(*args)
