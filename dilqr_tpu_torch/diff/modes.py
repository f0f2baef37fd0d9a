"""Differentiation-mode dispatch (counterpart of ``dilqr_tpu/diff/modes.py``):
wires the forward iLQR solve to its backward through
``torch.autograd.Function``s.

Three modes (types.BackwardMode):
  KKT    -- the O(T) module-KKT VJP of the last LQR subproblem plus the
            linearization chain;
  IFT    -- fixed-point implicit differentiation, matrix-free (diff/ift.py);
  UNROLL -- autograd through the plain loop (cfg.unroll must be True); the
            gradient oracle.

The Function's differentiable inputs are x_init, the cost inputs and the
dynamics inputs; the warm start, bounds, masks and delta_u are arguments
too but get no gradient, as the reference detaches its bounds. Inside the
Function the forward is the same ``ilqr_loop`` as without a backward
(backprop=False runs the Function under no_grad), so a covered
configuration on CUDA tensors runs the whole-solve kernel; it gets the
detached cost and params, and the gradient flows through the canonical
broadcast cost. The KKT and IFT backward is a Function of its own
(``_SolveBackward``), so that torch.func transforms of a gradient reach
it. Each Function has a vmap rule (``VMAP_STATS`` counts the routes):

  * the forward's folds a sweep into one solve where that runs the
    whole-solve kernel, else one solve a candidate (a batched dynamics
    param or delta_u, the plain loop);
  * the backward's (``torch.func.vmap`` over ``torch.func.grad``,
    ``jacrev``, ``vmap`` over a ``vjp``, and ``autograd.grad(...,
    is_grads_batched=True)``, whose older vmap the Function unwraps by
    hand) folds the candidates into one adjoint solve where the KKT VJP
    is the CUDA kernel, with each candidate's dynamics-param cotangent
    pulled back from its own examples, else one backward a candidate.

UNROLL is plain autograd through the plain loop, unless a torch.func
transform is active: then ``_Unrolled`` runs the loop without a graph in
its forward, and its backward (``_UnrolledBackward``) runs the same loop
again with one and differentiates it -- one more plain-loop forward per
backward, on the oracle path only, for Functions that vmap can map a
candidate at a time.
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
from . import kkt
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
    """What the Functions close over: the configuration and the static
    parts of the cost and dynamics. Everything that may be a tensor -- the
    warm start, the bounds, the mask, delta_u, the compact-cost hint -- is
    an argument of the Functions instead, so that ``torch.func.vmap`` sees
    its batch dimension."""

    def __init__(self, cfg, quad, cost_fn, lin, dyn_static, treedef, n_cost, u_init_zero,
                 cost_of_tau=None):
        self.cfg, self.quad, self.cost_fn = cfg, quad, cost_fn
        self.lin, self.dyn_static, self.treedef = lin, dyn_static, treedef
        self.n_cost, self.u_init_zero = n_cost, u_init_zero
        # a cost the user gave as a function of tau alone, which the kernel
        # traces as it is (cost_fn wraps it anew each solve)
        self.cost_of_tau = cost_of_tau

    def cost_struct(self, cost_in):
        """What the kernel traces of a callable cost: (cost_fn, cost_params),
        or (the user's cost of tau, None); None for a QuadCost."""
        if self.quad:
            return None
        return (self.cost_fn, cost_in) if self.cost_of_tau is None else (self.cost_of_tau, None)

    def n_time(self, n_leaves: int) -> int:
        """How many leaves are time-major [T(-1), B, ...]: C, c and a
        LinDx's F, f; the dynamics params are not."""
        return n_leaves if self.lin else self.n_cost

    def cost_obj(self, cost_in):
        if self.quad:
            return QuadCost(*cost_in)
        return lambda tau: self.cost_fn(tau, cost_in)

    def dyn_obj(self, dyn_in):
        """(the dynamics ilqr_loop takes, its params)."""
        return (LinDx(*dyn_in), None) if self.lin else (self.dyn_static, dyn_in)

    def primal(self, x_init, u_init, lb, ub, uz, delta_u, cost_small, cost_in, dyn_in,
               warn: bool = True):
        dyn_obj, p = self.dyn_obj(dyn_in)
        cfg = self.cfg
        # a callable cost also goes down as its (cost_fn, cost_params), whose
        # trace the kernel runs (JAX's cost_struct, modes.py:137-139)
        out = ilqr_loop(cfg, self.cost_obj(cost_in), dyn_obj, p, x_init, u_init,
                        u_lower=lb, u_upper=ub, u_zero_I=uz, delta_u=delta_u,
                        cost_small=cost_small, u_init_zero=self.u_init_zero,
                        cost_struct=self.cost_struct(cost_in))
        if cfg.exit_unconverged and warn:
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


# which route each torch.func.vmap over the solve (vmap_*) and over its
# backward (bwd_*) took (JAX's DISPATCH_STATS,
# dilqr_tpu/ops/pallas/ilqr_fused.py:1509)
VMAP_STATS = {"vmap_merged": 0, "vmap_mapped": 0, "bwd_merged": 0, "bwd_mapped": 0}


def _fold_axis(a, b, S: int, axis: int):
    """The mapped axis (at 0 when ``b``) folded into ``axis``,
    candidate-major (example s*B + b); an unbatched tensor tiled S times."""
    if a is None:
        return None
    a = a if b else a.expand(S, *a.shape)
    return a.movedim(0, axis).flatten(axis, axis + 1)


def _fold_bound(v, b, S: int, T: int, B: int, nu: int):
    """A bound of the folded solve: a batched one ([S], [S, nu] or [S, T, B,
    nu]) as [T, S*B, nu], per-example bounds tiled, the rest as they are."""
    if b:
        v = v.reshape(S, 1, 1, -1) if v.dim() <= 2 else v
        return _fold_axis(v.expand(S, T, B, nu), True, S, 1)
    if isinstance(v, torch.Tensor) and v.dim() == 3:
        return _fold_axis(v, False, S, 1)  # per-example bounds: S copies
    return v  # None, a number, 0-d or [nu]: the same for every example


def _fold(prob: _Problem, S: int, args, batched):
    """The merged route's arguments: the mapped axis (at 0 of every batched
    argument) folded into the example batch, candidate-major (example s*B +
    b), unbatched per-example arguments tiled S times (JAX's merge and
    tile, ilqr_fused.py:1623-1632); None when the folded solve would not
    take the whole-solve kernel."""
    x_init, u_init, lb, ub, uz, delta_u, Cs, cs, *leaves = args
    bx, bu0, blb, bub, buz, bdu, bCs, bcs, *bl = batched
    if not prob.quad or bdu or (not prob.lin and any(bl[prob.n_cost:])):
        # a batched params leaf: the kernel reads one params vector; a
        # batched delta_u: one static scalar (JAX keeps it out of its fold)
        return None
    T, nu = prob.cfg.T, prob.cfg.n_ctrl
    B = x_init.shape[1] if bx else x_init.shape[0]
    # a batched compact cost goes as the per-example pair (JAX's promotion
    # to lane costs, :1647-1669)
    small = bCs or bcs
    out = [_fold_axis(x_init, bx, S, 0), _fold_axis(u_init, bu0, S, 1),
           _fold_bound(lb, blb, S, T, B, nu), _fold_bound(ub, bub, S, T, B, nu),
           _fold_axis(uz, buz, S, 1), delta_u, None if small else Cs, None if small else cs]
    n_time = prob.n_time(len(leaves))
    out += [_fold_axis(a, b, S, 1) if i < n_time else a
            for i, (a, b) in enumerate(zip(leaves, bl))]
    cost_in, dyn_in = pytree.tree_unflatten(out[8:], prob.treedef)
    dyn, params = prob.dyn_obj(dyn_in)
    x_f, _, lb_f, ub_f, uz_f, _, Cs_f, cs_f = out[:8]
    if not ilqr.use_kernel(prob.cfg, QuadCost(*cost_in), dyn, ilqr.kernel_params(dyn, params),
                           x_f, uz_f, delta_u, None if Cs_f is None else (Cs_f, cs_f),
                           lb_f, ub_f, prob.u_init_zero):
        return None
    return out


def _stack(outs):
    """(outputs, out_dims) of the mapped routes: each output stacked over
    the candidates at 0; an output that is None for every candidate stays
    None (out_dim None)."""
    cols = list(zip(*outs))
    return (tuple(None if c[0] is None else torch.stack(c) for c in cols),
            tuple(None if c[0] is None else 0 for c in cols))


def _unbatched(args, in_dims):
    """(args with their mapped axis at 0, which are batched)."""
    return ([a if d is None else a.movedim(d, 0) for a, d in zip(args, in_dims)],
            [d is not None for d in in_dims])


class _SolveWithGrad(torch.autograd.Function):
    """custom-VJP counterpart: forward = the solve, backward = KKT or IFT
    (``_SolveBackward``), and a vmap rule that folds a sweep into one solve.

    apply(prob, x_init, u_init, lb, ub, uz, delta_u, Cs, cs, *leaves):
    leaves are the flattened (cost inputs, dynamics inputs), the
    differentiable ones; (Cs, cs) is the compact-cost hint or (None, None)."""

    @staticmethod
    def forward(*args):
        prob, x_init, u_init, lb, ub, uz, delta_u, Cs, cs, *leaves = args
        cost_in, dyn_in = pytree.tree_unflatten(
            [a.detach() if isinstance(a, torch.Tensor) else a for a in leaves], prob.treedef)
        return prob.primal(x_init.detach(), u_init, lb, ub, uz, delta_u,
                           None if Cs is None else (Cs, cs), cost_in, dyn_in)

    @staticmethod
    def setup_context(ctx, inputs, output):
        prob, _, _, lb, ub, _, _, _, _, *leaves = inputs
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
        args = (x, u, du_norm, lb, ub, g_x, g_u, *leaves)
        if any(torch._C._functorch.is_legacy_batchedtensor(g) for g in (g_x, g_u)):
            grads = _legacy_batched_backward(ctx.prob, ctx.mesh, args)
        else:
            grads = _SolveBackward.apply(ctx.prob, ctx.mesh, None, *args)
        return (None, grads[0]) + (None,) * 7 + tuple(grads[1:])

    @staticmethod
    def vmap(info, in_dims, prob, *args):
        """torch.func.vmap over the solve (JAX's _maybe_vmap_route,
        ilqr_fused.py:1523-1699). merged: when the folded sweep takes the
        whole-solve kernel and no dynamics param or delta_u is batched, one
        solve of S*B examples -- one launch, and under autograd one
        backward -- unfolded after; n_iter is that solve's, the max over
        every candidate. mapped otherwise (batched params or delta_u; the
        plain loop): one solve a candidate, each with its own stopping
        rule, as JAX's vmap over its while_loop gives. A nested vmap comes
        back here through the inner apply."""
        S = info.batch_size
        args, batched = _unbatched(args, in_dims[1:])
        folded = _fold(prob, S, args, batched)
        if folded is not None:
            VMAP_STATS["vmap_merged"] += 1
            x, u, costs, du, n_iter = _SolveWithGrad.apply(prob, *folded)
            B = costs.shape[0] // S
            return ((x.unflatten(1, (S, B)), u.unflatten(1, (S, B)), costs.unflatten(0, (S, B)),
                     du.unflatten(0, (S, B)), n_iter), (1, 1, 0, 0, None))
        VMAP_STATS["vmap_mapped"] += 1
        return _stack([_SolveWithGrad.apply(prob,
                                            *[a[s] if b else a for a, b in zip(args, batched)])
                       for s in range(S)])


# Function.apply binds its arguments to forward's signature on every call
# (the setup_context form): one signature computed once, of *args alone,
# keeps that off each serving solve's host time
_SolveWithGrad.forward.__signature__ = inspect.signature(_SolveWithGrad.forward)


class _SolveBackward(torch.autograd.Function):
    """The KKT/IFT backward of the solve as a Function, so that a
    torch.func transform of the gradient reaches its vmap rule.

    apply(prob, mesh, n_cand, x, u, du_norm, lb, ub, g_x, g_u, *leaves) ->
    (d_x_init, *d_leaves), the cotangents of x_init and the leaves (None
    where a leaf gets none). ``n_cand``: None, or the number of candidates
    folded candidate-major into the batch, whose dynamics-param cotangents
    then come one a candidate, [n_cand, ...]. Not differentiable itself, as
    JAX does not differentiate a custom_vjp's bwd."""

    @staticmethod
    def forward(*args):
        prob, mesh, n_cand, x, u, du_norm, lb, ub, g_x, g_u, *leaves = args
        cost_in, dyn_in = pytree.tree_unflatten(leaves, prob.treedef)
        with comm.batch_global(mesh):
            d_x_init, d_cost_in, d_dyn_in = _backward(prob, x, u, du_norm, lb, ub, cost_in,
                                                      dyn_in, g_x, g_u, n_cand)
        grads = pytree.tree_leaves((d_cost_in, d_dyn_in), is_leaf=lambda a: a is None)
        if len(grads) != len(leaves):
            raise RuntimeError("internal: cotangent structure differs from the inputs'")
        return (d_x_init, *grads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *_):
        raise RuntimeError("the solve's backward is not differentiable: a gradient of a "
                           "gradient through the solve is not supported")

    @staticmethod
    def vmap(info, in_dims, prob, mesh, n_cand, *args):
        """The backward of S candidates at once (JAX's vmap over its
        custom_vjp bwd): merged or mapped, see ``_backward_rule``."""
        args, batched = _unbatched(args, in_dims[3:])
        return _backward_rule(prob, mesh, n_cand, info.batch_size, args, batched)


_SolveBackward.forward.__signature__ = inspect.signature(_SolveBackward.forward)


def _merges_backward(prob: _Problem, args, batched) -> bool:
    """The merged backward: every candidate's adjoint solve in one of S*B
    examples, where the folded KKT VJP is the CUDA kernel. Not with
    batched dynamics params (each candidate linearizes with its own) nor
    with cost params, whose cotangent the backward sums over the batch."""
    if (not prob.lin and any(batched[7 + prob.n_cost:])) or (not prob.quad and prob.n_cost):
        return False
    cfg = prob.cfg
    return kkt.use_kernel(cfg.T, cfg.n_state, cfg.n_ctrl, args[0],
                          cfg.backward_backend or cfg.backend, cfg.riccati_parallel)


def _backward_rule(prob: _Problem, mesh, n_cand, S: int, args, batched):
    """(outputs, out_dims) of S backwards, the mapped axis of each batched
    argument at 0. merged (``_merges_backward``): the candidates folded
    candidate-major as the forward's fold does -- x, u, the cotangents and
    the time-major leaves along the example axis, du_norm along 0,
    unbatched ones tiled -- into one ``_backward``: one GMRES, whose
    matvecs are KKT-kernel launches on S*B examples, until every
    candidate's residual meets its tolerance; each per-example cotangent
    unfolded after, the dynamics params' pulled back a candidate at a
    time. mapped otherwise: one backward a candidate, each with its own
    GMRES exit rule and IFT warning, as JAX's vmap over its while_loop."""
    if not _merges_backward(prob, args, batched):
        VMAP_STATS["bwd_mapped"] += 1
        return _stack([_SolveBackward.apply(prob, mesh, n_cand,
                                            *[a[s] if b else a for a, b in zip(args, batched)])
                       for s in range(S)])
    VMAP_STATS["bwd_merged"] += 1
    x, u, du, lb, ub, gx, gu, *leaves = args
    bx, bu, bdu, blb, bub, bgx, bgu, *bl = batched
    T, nu = prob.cfg.T, prob.cfg.n_ctrl
    B = x.shape[2] if bx else x.shape[1]
    folded = [_fold_axis(x, bx, S, 1), _fold_axis(u, bu, S, 1), _fold_axis(du, bdu, S, 0),
              _fold_bound(lb, blb, S, T, B, nu), _fold_bound(ub, bub, S, T, B, nu),
              _fold_axis(gx, bgx, S, 1), _fold_axis(gu, bgu, S, 1)]
    n_time = prob.n_time(len(leaves))
    folded += [_fold_axis(a, b, S, 1) if i < n_time else a
               for i, (a, b) in enumerate(zip(leaves, bl))]
    n_out = S * (n_cand or 1)
    d_x_init, *grads = _SolveBackward.apply(prob, mesh, n_out, *folded)
    outs, dims = [d_x_init.unflatten(0, (S, B))], [0]
    for i, g in enumerate(grads):
        if g is None:
            outs.append(None)
            dims.append(None)
        elif i < n_time:  # per example, time-major
            outs.append(g.unflatten(1, (S, B)))
            dims.append(1)
        else:  # the dynamics params, [n_out, ...] a candidate
            outs.append(g if n_cand is None else g.unflatten(0, (S, n_cand)))
            dims.append(0)
    return tuple(outs), tuple(dims)


def _legacy_batched_backward(prob: _Problem, mesh, args):
    """The backward under ``autograd.grad(..., is_grads_batched=True)``,
    whose cotangents torch batches by its older vmap, which runs no
    Function's vmap rule: the batched arguments are unwrapped at that
    vmap's level, ``_backward_rule`` runs on the plain [S, ...] tensors,
    and its outputs are wrapped at the same level again."""
    level = torch._C._vmapmode_increment_nesting() - 1
    torch._C._vmapmode_decrement_nesting()
    batched = [isinstance(a, torch.Tensor) and torch._C._functorch.is_legacy_batchedtensor(a)
               for a in args]
    # the batch size argument is read only for an unbatched tensor
    args = [torch._remove_batch_dim(a, level, 1, 0) if b else a for a, b in zip(args, batched)]
    S = next(a.shape[0] for a, b in zip(args, batched) if b)
    outs, dims = _backward_rule(prob, mesh, None, S, args, batched)
    return [o if d is None else torch._add_batch_dim(o, d, level) for o, d in zip(outs, dims)]


class _Unrolled(torch.autograd.Function):
    """BackwardMode.UNROLL under a torch.func transform: forward = the plain
    loop with no graph; backward = ``_UnrolledBackward``, the same loop
    again with one, differentiated. apply takes _SolveWithGrad's arguments.
    Both vmap rules map: one solve (one backward) a candidate, each with
    its own stopping rule, as JAX's vmap over its unrolled loop."""

    @staticmethod
    def forward(*args):
        prob, x_init, u_init, lb, ub, uz, delta_u, Cs, cs, *leaves = args
        cost_in, dyn_in = pytree.tree_unflatten(leaves, prob.treedef)
        with torch.no_grad():
            return prob.primal(x_init, u_init, lb, ub, uz, delta_u,
                               None if Cs is None else (Cs, cs), cost_in, dyn_in)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output[2:])
        ctx.prob = inputs[0]
        ctx.needs = ctx.needs_input_grad[1:]
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in inputs[1:]]
        ctx.others = [None if t else a for a, t in zip(inputs[1:], ctx.is_tensor)]
        ctx.save_for_backward(*[a for a, t in zip(inputs[1:], ctx.is_tensor) if t])

    @staticmethod
    def backward(ctx, g_x, g_u, *_):
        it = iter(ctx.saved_tensors)
        args = [next(it) if t else o for t, o in zip(ctx.is_tensor, ctx.others)]
        return (None,) + tuple(_UnrolledBackward.apply(ctx.prob, ctx.needs, g_x, g_u, *args))

    @staticmethod
    def vmap(info, in_dims, prob, *args):
        VMAP_STATS["vmap_mapped"] += 1
        args, batched = _unbatched(args, in_dims[1:])
        return _stack([_Unrolled.apply(prob, *[a[s] if b else a for a, b in zip(args, batched)])
                       for s in range(info.batch_size)])


class _UnrolledBackward(torch.autograd.Function):
    """apply(prob, needs, g_x, g_u, *args) -> the cotangent of each of
    _Unrolled's arguments (None where ``needs`` wants none): the plain loop
    run again on detached copies, those that need a gradient requiring
    one, and differentiated at (g_x, g_u) -- the graph plain autograd
    through the loop builds, hence its bits. Not differentiable itself."""

    @staticmethod
    def forward(prob, needs, g_x, g_u, *args):
        want = [n and isinstance(a, torch.Tensor) for a, n in zip(args, needs)]
        ins = [a.detach().requires_grad_(w) if isinstance(a, torch.Tensor) else a
               for a, w in zip(args, want)]
        x_init, u_init, lb, ub, uz, delta_u, Cs, cs, *leaves = ins
        cost_in, dyn_in = pytree.tree_unflatten(leaves, prob.treedef)
        with torch.enable_grad():
            x, u, *_ = prob.primal(x_init, u_init, lb, ub, uz, delta_u,
                                   None if Cs is None else (Cs, cs), cost_in, dyn_in, warn=False)
            got = iter(torch.autograd.grad((x, u), [a for a, w in zip(ins, want) if w],
                                           (g_x, g_u), allow_unused=True))
        return tuple(next(got) if w else None for w in want)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *_):
        raise RuntimeError("the unrolled solve's backward under a torch.func transform is not "
                           "differentiable: a gradient of such a gradient is not supported")

    @staticmethod
    def vmap(info, in_dims, prob, needs, *args):
        VMAP_STATS["bwd_mapped"] += 1
        args, batched = _unbatched(args, in_dims[2:])
        return _stack([_UnrolledBackward.apply(prob, needs,
                                               *[a[s] if b else a for a, b in zip(args, batched)])
                       for s in range(info.batch_size)])


def _params_by_candidate(lin_map, x, u, params, dF, df, n_cand: int):
    """The dynamics-param cotangent of each of n_cand candidates folded
    candidate-major into the batch, [n_cand, ...]: the linearization's VJP
    on each candidate's own examples (JAX's per-candidate gradient sums
    those alone)."""

    def split(a):
        return a.unflatten(1, (n_cand, -1)).movedim(1, 0)

    def one(x_, u_, dF_, df_):
        return torch.func.vjp(lambda p_: lin_map(x_, u_, p_), params)[1]((dF_, df_))[0]

    return torch.func.vmap(one)(split(x), split(u), split(dF), split(df))


def _backward(prob: _Problem, x, u, du_norm, lb, ub, cost_in, dyn_in, g_x, g_u,
              n_cand: Optional[int] = None):
    """Cotangents of (x_init, cost_in, dyn_in) for the output cotangents
    (g_x, g_u) [T, B, ...] (modes.py:173-348); with ``n_cand`` the dynamics
    params' come one a candidate (_params_by_candidate)."""
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
    elif n_cand is None:
        _, _, d_dyn_in = lin_pullback((kg.dF, kg.df))
    else:
        d_dyn_in = _params_by_candidate(lin_map, x, u, dyn_in, kg.dF, kg.df, n_cand)
    return kg.dx_init, d_cost_in, d_dyn_in


def _problem(cfg: ILQRConfig, cost, dyn, params, u_init_zero: bool = False):
    """(the _Problem of a solve, its differentiable leaves)."""
    lin = isinstance(dyn, LinDx)
    quad = isinstance(cost, QuadCost)
    cost_fn = cost_of_tau = None
    if quad:
        cost_in = tuple(cost)
    elif isinstance(cost, tuple):
        cost_fn, cost_in = cost
    else:
        cost_of_tau = cost
        cost_fn = lambda tau, _p: cost_of_tau(tau)  # noqa: E731
        cost_in = ()
    dyn_in = tuple(dyn) if lin else params
    leaves, treedef = pytree.tree_flatten((cost_in, dyn_in))
    return _Problem(cfg, quad, cost_fn, lin, None if lin else dyn, treedef,
                    len(pytree.tree_leaves(cost_in)), u_init_zero, cost_of_tau), leaves


def solve_with_grad(cfg: ILQRConfig, cost, dyn, params, x_init, u_init, lb, ub, uz,
                    delta_u, cost_small=None, u_init_zero: bool = False):
    """Returns time-major (x, u, costs, full_du_norm, n_iter).

    cost: QuadCost, (cost_fn, cost_params) or a parameterless callable.
    cost_small / u_init_zero: forward-only hints for the kernel; cost_small
    gets no gradient -- the backward differentiates the canonical broadcast
    cost tensors."""
    prob, leaves = _problem(cfg, cost, dyn, params, u_init_zero)
    Cs, cs = (None, None) if cost_small is None else cost_small
    args = (prob, x_init, u_init, lb, ub, uz, delta_u, Cs, cs, *leaves)

    if cfg.backprop and cfg.backward_mode is BackwardMode.UNROLL:
        if not cfg.unroll:
            raise ValueError("BackwardMode.UNROLL requires cfg.unroll=True")
        if torch._C._functorch.maybe_current_level() is None:
            # plain autograd through the plain loop: no torch.func transform
            # to see it, and a gradient of the gradient stays available
            x, u, costs, du, n_iter = prob.primal(x_init, u_init, lb, ub, uz, delta_u,
                                                  cost_small, *pytree.tree_unflatten(
                                                      leaves, prob.treedef))
            costs, du = costs.detach(), du.detach()
        else:
            x, u, costs, du, n_iter = _Unrolled.apply(*args)
        if cfg.detach_unconverged:
            m = (du < cfg.eps)[None, :, None]
            x = torch.where(m, x, x.detach())
            u = torch.where(m, u, u.detach())
        return x, u, costs, du, n_iter

    if not cfg.backprop:
        with torch.no_grad():
            return _SolveWithGrad.apply(*args)
    return _SolveWithGrad.apply(*args)
