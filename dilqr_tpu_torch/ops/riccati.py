"""Backward Riccati recursion producing time-varying affine feedback gains
(counterpart of the sequential ``lax.scan`` in ``dilqr_tpu/ops/riccati.py``).

Per step, in reverse time:
    Q_t = C_t + F_t^T V_{t+1} F_t
    q_t = c_t + F_t^T V_{t+1} f_t + F_t^T v_{t+1}
then the gains:
  * unconstrained, n_ctrl == 1: scalar reciprocal
  * unconstrained, general: batched solve
  * u_zero_I zero-control constraints: masked solve with 1e-8 on the frozen
    diagonal; for n_ctrl == 1, k divides by the UNmasked Quu (reference
    quirk, lqr_step.py:121-123)
  * box bounds, n_ctrl == 1 and qp_solver "auto": the exact closed-form 1-D
    box-QP clamp(-q/H, l, u)
  * box bounds otherwise: pnqp in delta-space bounds, warm-started with
    k_{t+1}; active rows of Q_ux zeroed before forming K
and the cost-to-go update.

``lqr_backward`` sends what the JAX package sends to its fused Pallas
Riccati kernel (ops/riccati.py:135-163 there) to the hand-written CUDA
kernel ``ops/cuda/riccati_fused.py``: one control, f32, the closed-form QP,
no f, any n_state, on CUDA tensors, with nothing to differentiate. With
``parallel`` an unboxed solve takes the associative-scan Riccati
(``ops/parallel_riccati.py``) instead.

Shapes (time-major): C [T,B,n,n], c [T,B,n], F [T-1,B,nx,n], f [T-1,B,nx]
or None. Returns K [T,B,nu,nx], k [T,B,nu] ordered t=0..T-1.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..types import BACKENDS
from ..utils.batch import bger, bmm, bmv, btr, clamp, solve_psd
from .cuda import riccati_fused as fused
from .parallel_riccati import plqr_backward
from .pnqp import pnqp


class RiccatiResult(NamedTuple):
    K: torch.Tensor  # [T, B, nu, nx]
    k: torch.Tensor  # [T, B, nu]
    n_total_qp_iter: int


def _unconstrained_gains(n_ctrl, Quu, Qux, qu):
    if n_ctrl == 1:
        return -Qux / Quu, -qu / Quu[..., 0]
    sol = solve_psd(Quu, torch.cat([Qux, qu[..., None]], -1))
    return -sol[..., :-1], -sol[..., -1]


def _zero_constrained_gains(n_ctrl, Quu, Qux, qu, I_t):
    """Gains with u_i = 0 on the active mask I_t [B, nu] (1 = frozen)."""
    notI = 1.0 - I_t
    qu_ = qu * notI
    eye = torch.eye(n_ctrl, dtype=Quu.dtype, device=Quu.device)
    Quu_ = Quu * bger(notI, notI) + 1e-8 * I_t[..., :, None] * eye
    Qux_ = Qux * notI[..., None]
    if n_ctrl == 1:
        return -Qux_ / Quu_, -qu_ / Quu[..., 0]
    sol = solve_psd(Quu_, torch.cat([Qux_, qu_[..., None]], -1))
    return -sol[..., :-1], -sol[..., -1]


def expand_bound(v, T: int, B: int, nu: int, like: torch.Tensor) -> torch.Tensor:
    """Bound (scalar | [nu] | [T,B,nu]) -> [T, B, nu] tensor."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.expand(T, B, nu)


def _use_kernel(backend, nx, nu, C, c, F, f, u, u_lower, u_upper, u_zero_I,
                qp_solver) -> bool:
    ok = fused.covered(nx, nu, C.dtype, u_zero_I, qp_solver, u_lower is not None, f)
    grad = torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad
        for a in (C, c, F, u, u_lower, u_upper))
    if backend == "cuda":
        if not C.is_cuda:
            raise ValueError("backend='cuda' needs CUDA tensors; CPU tensors take "
                             "backend='auto' or 'torch'")
        if not ok:
            raise ValueError("backend='cuda': this configuration is not covered by the "
                             "CUDA Riccati kernel (see ops/cuda/riccati_fused.covered)")
        if grad:
            raise ValueError("backend='cuda': the CUDA Riccati kernel has no autograd "
                             "rule; differentiate with backend='torch'")
        return True
    return ok and C.is_cuda and not grad


def lqr_backward(
    n_state: int,
    n_ctrl: int,
    C: torch.Tensor,
    c: torch.Tensor,
    F: Optional[torch.Tensor],
    f: Optional[torch.Tensor],
    u: torch.Tensor,
    u_lower=None,
    u_upper=None,
    u_zero_I: Optional[torch.Tensor] = None,
    delta_u=None,
    pnqp_iter: int = 20,
    qp_solver: str = "auto",
    backend: str = "auto",
    parallel: bool = False,
) -> RiccatiResult:
    """Reverse-time Riccati recursion. ``u`` [T,B,nu] is the current
    control iterate; with box bounds the QP is solved in delta space
    around it.

    backend: "auto" takes the CUDA kernel (``ops/cuda/riccati_fused``) for
    CUDA tensors when ``riccati_fused.covered`` holds and no input needs a
    gradient (the kernel has no autograd rule, as the Pallas kernel has
    none); "cuda" must take it and raises where it cannot; "torch" runs
    the recursion below. ``parallel`` sends an unboxed solve to the
    associative scan (``ops/parallel_riccati.plqr_backward``) before the
    kernel is considered, as JAX does; a boxed solve ignores it."""
    T, B = C.shape[0], C.shape[1]
    nx, nu = n_state, n_ctrl
    boxed = u_lower is not None
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if parallel and not boxed:
        # the associative-scan Riccati (ops/parallel_riccati.py): O(log T)
        # depth, exact for the unconstrained recursion and for u_zero_I;
        # box-constrained solves keep the recursion below
        K, k = plqr_backward(nx, nu, C, c, F, f, u_zero_I)
        return RiccatiResult(K, k, 0)
    if backend != "torch" and _use_kernel(backend, nx, nu, C, c, F, f, u, u_lower, u_upper,
                                          u_zero_I, qp_solver):
        K, k = fused.riccati_fused(nx, C, c, F, u, u_lower=u_lower, u_upper=u_upper,
                                   u_zero_I=u_zero_I, delta_u=delta_u)
        return RiccatiResult(K, k, T if boxed else 0)

    if boxed:
        lb_all = expand_bound(u_lower, T, B, nu, C) - u
        ub_all = expand_bound(u_upper, T, B, nu, C) - u
        if delta_u is not None:
            lb_all = clamp(lb_all, -delta_u, None)
            ub_all = clamp(ub_all, None, delta_u)

    V = torch.zeros(B, nx, nx, dtype=C.dtype, device=C.device)
    v = torch.zeros(B, nx, dtype=C.dtype, device=C.device)
    prev_k = None
    qp_iters = 0
    Ks, ks = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        Ct, ct = C[t], c[t]
        if t == T - 1:
            # V_T = 0: the zero F slab at t = T-1 is inert (Q = C)
            Qt, qt = Ct, ct
        else:
            Ft = F[t]
            FtT = btr(Ft)
            Qt = Ct + bmm(FtT, bmm(V, Ft))
            qt = ct + bmv(FtT, v)
            if f is not None:
                qt = qt + bmv(FtT, bmv(V, f[t]))

        Qxx = Qt[:, :nx, :nx]
        Qxu = Qt[:, :nx, nx:]
        Qux = Qt[:, nx:, :nx]
        Quu = Qt[:, nx:, nx:]
        qx = qt[:, :nx]
        qu = qt[:, nx:]

        if not boxed:
            if u_zero_I is None:
                Kt, kt = _unconstrained_gains(nu, Quu, Qux, qu)
            else:
                Kt, kt = _zero_constrained_gains(
                    nu, Quu, Qux, qu, u_zero_I[t].to(C.dtype))
        else:
            lb, ub = lb_all[t], ub_all[t]
            if nu == 1 and qp_solver == "auto":
                # exact minimizer of the 1-D box-QP; pnqp converges to it
                H = Quu[..., 0]
                kt = clamp(-qu / H, lb, ub)
                g = H * kt + qu
                Ic = ((kt <= lb) & (g > 0.0)) | ((kt >= ub) & (g < 0.0))
                If = 1.0 - Ic.to(Quu.dtype)
                H_free = Quu * bger(If, If) + 1e-11
                qp_iters += 1
                Kt = -(Qux * If[..., None]) / H_free
            else:
                if prev_k is None:
                    # t = T-1: pnqp's default -H^{-1} q init
                    if nu == 1:
                        default_init = -qu / Quu[..., 0]
                    else:
                        default_init = -solve_psd(Quu, qu[..., None])[..., 0]
                    x_init = clamp(default_init, lb, ub)
                else:
                    x_init = prev_k
                res = pnqp(Quu, qu, lb, ub, x_init=x_init, n_iter=pnqp_iter)
                kt = res.x
                qp_iters += 1 + res.n_iter
                Qux_ = Qux * res.If[..., None]
                if nu == 1:
                    Kt = -Qux_ / res.H_free
                else:
                    Kt = -solve_psd(res.H_free, Qux_)
            prev_k = kt

        KtT = btr(Kt)
        V = Qxx + bmm(Qxu, Kt) + bmm(KtT, Qux) + bmm(KtT, bmm(Quu, Kt))
        v = qx + bmv(Qxu, kt) + bmv(KtT, qu) + bmv(KtT, bmv(Quu, kt))
        Ks[t], ks[t] = Kt, kt
    return RiccatiResult(torch.stack(Ks), torch.stack(ks), qp_iters)
