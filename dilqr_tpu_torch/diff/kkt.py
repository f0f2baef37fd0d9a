"""Module-KKT differentiation of an LQR solve (counterpart of
``dilqr_tpu/diff/kkt.py``).

Given a loss cotangent r = (g_x, g_u) on the converged trajectory tau of
the last LQR subproblem, one auxiliary LQR solve with cost (C, -r) and
dynamics F (the frozen box active set as zero-control constraints) gives
the KKT sensitivities, from which the cotangents are assembled:

    dC = -1/2 (dtau tau^T + tau dtau^T)         dc = -dtau
    lam / dlam reverse adjoint recursions
    dF_t = -(dlam_{t+1} tau_t^T + lam_{t+1} dtau_t^T)
    df = -dlam_{1:}                             dx_init = -dlam_0

The auxiliary solve is the alpha=1 Riccati rollout, the exact minimizer of
the convex subproblem and linear in r, which the IFT backward needs.
All arrays are time-major [T, B, ...].
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.cuda import kkt_fused
from ..ops.parallel_riccati import _associative_scan, plqr_solve
from ..ops.riccati import lqr_backward
from ..utils.batch import bger, bmm, bmv, btr


class KKTGrads(NamedTuple):
    dx_init: Optional[torch.Tensor]  # [B, nx]
    dC: Optional[torch.Tensor]  # [T, B, n, n]
    dc: Optional[torch.Tensor]  # [T, B, n]
    dF: torch.Tensor  # [T-1, B, nx, n]
    df: torch.Tensor  # [T-1, B, nx]


def lqr_solve_linear(n_state: int, n_ctrl: int, C, F, r,
                     u_zero_I: Optional[torch.Tensor] = None, backend: str = "auto",
                     parallel: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the auxiliary LQR: argmin sum 0.5 dtau^T C dtau - r^T dtau
    s.t. dx_{t+1} = F_t dtau_t, dx_0 = 0, du = 0 on u_zero_I. Linear in r.
    Returns (dx [T,B,nx], du [T,B,nu]). ``backend`` goes to lqr_backward,
    whose Riccati kernel takes the free and u_zero_I modes; ``parallel``
    solves by associative scans instead (ops/parallel_riccati.plqr_solve),
    the gains and the rollout both of O(log T) depth."""
    T, B = C.shape[0], C.shape[1]
    if parallel:
        res = plqr_solve(n_state, n_ctrl, C, -r, F, None,
                         torch.zeros(B, n_state, dtype=C.dtype, device=C.device), u_zero_I)
        du = res.u if u_zero_I is None else torch.where(u_zero_I, torch.zeros_like(res.u),
                                                        res.u)
        return res.x, du
    ric = lqr_backward(n_state, n_ctrl, C, -r, F, None,
                       u=torch.zeros(T, B, n_ctrl, dtype=C.dtype, device=C.device),
                       u_zero_I=u_zero_I, backend=backend)
    dx_t = torch.zeros(B, n_state, dtype=C.dtype, device=C.device)
    dxs, dus = [], []
    for t in range(T):
        du_t = bmv(ric.K[t], dx_t) + ric.k[t]
        if u_zero_I is not None:
            du_t = torch.where(u_zero_I[t], torch.zeros_like(du_t), du_t)
        dxs.append(dx_t)
        dus.append(du_t)
        if t < T - 1:
            dx_t = bmv(F[t], torch.cat([dx_t, du_t], -1))
    return torch.stack(dxs), torch.stack(dus)


def _adjoint_scan(n_state: int, C, F, x, u, cvec, parallel: bool = False):
    """Reverse recursion lam_t = C_xx x_t + C_xu u_t + cvec_t[:nx]
    + F_x_t^T lam_{t+1}.

    parallel: the recursion as an affine-map suffix product
    lam_t = (f_t o f_{t+1} o ... o f_{T-1})(0) with f_t(y) = M_t y + b_t,
    M_t = F_x_t^T (zero at t = T-1), an associative scan of O(log T)
    depth."""
    nx = n_state
    T = C.shape[0]
    if parallel:
        Fx = btr(F[..., :nx])
        M = torch.cat([Fx, torch.zeros_like(Fx[:1])], 0)
        b = bmv(C[..., :nx, :nx], x) + bmv(C[..., :nx, nx:], u) + cvec[..., :nx]

        def comb(e1, e2):
            # e1 earlier in time, e2 the accumulated future segment
            (M1, b1), (M2, b2) = e1, e2
            return bmm(M1, M2), bmv(M1, b2) + b1

        return _associative_scan(lambda a, b_: comb(b_, a), (M, b), reverse=True)[1]
    lams = [None] * T
    lam = None
    for t in range(T - 1, -1, -1):
        Ct = C[t]
        lam_t = bmv(Ct[:, :nx, :nx], x[t]) + bmv(Ct[:, :nx, nx:], u[t]) + cvec[t][:, :nx]
        if lam is not None:  # at t = T-1 the F term vanishes
            lam_t = lam_t + bmv(btr(F[t][:, :, :nx]), lam)
        lams[t] = lam = lam_t
    return torch.stack(lams)


def use_kernel(T: int, n_state: int, n_ctrl: int, like: torch.Tensor, backend: str = "auto",
               parallel: bool = False) -> bool:
    """make_kkt_vjp's dispatch (see there): True when the KKT VJP of this
    shape on ``like``'s device and dtype is the CUDA kernel. "cuda" raises
    where it cannot take it."""
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"backward backend must be 'auto', 'cuda' or 'torch', got {backend!r}")
    if backend == "torch" or parallel:
        return False
    ok = kkt_fused.covered(T, n_state, n_ctrl, like.dtype)
    if backend == "cuda":
        if not like.is_cuda:
            raise ValueError("backward_backend='cuda' needs CUDA tensors; CPU tensors "
                             "take 'auto' or 'torch'")
        if not ok:
            raise ValueError("backward_backend='cuda': this shape is not covered by "
                             "the CUDA kernel (see ops/cuda/kkt_fused.covered)")
    return ok and like.is_cuda


def make_kkt_vjp(n_state: int, n_ctrl: int, C, c, F, x, u,
                 u_zero_I: Optional[torch.Tensor] = None, with_f: bool = True,
                 backend: str = "auto", parallel: bool = False):
    """Factory for the module-KKT VJP at a fixed solution point: returns
    ``vjp(g_x, g_u, wants="full"|"Ff") -> KKTGrads``, linear in the
    cotangents. "Ff" (what each IFT GMRES iteration consumes) skips dC, dc
    and dx_init.

    Dispatch on ``backend`` (``cfg.backward_backend or cfg.backend``):
      * "auto": the CUDA kernel (ops/cuda/kkt_fused.py, one launch a call,
        the dF/df/dC assembly in it) for CUDA f32 tensors in a covered
        shape -- the shapes JAX's kernel gate admits -- the plain scans
        below otherwise;
      * "cuda": the kernel; raises for CPU tensors or an uncovered shape;
      * "torch": the plain scans.
    The plain scans' auxiliary Riccati gets the same backend, so an
    uncovered shape's "auto" still takes the CUDA Riccati kernel there.
    ``parallel`` (cfg.riccati_parallel) takes precedence over the kernel,
    as in JAX: the auxiliary solve and both adjoint recursions run as
    associative scans of O(log T) depth, whatever the backend."""
    if use_kernel(C.shape[0], n_state, n_ctrl, C, backend, parallel):
        call = kkt_fused.make_kkt_vjp_cuda(n_state, n_ctrl, C, c, F, x, u, u_zero_I)

        def vjp_fused(g_x, g_u, wants: str = "full") -> KKTGrads:
            dxi, dC, dc, dF, df = call(g_x, g_u, wants == "full")
            return KKTGrads(dxi, dC, dc, dF, df if with_f else torch.zeros_like(df))

        return vjp_fused

    tau = torch.cat([x, u], -1)
    lams = _adjoint_scan(n_state, C, F, x, u, c, parallel)  # invariant in the cotangent

    def vjp_plain(g_x, g_u, wants: str = "full") -> KKTGrads:
        r = torch.cat([g_x, g_u], -1)
        dx, du = lqr_solve_linear(n_state, n_ctrl, C, F, r, u_zero_I, backend=backend,
                                  parallel=parallel)
        dtau = torch.cat([dx, du], -1)
        if wants == "full":
            dC = -0.5 * (bger(dtau, tau) + bger(tau, dtau))
            dc = -dtau
        else:
            dC = dc = None
        dlams = _adjoint_scan(n_state, C, F, dx, du, -r, parallel)
        dF = -(bger(dlams[1:], tau[:-1]) + bger(lams[1:], dtau[:-1]))
        df = -dlams[1:] if with_f else torch.zeros_like(dlams[1:])
        return KKTGrads(-dlams[0] if wants == "full" else None, dC, dc, dF, df)

    return vjp_plain


def kkt_vjp(n_state: int, n_ctrl: int, C, c, F, x, u, g_x, g_u,
            u_zero_I: Optional[torch.Tensor] = None, with_f: bool = True,
            backend: str = "auto", parallel: bool = False) -> KKTGrads:
    """Full module-KKT VJP, one-shot wrapper over make_kkt_vjp."""
    return make_kkt_vjp(n_state, n_ctrl, C, c, F, x, u, u_zero_I=u_zero_I, with_f=with_f,
                        backend=backend, parallel=parallel)(g_x, g_u)
