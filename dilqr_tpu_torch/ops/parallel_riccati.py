"""Parallel (associative-scan) Riccati recursion for the unconstrained LQR
subproblem, O(log T) depth instead of the sequential recursion's O(T)
(counterpart of ``dilqr_tpu/ops/parallel_riccati.py``).

Eliminating the control and its cross and linear cost terms per step
(u = u- - Cuu^{-1}(Cxu^T x + c_u)) leaves

    dynamics  x' = A x + B u- + d
    cost      1/2 x^T Q x + q^T x + 1/2 u-^T R u-

with A = F_x - F_u R^{-1} C_xu^T, d = f - F_u R^{-1} c_u,
Q = C_xx - C_xu R^{-1} C_xu^T, q = c_x - C_xu R^{-1} c_u, R = C_uu.
Every step is then an element e = (A, S = B R^{-1} B^T, Q, d, l = q) of a
family of maps closed under composition, with the stable combine
(e1 earlier in time, e2 the accumulated future; E = (I + S1 Q2)^{-1}):

    A12 = A2 E A1
    S12 = S2 + A2 E S1 A2^T
    Q12 = Q1 + A1^T Q2 E A1
    d12 = A2 E (d1 - S1 l2) + d2
    l12 = l1 + A1^T E^T (Q2 d1 + l2)

The t = T-1 element (no dynamics) has A = S = d = 0. The cost-to-go at t
is the combined suffix element applied to (P, p) = (0, 0):
V_t = Q_[t..T-1], v_t = l_[t..T-1]; the gains follow per step from
(V_{t+1}, v_{t+1}) as in the sequential recursion (ops/riccati.py), and
the closed-loop rollout is an affine-map prefix scan.

Each level of the scan is one batched operation over [T', B, n, n]
stacks. The combine solves its (I + S1 Q2) system in closed form for
n <= 3 and with one batched ``torch.linalg.solve`` otherwise, at every
dtype and on every device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.batch import bmm, bmv, btr, inv_small, solve_psd


class PLQRResult(NamedTuple):
    K: torch.Tensor  # [T, B, nu, nx]
    k: torch.Tensor  # [T, B, nu]
    x: torch.Tensor  # [T, B, nx]
    u: torch.Tensor  # [T, B, nu]


def _interleave(even: Sequence[torch.Tensor], odd: Sequence[torch.Tensor]):
    """[e0, o0, e1, o1, ...] along dim 0; len(even) is len(odd) or one more."""
    out = []
    for e, o in zip(even, odd):
        m = o.shape[0]
        pairs = torch.stack([e[:m], o], 1).reshape(2 * m, *o.shape[1:])
        out.append(torch.cat([pairs, e[m:]], 0) if e.shape[0] > m else pairs)
    return out


def _associative_scan(fn: Callable, elems: Tuple[torch.Tensor, ...], reverse: bool = False):
    """Inclusive scan of the associative ``fn(a, b)`` over dim 0 of a tuple
    of tensors: [a, fn(a, b), fn(fn(a, b), c), ...]; with reverse, the
    inputs are flipped before and the outputs after. The odd-even
    recursion of ``lax.associative_scan`` (jax/_src/lax/control_flow/
    loops.py), so the tree of combines is JAX's: combine adjacent pairs,
    recurse on the half, combine the odd results with the even elements
    from index 2, put element 0 first, interleave."""
    elems = tuple(elems)
    if reverse:
        elems = tuple(torch.flip(e, (0,)) for e in elems)

    def scan(es):
        n = es[0].shape[0]
        if n < 2:
            return es
        odd = scan(tuple(fn(tuple(e[0:-1:2] for e in es), tuple(e[1::2] for e in es))))
        head = tuple(o[:-1] for o in odd) if n % 2 == 0 else odd
        even = fn(head, tuple(e[2::2] for e in es))
        even = tuple(torch.cat([e[:1], r], 0) for e, r in zip(es, even))
        return tuple(_interleave(even, odd))

    out = scan(elems)
    if reverse:
        out = tuple(torch.flip(e, (0,)) for e in out)
    return out


def _pad_dynamics(T, B, nx, nu, F, f, like):
    """Zero-slab padding of (F, f) at t = T-1 (the terminal step has no
    dynamics; zero A, S and d make its element inert)."""
    kw = dict(dtype=like.dtype, device=like.device)
    Fz = torch.zeros(1, B, nx, nx + nu, **kw)
    F_pad = Fz if F is None else torch.cat([F, Fz], 0)
    f_pad = (torch.zeros(T, B, nx, **kw) if f is None
             else torch.cat([f, torch.zeros(1, B, nx, **kw)], 0))
    return F_pad, f_pad


def _masked_H(Cuu, free):
    """Free-subspace Hessian: frozen rows and columns zeroed, a unit frozen
    diagonal. Masked right-hand sides have zero frozen rows, so the solve
    returns the free-block solution with zeros on the frozen coordinates."""
    eyeu = torch.eye(Cuu.shape[-1], dtype=Cuu.dtype, device=Cuu.device)
    fo = free[..., :, None] * free[..., None, :]
    return Cuu * fo + eyeu * (1.0 - free)[..., None, :]


def _eliminated_steps(n_state, n_ctrl, C, c, F, f, u_zero_I=None):
    """Per-step eliminated elements (A, S, Q, d, l) [T,B,...]; the t = T-1
    element has A = 0, S = 0, d = 0.

    u_zero_I [T,B,nu] (True = frozen): zero-control equality constraints;
    the control elimination runs on the free subspace (masked Hessian and
    right-hand sides), and the combine, on the state space only, is
    unchanged."""
    T, B = C.shape[0], C.shape[1]
    nx, nu = n_state, n_ctrl
    Cxx, Cxu, Cuu = C[..., :nx, :nx], C[..., :nx, nx:], C[..., nx:, nx:]
    cx, cu = c[..., :nx], c[..., nx:]

    if u_zero_I is None:
        H, CxuT, cu_m = Cuu, btr(Cxu), cu
    else:
        free = 1.0 - u_zero_I.to(C.dtype)
        H = _masked_H(Cuu, free)
        CxuT = free[..., :, None] * btr(Cxu)
        cu_m = free * cu

    RiCxuT = solve_psd(H, CxuT)  # R^{-1} Cxu^T [T,B,nu,nx]
    Ricu = solve_psd(H, cu_m)  # R^{-1} c_u [T,B,nu]
    Q = Cxx - bmm(Cxu, RiCxuT)
    l = cx - bmv(Cxu, Ricu)

    F_pad, f_pad = _pad_dynamics(T, B, nx, nu, F, f, C)
    Fx, Fu = F_pad[..., :nx], F_pad[..., nx:]
    A = Fx - bmm(Fu, RiCxuT)
    d = f_pad - bmv(Fu, Ricu)
    FuT = btr(Fu) if u_zero_I is None else free[..., :, None] * btr(Fu)
    S = bmm(Fu, solve_psd(H, FuT))
    return A, S, Q, d, l


def _combine(e1, e2):
    """e1 earlier in time, e2 the accumulated future segment. Needs
    (I + S1 Q2) invertible, mildly stronger than the sequential
    recursion's Quu > 0. n <= 3 uses the closed-form inverse, reused for
    all four applications; larger n one batched LU solve with 2n+1
    right-hand sides plus the transposed solve."""
    A1, S1, Q1, d1, l1 = e1
    A2, S2, Q2, d2, l2 = e2
    n = A1.shape[-1]
    eye = torch.eye(n, dtype=A1.dtype, device=A1.device)
    M = eye + bmm(S1, Q2)  # E = M^{-1}
    z = bmv(Q2, d1) + l2
    dSl = d1 - bmv(S1, l2)
    if n <= 3:
        Minv = inv_small(M)
        E_A1, E_S1 = bmm(Minv, A1), bmm(Minv, S1)
        E_dSl = bmv(Minv, dSl)
        ETz = bmv(btr(Minv), z)
    else:
        sol = torch.linalg.solve(M, torch.cat([A1, S1, dSl[..., None]], -1))
        E_A1, E_S1, E_dSl = sol[..., :n], sol[..., n:2 * n], sol[..., -1]
        ETz = torch.linalg.solve(btr(M), z[..., None])[..., 0]
    A12 = bmm(A2, E_A1)
    S12 = S2 + bmm(A2, bmm(E_S1, btr(A2)))
    Q12 = Q1 + bmm(btr(A1), bmm(Q2, E_A1))
    d12 = bmv(A2, E_dSl) + d2
    l12 = l1 + bmv(btr(A1), ETz)
    return A12, S12, Q12, d12, l12


def plqr_backward(n_state: int, n_ctrl: int, C: torch.Tensor, c: torch.Tensor,
                  F: Optional[torch.Tensor], f: Optional[torch.Tensor],
                  u_zero_I: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LQR gains by associative scan, unconstrained or with the u_zero_I
    zero-control constraints (frozen coordinates get zero gain rows).
    C [T,B,n,n], c [T,B,n], F [T-1,B,nx,n] and f [T-1,B,nx] or None.
    Returns (K [T,B,nu,nx], k [T,B,nu]) as ops/riccati.lqr_backward."""
    T, B = C.shape[0], C.shape[1]
    nx, nu = n_state, n_ctrl
    elems = _eliminated_steps(nx, nu, C, c, F, f, u_zero_I)
    # reverse hands the combine (later, earlier); _combine takes
    # (earlier, accumulated future)
    combined = _associative_scan(lambda a, b: _combine(b, a), elems, reverse=True)
    V, v = combined[2], combined[4]
    V_next = torch.cat([V[1:], torch.zeros_like(V[:1])], 0)
    v_next = torch.cat([v[1:], torch.zeros_like(v[:1])], 0)

    # per-step gains from (V_{t+1}, v_{t+1}) and the original step data
    F_pad, f_pad = _pad_dynamics(T, B, nx, nu, F, f, C)
    FT = btr(F_pad)
    Qt = C + bmm(FT, bmm(V_next, F_pad))
    qt = c + bmv(FT, bmv(V_next, f_pad) + v_next)
    Quu, Qux, qu = Qt[..., nx:, nx:], Qt[..., nx:, :nx], qt[..., nx:]
    if u_zero_I is not None:
        free = 1.0 - u_zero_I.to(C.dtype)
        Quu = _masked_H(Quu, free)
        Qux = free[..., :, None] * Qux
        qu = free * qu
    sol = solve_psd(Quu, torch.cat([Qux, qu[..., None]], -1))
    return -sol[..., :-1], -sol[..., -1]


def plqr_rollout(n_state: int, x_init: torch.Tensor, K: torch.Tensor, k: torch.Tensor,
                 F: Optional[torch.Tensor], f: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-loop trajectory by an affine-map prefix product.
    Returns (x [T,B,nx], u [T,B,nu])."""
    T, B, nu = K.shape[0], K.shape[1], K.shape[2]
    nx = n_state
    F_pad, f_pad = _pad_dynamics(T, B, nx, nu, F, f, x_init)
    Fx, Fu = F_pad[..., :nx], F_pad[..., nx:]
    # x_{t+1} = G_t x_t + g_t with G = Fx + Fu K, g = Fu k + f
    G = Fx + bmm(Fu, K)
    g = bmv(Fu, k) + f_pad

    def comb(a, b):
        # (later b) o (earlier a): x -> Gb (Ga x + ga) + gb
        (Ga, ga), (Gb, gb) = a, b
        return bmm(Gb, Ga), bmv(Gb, ga) + gb

    Gp, gp = _associative_scan(comb, (G, g))
    xh = torch.einsum("tbij,bj->tbi", Gp, x_init) + gp
    x = torch.cat([x_init[None], xh[:-1]], 0)
    u = torch.einsum("tbux,tbx->tbu", K, x) + k
    return x, u


def plqr_solve(n_state: int, n_ctrl: int, C: torch.Tensor, c: torch.Tensor,
               F: Optional[torch.Tensor], f: Optional[torch.Tensor], x_init: torch.Tensor,
               u_zero_I: Optional[torch.Tensor] = None) -> PLQRResult:
    """The whole LQR solve (gains and closed-loop rollout), both as
    associative scans. With u_zero_I, frozen coordinates have zero gain
    rows, so the rollout keeps them at zero."""
    K, k = plqr_backward(n_state, n_ctrl, C, c, F, f, u_zero_I)
    x, u = plqr_rollout(n_state, x_init, K, k, F, f)
    return PLQRResult(K, k, x, u)
