"""The plain reference of a box-constrained batched iLQR solve, in plain
PyTorch. It imports nothing of the program under test.

It is the algorithm of mpc.pytorch's iLQR as the port's whole-solve kernel
states it (a frozen, trimmed copy of its plain version's arithmetic):

 * an open-loop rollout of the warm start, then up to ``lqr_iter``
   iterations of: the Jacobian at the current iterate, a Riccati backward
   in delta space (the closed-form 1-D box-QP for one control, a projected
   Newton box-QP warm-started from the next step's k otherwise), and a
   backtracking line search on the nonlinear rollout;
 * per-example best-so-far tracking with ``best_cost_eps``;
 * the line search's any(cost worsened), the not-improved reset's
   any(improved), the stopping rule max(du) < eps and the box-QP's exits are
   decided per tile of ``tile`` examples. ``tile`` = 1024 is the program's
   tile; ``tile`` = 1 lets each example stop by its own rule, which is what
   the work model counts (``iters``, ``trials``).

Only what the benchmark's configurations use is here: an example-invariant
diagonal or dense cost (C [n, n], c [n]), static box bounds (a number or
[nu] each), a warm start or none, the model's hand-derived Jacobian.

``rnd`` is applied to what each step of the arithmetic produces (the
model's step and Jacobian, every product, the objective): the identity for
the reference, ``precision.tf32`` for the lower-precision control.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

GAMMA = 0.1  # the box-QP's Armijo constants (mpc.pytorch's pnqp)
REG = 1e-11
CONV_TOL = 1e-4
ARMIJO_DECAY = 0.1
MAX_ARMIJO_ITER = 10


class Solution(NamedTuple):
    x: torch.Tensor  # [T, B, nx]
    u: torch.Tensor  # [T, B, nu]
    costs: torch.Tensor  # [B]
    iters: torch.Tensor  # [B] iterations the example's tile ran
    trials: torch.Tensor  # [B] line-search rollouts the example's tile ran


def _same(t):
    return t


def clamp(x, lo, hi):
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def inv_small(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., m, m] for m <= 3 (reciprocal, Cramer,
    adjugate)."""
    m = A.shape[-1]
    if m == 1:
        return 1.0 / A
    if m == 2:
        det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
        r = (1.0 / det)[..., None, None]
        return torch.stack([torch.stack([A[..., 1, 1], -A[..., 0, 1]], -1),
                            torch.stack([-A[..., 1, 0], A[..., 0, 0]], -1)], -2) * r
    if m != 3:
        raise ValueError(f"inv_small takes 1 to 3 controls, got {m}")
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    r = 1.0 / (a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02)
    c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    return torch.stack([torch.stack([c00 * r, c10 * r, c20 * r], -1),
                        torch.stack([c01 * r, c11 * r, c21 * r], -1),
                        torch.stack([c02 * r, c12 * r, c22 * r], -1)], -2)


def objective(C, c, tau, rnd: Callable = _same):
    """0.5 tau^T C tau + c^T tau over [..., n], C [n, n] and c [n]."""
    Ctau = rnd(rnd(tau) @ rnd(C).T)
    return rnd(0.5 * (tau * Ctau).sum(-1) + (c * tau).sum(-1))


def _box_qp(H, q, lb, ub, x0, n_iter: int, tile: int, rnd: Callable):
    """Projected-Newton box-QP min 0.5 x^T H x + q^T x on [lb, ub] over
    [Bp, nu], with its Newton exit (no example of a tile with ||dx|| >=
    1e-4) and Armijo exit (every example's armijo > 0.1) decided per tile.
    Returns (x, If, H_free) of the last Newton step."""
    Bp, nu = q.shape
    G = Bp // tile
    eye = torch.eye(nu, dtype=H.dtype, device=H.device)

    def mv(A, x):
        return rnd((rnd(A) @ rnd(x)[..., None])[..., 0])

    def obj(x):
        return 0.5 * (x * mv(H, x)).sum(-1) + (q * x).sum(-1)

    def newton(x):
        g = mv(H, x) + q
        Ic = ((x <= lb) & (g > 0.0)) | ((x >= ub) & (g < 0.0))
        If = torch.where(Ic, 0.0, 1.0).to(H.dtype)
        Hf = H * If[:, :, None] * If[:, None, :] + REG * eye
        return g, If, Hf, -mv(inv_small(Hf), g * If)

    sentinel = torch.full((Bp,), GAMMA + 1e-6, dtype=H.dtype, device=H.device)
    x = clamp(x0, lb, ub)
    g, If, Hf, dx = newton(x)
    for i in range(n_iter):
        if i > 0:
            g, If, Hf, dx = newton(x)
        J = torch.sqrt((dx * dx).sum(-1)) >= CONV_TOL
        run = J.view(G, tile).any(1)
        if not bool(run.any()):
            break
        ox = obj(x)
        alpha = torch.ones(Bp, dtype=H.dtype, device=H.device)
        mx, cont = x, run
        for _ in range(MAX_ARMIJO_ITER):
            nmx = clamp(x + alpha[:, None] * dx, lb, ub)
            arm = torch.where(J, (ox - obj(nmx)) / (g * (x - nmx)).sum(-1), sentinel)
            cl = cont.repeat_interleave(tile)
            mx = torch.where(cl[:, None], nmx, mx)
            alpha = torch.where(cl & (arm <= GAMMA), alpha * ARMIJO_DECAY, alpha)
            cont = cont & (arm <= GAMMA).view(G, tile).all(1)
            if not bool(cont.any()):
                break
        x = torch.where(run.repeat_interleave(tile)[:, None], mx, x)
    return x, If, Hf


def _gains(Q, q, nx: int, ut, lo, hi, warm, pnqp_iter: int, tile: int, rnd: Callable):
    """One Riccati step's gains and V/v update from Q [Bp, n, n] and q [Bp, n]
    at the controls ut: the delta-space bounds lo - ut, hi - ut, then the
    closed-form 1-D box-QP (one control) or the box-QP (more). Returns (K,
    k, V, v)."""
    lb, ub = lo - ut, hi - ut
    Quu, qu, Qux = Q[:, nx:, nx:], q[:, nx:], Q[:, nx:, :nx]
    if ut.shape[1] == 1:
        H = Quu[:, :, 0]
        k = clamp(-qu / H, lb, ub)
        g = H * k + qu
        Ic = ((k <= lb) & (g > 0.0)) | ((k >= ub) & (g < 0.0))
        If = torch.where(Ic, 0.0, 1.0).to(Q.dtype)
        K = -((1.0 / (H * If + 1e-11))[:, :, None] * (Qux * If[:, :, None]))
    else:
        if warm is None:  # the clipped ridged Newton point
            eye = torch.eye(qu.shape[1], dtype=Q.dtype, device=Q.device)
            warm = clamp(-rnd((inv_small(Quu + REG * eye) @ qu[..., None])[..., 0]), lb, ub)
        k, If, Hf = _box_qp(Quu, qu, lb, ub, warm, pnqp_iter, tile, rnd)
        K = -rnd(rnd(inv_small(Hf)) @ rnd(Qux * If[:, :, None]))
    M = rnd(rnd(Q[:, :nx, nx:]) @ rnd(K))
    KT = K.transpose(-1, -2)
    V = Q[:, :nx, :nx] + M + M.transpose(-1, -2) + rnd(rnd(KT) @ rnd(rnd(Quu) @ rnd(K)))
    v = (q[:, :nx] + rnd((Q[:, :nx, nx:] @ k[..., None])[..., 0])
         + rnd((KT @ (qu + rnd((Quu @ k[..., None])[..., 0]))[..., None])[..., 0]))
    return K, k, rnd(V), rnd(v)


def solve(step: Callable, jac: Callable, params, x0: torch.Tensor, u0: Optional[torch.Tensor],
          C: torch.Tensor, c: torch.Tensor, lo, hi, *, nu: int, T: int, lqr_iter: int, eps: float,
          linesearch_decay: float, max_linesearch_iter: int, not_improved_lim: int = 5,
          best_cost_eps: float = 1e-4, pnqp_iter: int = 20, tile: int = 1024,
          rnd: Callable = _same) -> Solution:
    """Solve from x0 [B, nx] with the warm start u0 [T, B, nu] (None: zeros).
    ``step(x, u, params)`` and ``jac(x, u, params)`` ([B, nx, nx + nu]) are
    the model's; lo/hi a number or [nu]; nu the controls; B a multiple of ``tile``. All in
    x0's dtype and device. Returns time-major trajectories."""
    B, nx = x0.shape
    if B % tile:
        raise ValueError(f"the batch {B} is not a multiple of the tile {tile}")
    n, G = nx + nu, B // tile
    dt, dev = x0.dtype, x0.device
    lo_t = torch.as_tensor(lo, dtype=dt, device=dev).expand(nu)
    hi_t = torch.as_tensor(hi, dtype=dt, device=dev).expand(nu)

    def f(x, u):
        return rnd(step(x, u, params))

    def obj(x, u):
        return objective(C, c, torch.cat([x, u], -1), rnd)

    def lanes(m):
        return m.repeat_interleave(tile)

    def tiles(v):
        return v.view(G, tile)

    u = torch.zeros(T, B, nu, dtype=dt, device=dev) if u0 is None else u0.clone()
    xs, oc, xt = [], torch.zeros(B, dtype=dt, device=dev), x0
    for t in range(T):
        xs.append(xt)
        oc = rnd(oc + obj(xt, u[t]))
        if t < T - 1:
            xt = f(xt, u[t])
    x = torch.stack(xs)

    bx, bu = torch.zeros_like(x), torch.zeros_like(u)
    bc = torch.full((B,), float("inf"), dtype=dt, device=dev)
    stopped = torch.zeros(G, dtype=torch.bool, device=dev)
    nni = torch.zeros(G, dtype=torch.int64, device=dev)
    iters = torch.zeros(G, dtype=torch.int64, device=dev)
    trials = torch.zeros(G, dtype=torch.int64, device=dev)
    zF = torch.zeros(B, nx, n, dtype=dt, device=dev)

    for it in range(lqr_iter):
        run = ~stopped
        if not bool(run.any()):
            break
        run_l = lanes(run)
        V = torch.zeros(B, nx, nx, dtype=dt, device=dev)
        v = torch.zeros(B, nx, dtype=dt, device=dev)
        K, k = [None] * T, [None] * T
        for t in range(T - 1, -1, -1):
            tau = torch.cat([x[t], u[t]], -1)
            F = rnd(jac(x[t], u[t], params)) if t < T - 1 else zF
            FT = F.transpose(-1, -2)
            Q = rnd(C + rnd(rnd(FT) @ rnd(rnd(V.transpose(-1, -2)) @ rnd(F))))
            q = rnd(rnd(rnd(tau) @ rnd(C).T) + c + rnd((rnd(FT) @ rnd(v)[..., None])[..., 0]))
            K[t], k[t], V, v = _gains(Q, q, nx, u[t], lo_t, hi_t,
                                      k[t + 1] if t < T - 1 else None, pnqp_iter, tile, rnd)

        def trial(alpha):
            xt = x0
            cost_ = torch.zeros_like(alpha)
            du2 = torch.zeros_like(alpha)
            txs, tus = [], []
            for t in range(T):
                kdx = rnd((rnd(K[t]) @ rnd(xt - x[t])[..., None])[..., 0])
                new_u = clamp(kdx + u[t] + alpha[:, None] * k[t], lo_t, hi_t)
                d = u[t] - new_u
                du2 = du2 + (d * d).sum(-1)
                txs.append(xt)
                tus.append(new_u)
                cost_ = rnd(cost_ + obj(xt, new_u))
                if t < T - 1:
                    xt = f(xt, new_u)
            return cost_, du2, torch.stack(txs), torch.stack(tus)

        alpha = torch.ones(B, dtype=dt, device=dev)
        cc, du2s, tx, tu = oc.clone(), torch.zeros_like(oc), x, u
        for i in range(max_linesearch_iter):
            active = run if i == 0 else run & tiles(cc > oc).any(1)
            if bool(active.any()):
                cost_, du2, ntx, ntu = trial(alpha)
                a = lanes(active)
                cc = torch.where(a, cost_, cc)
                tx = torch.where(a[None, :, None], ntx, tx)
                tu = torch.where(a[None, :, None], ntu, tu)
                if i == 0:
                    du2s = torch.where(a, du2, du2s)
                trials = trials + active.to(torch.int64)
            alpha = torch.where(cc > oc, alpha * linesearch_decay, alpha)
        cur_du = torch.sqrt(du2s)

        improved = (cc <= bc + best_cost_eps) & run_l
        x = torch.where(run_l[None, :, None], tx, x)
        u = torch.where(run_l[None, :, None], tu, u)
        bx = torch.where(improved[None, :, None], tx, bx)
        bu = torch.where(improved[None, :, None], tu, bu)
        oc = torch.where(run_l, cc, oc)
        bc = torch.where(improved, cc, bc)

        imp_tile = tiles(improved).any(1)
        nni_new = torch.where(imp_tile & (it > 0), torch.zeros_like(nni), nni + 1)
        stop = (tiles(cur_du).amax(1) < eps) | (nni_new > not_improved_lim)
        nni = torch.where(run, nni_new, nni)
        stopped = stopped | (run & stop)
        iters = iters + run.to(torch.int64)

    return Solution(bx, bu, bc, lanes(iters), lanes(trials))
