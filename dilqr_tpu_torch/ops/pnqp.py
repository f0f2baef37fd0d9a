"""Projected-Newton box-QP ``min_x 0.5 x^T H x + q^T x  s.t. l <= x <= u``
(counterpart of ``dilqr_tpu/ops/pnqp.py``), with the reference's
algorithm and constants:

 * active set Ic = (x==l & g>0) | (x==u & g<0)
 * H_free = H * (If x If) + 1e-11 I
 * per-example convergence ||dx|| < 1e-4; the loop ends when all converged
 * Armijo: GAMMA=0.1, decay 0.1, <= 10 trials, leaving as soon as
   max(armijo) > GAMMA over the batch (inactive examples carry
   GAMMA+1e-6) -- a reference quirk kept for trajectory parity.

The loops are plain Python loops with data-dependent exits; both exits
are decisions of the whole batch, over every rank of an open
``parallel.comm.batch_global``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..parallel.comm import decide
from ..utils.batch import bdot, bger, bmv, bquad, clamp, solve_psd

GAMMA = 0.1
REG = 1e-11
CONV_TOL = 1e-4
ARMIJO_DECAY = 0.1
MAX_ARMIJO_ITER = 10


class PnqpResult(NamedTuple):
    x: torch.Tensor  # [B, n] solution
    H_free: torch.Tensor  # [B, n, n] masked+regularized free Hessian
    If: torch.Tensor  # [B, n] float free-set mask (1 = free)
    n_iter: int  # last Newton iteration index (reference `i`)
    converged: bool  # all examples converged


def pnqp(
    H: torch.Tensor,
    q: torch.Tensor,
    lower,
    upper,
    x_init: Optional[torch.Tensor] = None,
    n_iter: int = 20,
) -> PnqpResult:
    """Batched box-QP solve. H: [B,n,n], q: [B,n], lower/upper: [B,n] or
    scalar."""
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    lo = torch.as_tensor(lower, dtype=H.dtype, device=H.device)
    hi = torch.as_tensor(upper, dtype=H.dtype, device=H.device)

    def obj(x):
        return 0.5 * bquad(x, H) + bdot(q, x)

    if x_init is None:
        x0 = -q / H[..., 0] if n == 1 else -solve_psd(H, q)
    else:
        x0 = x_init
    x = clamp(x0, lo, hi)

    def newton(x):
        g = bmv(H, x) + q
        Ic = ((x == lo) & (g > 0)) | ((x == hi) & (g < 0))
        If = 1.0 - Ic.to(H.dtype)
        g_free = torch.where(Ic, torch.zeros_like(g), g)
        H_free = H * bger(If, If) + REG * eye
        dx = -g_free / H_free[..., 0] if n == 1 else -solve_psd(H_free, g_free)
        return g, If, H_free, dx

    def armijo_search(x, g, dx, J):
        sentinel = torch.full_like(x[..., 0], GAMMA + 1e-6)
        alpha = torch.ones_like(x[..., 0])
        maybe_x = x
        ox = obj(x)
        for _ in range(MAX_ARMIJO_ITER):
            maybe_x = clamp(x + alpha[:, None] * dx, lo, hi)
            num = ox - obj(maybe_x)
            den = bdot(g, x - maybe_x)
            armijos = torch.where(J, num / den, sentinel)
            alpha = torch.where(armijos <= GAMMA, alpha * ARMIJO_DECAY, alpha)
            # NaN compares False, so a NaN max leaves like the reference
            if not decide(torch.max(armijos) <= GAMMA, "all"):
                break
        return maybe_x

    _, If, H_free, _ = newton(x)
    i, done = 0, False
    while not done and i < n_iter:
        g, If, H_free, dx = newton(x)
        J = torch.linalg.vector_norm(dx, dim=-1) >= CONV_TOL
        done = not decide(J.any())
        if not done:
            # the reference returns x un-updated on the convergence iteration
            x = armijo_search(x, g, dx, J)
        i += 1
    return PnqpResult(x, H_free, If, max(i - 1, 0), done)
