"""DiLQR fixed-point implicit differentiation, matrix-free (counterpart of
``dilqr_tpu/diff/ift.py``).

With tau* = S(C, c, F, f, x_init) the LQR-subproblem solution map and
(F, f) = L(tau*, theta) the linearization, the loss gradient is

    v^T d tau*/d p = w^T S_p,   where  w = v + L_tau^T S_{F,f}^T w .

One application of S^T is the module-KKT VJP (diff/kkt.py, linear in w);
one application of L_tau^T is a VJP of the linearization. GMRES on w costs
a few O(T) recursions; the dense form probes the per-example matrix with
D = T (n_state + n_ctrl) basis vectors and solves it directly.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..ops.gmres import gmres_batched


def solve_adjoint_fixed_point(sT_Ff: Callable, lT_xu: Callable,
                              v: Tuple[torch.Tensor, torch.Tensor], tol: float = 1e-6,
                              restart: int = 20, maxiter: int = 3):
    """Solve (I - L_tau^T S_{F,f}^T) w = v for the adjoint w, per example.

    sT_Ff((wx, wu)) -> (dF, df); lT_xu(dF, df) -> (dX, dU); v = (g_x, g_u),
    each [T, B, ...]. Returns (w, res_b, b_norm_b), res_b and b_norm_b [B]."""

    def A(w):
        dF, df = sT_Ff(w)
        dX, dU = lT_xu(dF, df)
        return (w[0] - dX, w[1] - dU)

    return gmres_batched(A, v, x0=v, tol=tol, restart=restart, maxiter=maxiter,
                         batch_axis=1)


def solve_adjoint_dense(sT_Ff: Callable, lT_xu: Callable,
                        v: Tuple[torch.Tensor, torch.Tensor]):
    """Dense solve: materialize each example's adjoint fixed-point matrix
    by probing with the D = T (n_state + n_ctrl) basis vectors (one KKT
    VJP and one linearization VJP each) and solve it directly."""
    gx, gu = v
    T, B, nx = gx.shape
    nu = gu.shape[-1]
    n = nx + nu
    D = T * n
    cols = []
    for j in range(D):
        e = torch.zeros(T, 1, n, dtype=gx.dtype, device=gx.device)
        e.view(-1)[j] = 1.0
        wx = e[:, :, :nx].expand(T, B, nx)
        wu = e[:, :, nx:].expand(T, B, nu)
        dF, df = sT_Ff((wx, wu))
        dX, dU = lT_xu(dF, df)
        out = torch.cat([wx - dX, wu - dU], -1)  # [T, B, n]
        cols.append(out.transpose(0, 1).reshape(B, D))
    A_mat = torch.stack(cols, -1)  # [B, row, col]
    rhs = torch.cat([gx, gu], -1).transpose(0, 1).reshape(B, D)
    w = torch.linalg.solve(A_mat, rhs[..., None])[..., 0]
    w = w.reshape(B, T, n).transpose(0, 1)
    return w[..., :nx], w[..., nx:]
