"""Differentiation-mode dispatch (counterpart of ``dilqr_tpu/diff/modes.py``).

This slice ports the forward solve only: the branch with no backward.
With ``backprop=False`` the outputs are detached. With ``backprop=True``
every ``backward_mode`` raises NotImplementedError -- the KKT/IFT backward
(``diff/kkt.py``, ``diff/ift.py``, ``ops/gmres.py`` and the ``kkt_fused``
kernels) is the next slice (ROADMAP.md, queue A item 5), and an ungraded
result must not pass for a graded one.
"""
from __future__ import annotations

from ..core.ilqr import ilqr_loop
from ..types import ILQRConfig


def solve_with_grad(cfg: ILQRConfig, cost, dyn, params, x_init, u_init, lb, ub,
                    uz, delta_u, cost_small=None, u_init_zero: bool = False):
    """Returns time-major (x, u, costs, full_du_norm, n_iter)."""
    if cfg.backprop:
        raise NotImplementedError(
            f"backprop=True (backward_mode={cfg.backward_mode.name}): the "
            "port has no backward yet -- the IFT/KKT slice is next in "
            "ROADMAP.md (queue A item 5). Pass backprop=False for the "
            "forward solve."
        )
    out = ilqr_loop(cfg, cost, dyn, params, x_init, u_init, u_lower=lb,
                    u_upper=ub, u_zero_I=uz, delta_u=delta_u,
                    cost_small=cost_small, u_init_zero=u_init_zero)
    return (out.x.detach(), out.u.detach(), out.costs, out.full_du_norm,
            out.n_iter)
