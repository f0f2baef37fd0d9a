"""Control-passthrough wrapper for the slew-rate augmented state
(counterpart of ``dilqr_tpu/models/ctrl_passthrough.py``, reference
CtrlPassthroughDynamics, dynamics.py:133-156): the augmented state
x_tilde = (u_{t-1}, x) steps as x_tilde' = (u_t, f(x, u_t)). Used by
``core/solver.augment_slew_rate``. The wrapped model has no device code, so
its solves run the plain loop."""
from __future__ import annotations

import torch

from .base import Dynamics


def make(base: Dynamics) -> Dynamics:
    """Wrap ``base`` for the augmented state (u_{t-1}, x)."""
    nu = base.n_ctrl

    def aug(fn):
        def stepped(x_aug, u, p):
            return torch.cat([u, fn(x_aug[..., nu:], u, p)], -1)

        return stepped

    return Dynamics(
        n_state=nu + base.n_state,
        n_ctrl=nu,
        step=aug(base.step),
        step_unclamped=(aug(base.linearize_point)
                        if base.step_unclamped is not None else None),
        lower=base.lower,
        upper=base.upper,
        mpc_eps=base.mpc_eps,
        linesearch_decay=base.linesearch_decay,
        max_linesearch_iter=base.max_linesearch_iter,
    )
