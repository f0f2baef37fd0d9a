"""Control-passthrough wrapper for the slew-rate augmented state
(counterpart of ``dilqr_tpu/models/ctrl_passthrough.py``, reference
CtrlPassthroughDynamics, dynamics.py:133-156): the augmented state
x_tilde = (u_{t-1}, x) steps as x_tilde' = (u_t, f(x, u_t)). Used by
``core/solver.augment_slew_rate``. The wrapper of a model with device code
(cartpole, both pendulums, the rocket with normalize_quat off and on, the
MLP with hidden_sizes) has device code too, ``Passthrough<Env>`` in
``csrc/ilqr_fused.cuh``, so its solves run the whole-solve kernel (its
Jacobian from the base's: the hand one, or the jvp sweep's where the base
has none); the wrapper of a user's own model is one too, whose wrapped
step the kernel traces as it stands (``ops/cuda/traced.py``), cached by
the base model the wrapper names (``wraps``)."""
from __future__ import annotations

import torch

from .base import Dynamics

# the base model's device_env -> Passthrough<Env>'s (EnvId in
# csrc/ilqr_fused.cuh; 10 -> 11 the MLP's)
DEVICE_ENVS = {0: 3, 1: 4, 2: 5, 6: 8, 7: 9, 10: 11}


def _aug(fn, nu: int):
    def stepped(x_aug, u, p):
        return torch.cat([u, fn(x_aug[..., nu:], u, p)], -1)

    return stepped


def _aug_jac(jac, nu: int):
    """The kernel-form Jacobian of the wrapped step over ((u_{t-1}, x), u):
    rows [0 | 0 | I] for u_{t-1}' = u, then [0 | D] with the base's D =
    [dx'/dx | dx'/du], [..., nu + nx, nu + nx + nu]."""

    def jac_aug(x_aug, u, p):
        D = jac(x_aug[..., nu:], u, p)
        lead = D.shape[:-2]
        nxb = D.shape[-2]
        eye = torch.eye(nu, dtype=D.dtype, device=D.device).expand(*lead, nu, nu)
        top = torch.cat([D.new_zeros(*lead, nu, nu + nxb), eye], -1)
        return torch.cat([top, torch.cat([D.new_zeros(*lead, nxb, nu), D], -1)], -2)

    return jac_aug


def make(base: Dynamics) -> Dynamics:
    """Wrap ``base`` for the augmented state (u_{t-1}, x)."""
    nu = base.n_ctrl
    device = base.device_env in DEVICE_ENVS and base.kernel_step is not None
    return Dynamics(
        n_state=nu + base.n_state,
        n_ctrl=nu,
        step=_aug(base.step, nu),
        step_unclamped=(_aug(base.linearize_point, nu)
                        if base.step_unclamped is not None else None),
        jac_lanes=(_aug_jac(base.jac_lanes, nu)
                   if device and base.jac_lanes is not None else None),
        kernel_step=_aug(base.kernel_step, nu) if device else None,
        device_env=DEVICE_ENVS[base.device_env] if device else None,
        device_mlp=(base.device_mlp._replace(slew=True)
                    if device and base.device_mlp is not None else None),
        lower=base.lower,
        upper=base.upper,
        mpc_eps=base.mpc_eps,
        linesearch_decay=base.linesearch_decay,
        max_linesearch_iter=base.max_linesearch_iter,
        wraps=base,
    )
