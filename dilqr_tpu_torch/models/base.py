"""Dynamics model interface (counterpart of ``dilqr_tpu/models/base.py``).

A model is a frozen bundle of plain functions plus a separate params
tensor. Every function broadcasts over leading batch dims:

    step(x [..., nx], u [..., nu], params [P]) -> x' [..., nx]
    step_unclamped                    the un-clamped physics the ANALYTIC
                                      linearization differentiates
    jacobian(x, u, params) -> (R, S)  optional hand-written Jacobian that
                                      replaces jacfwd on the plain path
    jac_lanes(x, u, params) -> D      hand-derived D = [dx'/dx | dx'/du]
                                      [..., nx, nx+nu] of step_unclamped in
                                      its kernel form (the name is the JAX
                                      package's; the batch leads here)
    kernel_step                       the clamped step in its kernel form
                                      (rotate_cs angle addition)
    device_env                        id of the env's device code in
                                      csrc/ilqr_fused.cuh; None = the env
                                      has none and never reaches the kernel
    device_mlp                        the shape of the learned model's
                                      device code (MlpSpec, Mlp<...> in
                                      csrc/ilqr_fused.cuh), beside its
                                      device_env; None for the other envs
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


class MlpSpec(NamedTuple):
    """The widths of an MLP with device code (nn_dynamics.make with
    hidden_sizes): layers n_state + n_ctrl -> hidden... -> n_state, the
    activation's name, the residual x' = MLP(x, u) + x (the reference's
    ``passthrough``), and whether the model is its slew-rate wrapper."""
    n_state: int
    n_ctrl: int
    hidden: Tuple[int, ...]
    activation: str
    residual: bool
    slew: bool = False

    @property
    def n_weights(self) -> int:
        sizes = (self.n_state + self.n_ctrl,) + self.hidden + (self.n_state,)
        return sum((a + 1) * b for a, b in zip(sizes[:-1], sizes[1:]))


@dataclasses.dataclass(frozen=True)
class Dynamics:
    n_state: int
    n_ctrl: int
    step: Callable
    step_unclamped: Optional[Callable] = None
    jacobian: Optional[Callable] = None
    jac_lanes: Optional[Callable] = None
    kernel_step: Optional[Callable] = None
    device_env: Optional[int] = None
    device_mlp: Optional[MlpSpec] = None
    # box bounds on u (None = unconstrained); scalars or [nu] arrays
    lower: Any = None
    upper: Any = None
    # per-env MPC hyper-parameters
    mpc_eps: float = 1e-3
    linesearch_decay: float = 0.2
    max_linesearch_iter: int = 10
    # a slew-rate wrapper's base model (models/ctrl_passthrough), by which
    # the kernel's trace of the wrapper is cached (ops/cuda/traced.model)
    wraps: Optional["Dynamics"] = None

    @property
    def linearize_point(self) -> Callable:
        return self.step_unclamped if self.step_unclamped is not None else self.step


def unpack_params(params, like: torch.Tensor):
    """The params vector [P] as P scalars in ``like``'s dtype and device (a
    tuple/list of scalars passes through)."""
    if isinstance(params, (tuple, list)):
        return params
    return torch.as_tensor(params, dtype=like.dtype, device=like.device).unbind(-1)
