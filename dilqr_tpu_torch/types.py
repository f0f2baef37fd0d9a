"""Problem and result types of the PyTorch port.

Counterpart of ``dilqr_tpu/types.py``. Arrays are batch-major
``[B, T, ...]`` at the public API, exactly as in the JAX package, so the
two can be compared like with like; the solver works time-major
``[T, B, ...]`` inside.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional

import torch


class QuadCost(NamedTuple):
    """Quadratic cost ``sum_t 0.5 tau_t^T C_t tau_t + c_t^T tau_t``.

    C: [B, T, n_tau, n_tau] (or broadcastable: [n_tau, n_tau], [T, n_tau, n_tau])
    c: [B, T, n_tau]        (or broadcastable)

    C must be symmetric: the kernel forms only the symmetric products.
    """

    C: torch.Tensor
    c: torch.Tensor


class LinDx(NamedTuple):
    """Time-varying affine dynamics ``x_{t+1} = F_t tau_t + f_t``.

    F: [B, T-1, n_state, n_tau]
    f: [B, T-1, n_state] or None
    """

    F: torch.Tensor
    f: Optional[torch.Tensor] = None


class GradMethod(enum.Enum):
    """How to linearize non-linear dynamics.

    ANALYTIC differentiates the env's un-clamped step (forward mode,
    ``torch.func.jvp``, off the kernel; the env's hand-derived ``jac_lanes``
    inside it);
    AUTO_DIFF differentiates the clamped step; FINITE_DIFF takes central
    differences."""

    AUTO_DIFF = 1
    FINITE_DIFF = 2
    ANALYTIC = 3
    ANALYTIC_CHECK = 4


class BackwardMode(enum.Enum):
    """How gradients flow through the solver (diff/modes.py): KKT, the
    module-KKT VJP of the last LQR subproblem; IFT, implicit
    differentiation of the iLQR fixed point (GMRES on the adjoint); UNROLL,
    plain autograd through the plain loop (needs ``unroll=True``)."""

    KKT = 1
    IFT = 2
    UNROLL = 3


BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    """Static solver configuration: the same fields, defaults and check as
    ``dilqr_tpu.types.ILQRConfig``.

    ``backend`` selects where the forward solve runs:
      * ``"auto"`` (JAX ``"auto"``): the hand-written CUDA whole-solve kernel
        for CUDA tensors when the configuration is covered
        (``ops/cuda/ilqr_fused.covered``), the plain PyTorch loop on the
        tensors' own device otherwise;
      * ``"cuda"`` (JAX ``"pallas"``): force the kernel; raises for CPU
        tensors or an uncovered configuration instead of interpreting;
      * ``"torch"`` (JAX ``"xla"``): the plain PyTorch loop.
    ``backward_backend`` selects the KKT-VJP backend of the KKT and IFT
    backwards, with the same three values (``None``: follow ``backend``):
    the hand-written CUDA kernel (``ops/cuda/kkt_fused.covered``), forced,
    or the plain PyTorch recursions. ``riccati_parallel`` sends the plain
    loop's unboxed Riccati backward and the KKT backward's auxiliary solve
    and adjoint recursions to associative scans of O(log T) depth
    (``ops/parallel_riccati.py``), ahead of the Riccati and KKT kernels;
    the whole-solve kernel does not look at it, as JAX's gate does not.
    """

    n_state: int
    n_ctrl: int
    T: int
    lqr_iter: int = 10
    grad_method: GradMethod = GradMethod.ANALYTIC
    eps: float = 1e-7
    back_eps: Optional[float] = None
    linesearch_decay: float = 0.2
    max_linesearch_iter: int = 10
    exit_unconverged: bool = False
    detach_unconverged: bool = True
    backprop: bool = True
    not_improved_lim: int = 5
    best_cost_eps: float = 1e-4
    verbose: int = 0
    backward_mode: BackwardMode = BackwardMode.KKT
    pnqp_iter: int = 20
    qp_solver: str = "auto"
    backend: str = "auto"
    backward_backend: Optional[str] = None
    unroll: bool = False
    fd_eps: float = 1e-4
    slew_rate_penalty: Optional[float] = None
    ift_tol: Optional[float] = None
    ift_restart: int = 10
    ift_maxiter: int = 2
    ift_solver: str = "gmres"
    ift_fallback: bool = True
    kkt_grad_through_F: bool = True
    riccati_parallel: bool = False

    def __post_init__(self):
        if self.back_eps is not None and self.backward_mode is not BackwardMode.IFT:
            raise ValueError(
                "back_eps sets the iterative backward-solve tolerance and "
                "only BackwardMode.IFT has one (the GMRES adjoint); the "
                f"{self.backward_mode.name} backward is an exact direct "
                "solve. Drop back_eps or use backward_mode=BackwardMode.IFT."
            )
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}"
            )

    @property
    def backward_tol(self) -> float:
        if self.ift_tol is not None:
            return self.ift_tol
        if self.back_eps is not None:
            return self.back_eps
        return 1e-4

    @property
    def n_tau(self) -> int:
        return self.n_state + self.n_ctrl


class SolveResult(NamedTuple):
    """Output of a batched iLQR solve.

    x: [B, T, n_state]; u: [B, T, n_ctrl]; costs: [B] objective of the
    best-so-far trajectory; converged: [B] bool, full_du_norm < eps;
    full_du_norm: [B] alpha=1 step norm of the best iterate; n_iter: []
    int outer iterations executed.
    """

    x: torch.Tensor
    u: torch.Tensor
    costs: torch.Tensor
    converged: torch.Tensor
    full_du_norm: torch.Tensor
    n_iter: torch.Tensor
