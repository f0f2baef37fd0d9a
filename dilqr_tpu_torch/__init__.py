"""dilqr_tpu_torch -- the PyTorch/CUDA port of dilqr_tpu.

A second package beside the JAX one, with the same module layout. This
slice ports the forward solve: the batched box-constrained iLQR, the
cartpole and pendulum envs, the MPC wrapper and the closed-loop driver,
with the whole-solve iLQR kernel hand-written in CUDA for Hopper
(csrc/ilqr_fused.cu). Entry points run on the tensors' device: CUDA
tensors take the kernel where the configuration is covered, CPU tensors
the plain PyTorch loop. The backward (KKT/IFT) comes in a later slice.

Public API:
    ILQRConfig, solve            functional batched solver
    MPC                          reference-compatible class wrapper
    QuadCost, LinDx              problem types
    GradMethod, BackwardMode     enums
    receding_horizon             closed-loop episode driver
    models.{pendulum,cartpole}   envs
    convert.from_numpy           JAX-side parameters and data -> tensors
"""

from .control import receding_horizon
from .core.solver import solve
from .mpc import MPC
from .types import (
    BackwardMode,
    GradMethod,
    ILQRConfig,
    LinDx,
    QuadCost,
    SolveResult,
)

__version__ = "0.1.0"

__all__ = [
    "solve",
    "MPC",
    "receding_horizon",
    "ILQRConfig",
    "QuadCost",
    "LinDx",
    "GradMethod",
    "BackwardMode",
    "SolveResult",
]
