"""dilqr_tpu_torch -- the PyTorch/CUDA port of dilqr_tpu.

A second package beside the JAX one, with the same module layout: the
batched box-constrained iLQR (with the slew-rate penalty), its KKT, IFT and
UNROLL backwards, the associative-scan Riccati (``riccati_parallel``,
ops/parallel_riccati.py), the envs and the learned MLP model, the MPC
wrapper, the closed-loop driver and the imitation-learning trainer with its
LSTM policy (il/lstm.py), the utilities (utils/: logging, numdiff,
profiling, optim, checkpoint), with the JAX package's four TPU kernels
hand-written in CUDA for Hopper (csrc/: the whole-solve iLQR, the KKT VJP,
the reverse Riccati). Entry points run on the tensors' device: CUDA
tensors take a kernel where the configuration is covered, CPU tensors the
plain PyTorch versions.

Public API:
    ILQRConfig, solve            functional batched solver
    MPC                          reference-compatible class wrapper
    QuadCost, LinDx              problem types
    GradMethod, BackwardMode     enums
    receding_horizon             closed-loop episode driver
    models.{pendulum,cartpole,rocket}  envs
    models.nn_dynamics           the learned MLP model
    models.{affine,ctrl_passthrough}  affine dynamics, the slew-rate wrapper
    convert.from_numpy           JAX-side parameters and data -> tensors
    il.exp.ILExp, il.lstm        the trainer (modes nn, empc, imempc, sysid)
    viz                          renderers (matplotlib, imported when drawing)
    examples.*                   the six example scripts (python -m ...)

torch.func.vmap over solve / MPC folds a sweep into one solve where the
whole-solve kernel takes it (diff/modes.py).
"""

from . import models
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
    "models",
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
