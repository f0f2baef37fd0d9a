"""Batched numerical differentiation by central differences (counterpart
of ``dilqr_tpu/utils/numdiff.py``, the reference's torch_numdiff.py:15-46):
a derivative oracle independent of autograd, e.g. for the envs' analytic
Jacobians."""
from __future__ import annotations

from typing import Callable

import torch


def grad(fn: Callable, x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Central-difference gradient of a batched function.
    fn: [B, n] -> [B]; x: [B, n]. Returns [B, n]."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device) * eps
    cols = [(fn(x + e) - fn(x - e)) / (2.0 * eps) for e in eye]
    return torch.stack(cols, -1)


def hess(fn: Callable, x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Central-difference Hessian of a batched function.
    fn: [B, n] -> [B]; x: [B, n]. Returns [B, n, n], symmetrized."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device) * eps
    rows = [grad(fn, x + e, eps=eps) - grad(fn, x - e, eps=eps) for e in eye]
    H = torch.stack(rows, 1) / (2.0 * eps)  # [B, n, n]
    return 0.5 * (H + H.transpose(-1, -2))
