"""Affine dynamics x' = A x + B u (+ c) (counterpart of
``dilqr_tpu/models/affine.py``, reference dynamics.py:159-202).

Params: dict(A [nx,nx], B [nx,nu], c [nx] or None). The Jacobian is (A, B)
exactly, given as a hand-written ``jacobian`` broadcast over the batch. The
whole-solve kernel refuses a model with a ``jacobian``, so its solves run
the plain loop, whose Riccati backward is the CUDA Riccati kernel on the
card for one control in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from .base import Dynamics


def make(n_state: int, n_ctrl: int) -> Dynamics:
    def step(x, u, params):
        out = x @ params["A"].transpose(-1, -2) + u @ params["B"].transpose(-1, -2)
        c = params.get("c")
        return out if c is None else out + c

    def jacobian(x, u, params):
        A, B = params["A"], params["B"]
        return A.expand(x.shape[:-1] + A.shape), B.expand(u.shape[:-1] + B.shape)

    return Dynamics(n_state=n_state, n_ctrl=n_ctrl, step=step, jacobian=jacobian)


def params(A, B, c: Optional[torch.Tensor] = None) -> dict:
    return {"A": torch.as_tensor(A), "B": torch.as_tensor(B),
            "c": None if c is None else torch.as_tensor(c)}
