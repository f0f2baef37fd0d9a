"""Carry parameters and problem data from the JAX package into the port.

In this system the "weights" are the dynamics parameters and the cost
(q, p, or a whole ``QuadCost``), plus the problem data (initial states,
warm starts, ``LinDx`` matrices). The JAX side hands them over as numpy
arrays (``np.asarray`` of its arrays); ``from_numpy`` turns them into the
port's tensors, keeping the structure.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .types import LinDx, QuadCost


def from_numpy(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """Convert numpy arrays (or numpy scalars) inside ``tree`` -- a plain
    array, tuple/list/dict, ``QuadCost`` or ``LinDx``, nested freely -- to
    torch tensors on ``device`` (default: the CPU). Floating arrays take
    ``dtype`` when given and keep their own otherwise; other arrays keep
    theirs. None and python scalars pass through."""
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    if isinstance(tree, (QuadCost, LinDx)):
        return type(tree)(*(from_numpy(v, device, dtype) for v in tree))
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, device, dtype) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        arr = np.ascontiguousarray(tree)
        t = torch.from_numpy(arr.copy())
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device) if device is not None else t
    raise TypeError(
        f"from_numpy: unsupported leaf of type {type(tree).__name__}; pass "
        "numpy arrays (np.asarray of the JAX arrays)"
    )
