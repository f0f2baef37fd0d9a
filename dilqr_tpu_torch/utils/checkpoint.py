"""Checkpoint save/load for training state (counterpart of
``dilqr_tpu/utils/checkpoint.py``): a tree of tensors, numpy arrays and
python values (dicts, lists, tuples), written with ``torch.save``. Tensors
are moved to the CPU first, so a checkpoint written on the card loads
anywhere."""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree


def save(path: str, tree: Any) -> None:
    host = pytree.tree_map(
        lambda a: a.detach().cpu() if isinstance(a, torch.Tensor) else a, tree)
    torch.save(host, path)


def load(path: str, map_location="cpu") -> Any:
    # the tree holds numpy arrays and python values next to tensors, which
    # torch.load's weights-only mode refuses; load only files you wrote
    return torch.load(path, map_location=map_location, weights_only=False)
