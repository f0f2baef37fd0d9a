"""The precision below float32 for the control: TF32, float32 with its
mantissa rounded to 10 bits (round to nearest, ties to even), which is what
the tensor cores do to a float32 operand. Emulated, so that the control reads
the same on the card and on a CPU."""
from __future__ import annotations

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 where it is a finite float32 tensor; anything else
    as it is."""
    if not torch.is_tensor(t) or t.dtype != torch.float32:
        return t
    i = t.contiguous().view(torch.int32)
    r = ((i + 0xFFF + ((i >> 13) & 1)) & -8192).view(torch.float32)
    return torch.where(torch.isfinite(t), r, t)
