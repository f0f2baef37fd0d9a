"""The runners of the traffic mixes, one file a ``mode``
(``benchmark/traffic/<mix>.json`` names its mode), and what they share."""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional

import torch


@dataclasses.dataclass
class Outcome:
    """What a runner's window did."""
    batch: int
    window_s: float
    solves: int
    failed: torch.Tensor  # examples with a cost that is not finite, on the card
    step_ms: List[float]  # host time of each closed-loop step (loops only)
    samples: List[dict]  # the sampled solves' inputs and outputs, for the check
    n_iters: List[torch.Tensor]  # each solve's SolveResult.n_iter (traced runs)
    launches: int = 0  # whole-solve kernel launches the program counted (traced runs)
    trace: Optional[object] = None  # measure.trace.Trace (traced runs)
    t_start: float = 0.0  # host clock at the window's start


def sample_indices(seed: int, k: int, seconds: float, call_s: float) -> set:
    """Which calls of the window to check: k drawn from the seed among the
    calls that half the window surely holds."""
    n = max(k + 1, int(0.5 * seconds / max(call_s, 1e-6)))
    return set(random.Random(seed).sample(range(n), k))


def launches() -> int:
    """The whole-solve kernel's launch counter, kept by the program."""
    from dilqr_tpu_torch.ops.cuda import ilqr_fused

    return ilqr_fused.LAUNCHES


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
