"""The angle update shared by the pendulum and cartpole steps
(counterpart of ``rotate_cs`` in ``dilqr_tpu/utils/kernel_math.py``).

The steps recover the angle only to advance it by one Euler increment and
re-embed it. Off the kernel the reference's exact sequence is kept
(atan2, add, cos/sin), so the f64 goldens hold. The kernel form -- the one
the CUDA kernel computes (``csrc/ilqr_fused.cuh``) and that
``ops/cuda/ilqr_fused.ilqr_fused_reference`` repeats -- uses the
angle-addition identities and one rsqrt renormalization instead; the two
differ at f32 rounding only.
"""
from __future__ import annotations

import torch


def rotate_cs(cos_th, sin_th, delta, kernel: bool = False):
    """(cos, sin) of ``atan2(sin_th, cos_th) + delta``."""
    if not kernel:
        th = torch.atan2(sin_th, cos_th) + delta
        return torch.cos(th), torch.sin(th)
    cd = torch.cos(delta)
    sd = torch.sin(delta)
    c = cos_th * cd - sin_th * sd
    s = sin_th * cd + cos_th * sd
    # zero-norm guard: atan2(0, 0) = 0, so the sequential form returns
    # (cos delta, sin delta) for a degenerate input; rsqrt(0) would be inf
    nn = c * c + s * s
    r = torch.rsqrt(torch.clamp(nn, min=1e-30))
    zero = nn == 0.0
    return torch.where(zero, cd, c * r), torch.where(zero, sd, s * r)
