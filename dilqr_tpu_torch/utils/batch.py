"""Batched small-matrix linear algebra helpers (counterpart of
``dilqr_tpu/utils/batch.py``). Shape-polymorphic over leading batch dims.
PyTorch contracts float32 in full precision on the CPU and, with TF32 off
(its default for matmul), on the card."""
from __future__ import annotations

import torch


def bmv(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector: [..., n, m] @ [..., m] -> [..., n]."""
    return torch.einsum("...nm,...m->...n", X, y)


def bger(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched outer product: [..., n], [..., m] -> [..., n, m]."""
    return x[..., :, None] * y[..., None, :]


def bquad(x: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Batched quadratic form: x^T Q x -> [...]."""
    return torch.einsum("...n,...nm,...m->...", x, Q, x)


def bdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched dot product -> [...]."""
    return torch.einsum("...n,...n->...", x, y)


def bmm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched matmul."""
    return torch.einsum("...nk,...km->...nm", A, B)


def btr(A: torch.Tensor) -> torch.Tensor:
    """Batched matrix transpose on the last two dims."""
    return A.transpose(-1, -2)


def _as_bound(v, like: torch.Tensor):
    return v if isinstance(v, (int, float)) else torch.as_tensor(
        v, dtype=like.dtype, device=like.device)


def clamp(x: torch.Tensor, lower, upper) -> torch.Tensor:
    """Functional clamp; lower/upper are scalars or tensors broadcastable
    to x (None disables a side). NaN propagates, as in jnp.maximum."""
    if lower is not None:
        x = torch.maximum(x, torch.as_tensor(lower, dtype=x.dtype, device=x.device))
    if upper is not None:
        x = torch.minimum(x, torch.as_tensor(upper, dtype=x.dtype, device=x.device))
    return x


def clamp_t(x: torch.Tensor, lower, upper) -> torch.Tensor:
    """Clamp whose derivative is torch.clamp's: gradient 1 on the closed
    interval [lower, upper], bounds included (the reference's autograd
    convention that the AUTO_DIFF linearization must reproduce)."""
    lo, hi = _as_bound(lower, x), _as_bound(upper, x)
    return torch.where(x > hi, hi, torch.where(x < lo, lo, x))


def inv_small(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched inverse for n <= 3 (reciprocal / Cramer /
    adjugate), elementwise over the batch."""
    n = A.shape[-1]
    if n == 1:
        return 1.0 / A
    if n == 2:
        det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
        r = (1.0 / det)[..., None, None]
        row0 = torch.stack([A[..., 1, 1], -A[..., 0, 1]], -1)
        row1 = torch.stack([-A[..., 1, 0], A[..., 0, 0]], -1)
        return torch.stack([row0, row1], -2) * r
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    r = 1.0 / det
    c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    rows = [
        torch.stack([c00 * r, c10 * r, c20 * r], -1),
        torch.stack([c01 * r, c11 * r, c21 * r], -1),
        torch.stack([c02 * r, c12 * r, c22 * r], -1),
    ]
    return torch.stack(rows, -2)


def solve_psd(H: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched solve H X = B for small PSD-ish H; B is [..., n] or
    [..., n, m]. n <= 3 takes the closed-form inverse (plus one step of
    iterative refinement at f64), larger n a batched LU solve."""
    vec = B.dim() == H.dim() - 1
    if vec:
        B = B[..., None]
    if H.shape[-1] <= 3:
        Hi = inv_small(H)
        X = bmm(Hi, B)
        if H.dtype == torch.float64:
            X = X + bmm(Hi, B - bmm(H, X))
    else:
        X = torch.linalg.solve(H, B)
    return X[..., 0] if vec else X
