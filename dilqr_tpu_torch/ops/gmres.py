"""Restarted GMRES (counterpart of ``dilqr_tpu/ops/gmres.py``), plain
PyTorch: the IFT backward (diff/ift.py) solves its adjoint system with it.

``gmres`` solves one system over a whole tuple of tensors; ``gmres_batched``
treats an operator that is block-diagonal across a batch axis as B
independent systems: every inner product, normalization and Givens rotation
runs per example, so each example converges against its own right-hand
side and reports its own residual. Both carry the residual vector between
cycles (m+1 matvecs a cycle). The batched form rotates each new Hessenberg
column at once (progressive Givens), so |g_{i+1}| is every example's
least-squares residual after i+1 directions and a cycle stops as soon as
all examples meet their tolerance; each such test is a host sync, and a
decision of every rank of an open ``parallel.comm.batch_global``. It runs
without autograd (the IFT backward calls it inside a backward pass).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..parallel.comm import decide

_EPS = 1e-30


def _flat(tree: Sequence[torch.Tensor]):
    """Tuple of tensors -> one flat vector, and its inverse."""
    shapes = [t.shape for t in tree]
    flat = torch.cat([t.reshape(-1) for t in tree])

    def unflat(f):
        out, o = [], 0
        for s in shapes:
            n = s.numel()
            out.append(f[o:o + n].reshape(s))
            o += n
        return tuple(out)

    return flat, unflat


def gmres(matvec: Callable, b: Sequence[torch.Tensor], x0: Optional[Sequence[torch.Tensor]] = None,
          tol: float = 1e-6, restart: int = 20, maxiter: int = 3, return_info: bool = False):
    """Solve A x = b for the linear operator ``matvec`` acting on tuples of
    tensors. Returns x; with ``return_info=True`` returns (x, res_norm,
    b_norm). ``tol`` is relative to ||b||; matvecs <= 1 + maxiter (restart+1)."""
    b_flat, unflat = _flat(b)
    n = b_flat.shape[0]
    m = restart

    def mv(xf):
        return _flat(matvec(unflat(xf)))[0]

    x = _flat(x0)[0] if x0 is not None else torch.zeros_like(b_flat)
    b_norm = torch.linalg.vector_norm(b_flat)
    atol = tol * (b_norm + _EPS)
    r = b_flat - mv(x)
    res = torch.linalg.vector_norm(r)
    it = 0
    while bool(res > atol) and it < maxiter:
        beta = torch.linalg.vector_norm(r)
        V = torch.zeros(m + 1, n, dtype=b_flat.dtype, device=b_flat.device)
        V[0] = r / (beta + _EPS)
        H = torch.zeros(m + 1, m, dtype=b_flat.dtype, device=b_flat.device)
        for i in range(m):
            w = mv(V[i])
            h = V @ w  # rows j > i of V are zero: exact Gram-Schmidt
            w = w - h @ V
            hn = torch.linalg.vector_norm(w)
            V[i + 1] = w / (hn + _EPS)
            H[:, i] = h
            H[i + 1, i] = hn
        e1 = torch.zeros(m + 1, dtype=b_flat.dtype, device=b_flat.device)
        e1[0] = beta
        y = torch.linalg.lstsq(H, e1[:, None]).solution[:, 0]
        x = x + y @ V[:m]
        r = b_flat - mv(x)
        res = torch.linalg.vector_norm(r)
        it += 1
    if return_info:
        return unflat(x), res, b_norm
    return unflat(x)


def _batch_flat(tree: Sequence[torch.Tensor], batch_axis: int):
    """Tuple of [..., B, ...] tensors (B at ``batch_axis``) -> [B, D], and
    its inverse."""
    B = tree[0].shape[batch_axis]
    mats, metas = [], []
    for t in tree:
        mt = torch.movedim(t, batch_axis, 0).reshape(B, -1)
        mats.append(mt)
        metas.append((mt.shape[1], t.shape))
    flat = torch.cat(mats, 1) if len(mats) > 1 else mats[0]

    def unflatten(f):
        out, o = [], 0
        for size, shp in metas:
            rest = tuple(shp[:batch_axis]) + tuple(shp[batch_axis + 1:])
            arr = f[:, o:o + size].reshape((B,) + rest)
            out.append(torch.movedim(arr, 0, batch_axis))
            o += size
        return tuple(out)

    return flat, unflatten


def gmres_batched(matvec: Callable, b: Sequence[torch.Tensor],
                  x0: Optional[Sequence[torch.Tensor]] = None, tol: float = 1e-6,
                  restart: int = 20, maxiter: int = 3, batch_axis: int = 1
                  ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """GMRES for an operator that is block-diagonal across ``batch_axis``.
    Returns (x, res_b, b_norm_b) with res_b, b_norm_b of shape [B]; an
    example failed when res_b > tol * b_norm_b."""
    b_flat, unflatten = _batch_flat(b, batch_axis)
    B, D = b_flat.shape
    dt, dev = b_flat.dtype, b_flat.device
    m = restart

    def mv(xf):
        return _batch_flat(matvec(unflatten(xf)), batch_axis)[0]

    x = _batch_flat(x0, batch_axis)[0] if x0 is not None else torch.zeros_like(b_flat)
    b_norm = torch.linalg.vector_norm(b_flat, dim=1)
    atol = tol * (b_norm + _EPS)

    def back_sub(R, g):
        """Back-substitution of the rotated upper-triangular R y = g[:m];
        a column the Arnoldi loop never reached has a zero diagonal and
        gets y_j = 0."""
        y = torch.zeros(B, m, dtype=dt, device=dev)
        for j in range(m - 1, -1, -1):
            num = g[:, j] - (R[:, j, j + 1:] * y[:, j + 1:]).sum(1)
            d = R[:, j, j]
            ok = d.abs() > _EPS
            y[:, j] = torch.where(ok, num / torch.where(ok, d, torch.ones_like(d)),
                                  torch.zeros_like(d))
        return y

    def cycle(x, r):
        beta = torch.linalg.vector_norm(r, dim=1)
        V = torch.zeros(m + 1, B, D, dtype=dt, device=dev)
        V[0] = r / (beta + _EPS)[:, None]
        R = torch.zeros(B, m + 1, m, dtype=dt, device=dev)
        cs = torch.zeros(B, m, dtype=dt, device=dev)
        sn = torch.zeros(B, m, dtype=dt, device=dev)
        g = torch.zeros(B, m + 1, dtype=dt, device=dev)
        g[:, 0] = beta
        res = beta
        i = 0
        while i < m and decide((res > atol).any()):
            w = mv(V[i])
            h = torch.einsum("ibd,bd->bi", V, w)  # rows j > i of V are zero
            w = w - torch.einsum("bi,ibd->bd", h, V)
            hn = torch.linalg.vector_norm(w, dim=1)
            V[i + 1] = w / (hn + _EPS)[:, None]
            h[:, i + 1] = hn
            for j in range(i):  # the earlier rotations, on the new column
                a, b_ = h[:, j].clone(), h[:, j + 1].clone()
                h[:, j] = cs[:, j] * a + sn[:, j] * b_
                h[:, j + 1] = -sn[:, j] * a + cs[:, j] * b_
            a, b_ = h[:, i].clone(), h[:, i + 1].clone()
            rr = torch.sqrt(a * a + b_ * b_) + _EPS
            cs[:, i], sn[:, i] = a / rr, b_ / rr
            h[:, i] = cs[:, i] * a + sn[:, i] * b_
            h[:, i + 1] = 0.0
            gi = g[:, i].clone()
            g[:, i] = cs[:, i] * gi
            g[:, i + 1] = -sn[:, i] * gi
            R[:, :, i] = h
            res = g[:, i + 1].abs()
            i += 1
        y = back_sub(R, g)
        x = x + torch.einsum("bi,ibd->bd", y, V[:m])
        r = b_flat - mv(x)
        return x, r, torch.linalg.vector_norm(r, dim=1)

    r = b_flat - mv(x)
    res = torch.linalg.vector_norm(r, dim=1)
    it = 0
    while decide((res > atol).any()) and it < maxiter:
        x, r, res = cycle(x, r)
        it += 1
    return unflatten(x), res, b_norm
