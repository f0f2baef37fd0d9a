"""Several devices of one process (counterpart of
``dilqr_tpu/parallel/mesh.py``): the batch split into equal contiguous
chunks, one a device, each solved on its device.

The solves are issued back to back, so the kernel launches of N cards run
at once; a chunk's tensors stay on its device, and the result says which
device holds which examples. Each chunk is a solve of its own, so the
stopping rule is the chunk's, as in JAX's shard_map path (mesh.py:300-307):
at eps=0 the result is the one-device solve's, and at eps > 0 each
example's cost is no worse. The CPU tests build the mesh from one device
repeated (``batch_mesh([torch.device("cpu")] * 8)``).

Use:
    mesh = batch_mesh()                     # every visible CUDA device
    sres = sharded_solve(mesh, cfg, x_init, cost, dyn, params=params)
    res = sres.gather()                     # the whole batch on one device
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..core.solver import solve
from ..types import ILQRConfig, LinDx, QuadCost, SolveResult

# solve()'s keyword arguments that carry a leading batch axis, with the
# ndim at which they do (batch-major user layouts, core/solver.py):
# u_init/u_zero_I/bounds [B,T,nu], prev_ctrl [B,nu]. At lower ranks they
# are example-invariant and go to every device whole.
_BATCH_KW_NDIM = {"u_init": 3, "u_zero_I": 3, "u_lower": 3, "u_upper": 3, "prev_ctrl": 2}


class DeviceMesh(NamedTuple):
    devices: Tuple[torch.device, ...]


class ShardedSolve(NamedTuple):
    """One SolveResult a chunk: shards[i] lives on devices[i] and holds the
    examples starts[i] .. starts[i + 1] of the batch."""
    shards: Tuple[SolveResult, ...]
    devices: Tuple[torch.device, ...]
    starts: Tuple[int, ...]

    @property
    def n_iter(self) -> int:
        return max(int(r.n_iter) for r in self.shards)

    def gather(self, device=None) -> SolveResult:
        """The whole batch on ``device`` (by default the first chunk's);
        n_iter the max over the chunks."""
        dev = torch.device(device) if device is not None else self.devices[0]
        fields = [torch.cat([getattr(r, f).to(dev) for r in self.shards])
                  for f in ("x", "u", "costs", "converged", "full_du_norm")]
        return SolveResult(*fields, torch.tensor(self.n_iter, dtype=torch.int32, device=dev))


def batch_mesh(devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh over the given devices, by default every visible CUDA device.
    There is no default without one: pass the devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("batch_mesh(): no CUDA device; pass devices=")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return DeviceMesh(tuple(torch.device(d) for d in devices))


def _chunks(mesh: DeviceMesh, a: torch.Tensor):
    n = len(mesh.devices)
    if a.shape[0] % n:
        raise ValueError(f"batch {a.shape[0]} does not split into {n} equal chunks")
    return [c.to(d) for c, d in zip(torch.chunk(a, n), mesh.devices)]


def shard_batch(mesh: DeviceMesh, tree):
    """Every leaf's leading axis in equal contiguous chunks, chunk i on
    device i. Returns one tree a device."""
    leaves, spec = pytree.tree_flatten(tree)
    cols = [_chunks(mesh, torch.as_tensor(a)) if a is not None else [None] * len(mesh.devices)
            for a in leaves]
    return [pytree.tree_unflatten([c[i] for c in cols], spec) for i in range(len(mesh.devices))]


def sharded_solve(mesh: DeviceMesh, cfg: ILQRConfig, x_init, cost, dynamics, params=None,
                  **kwargs) -> ShardedSolve:
    """The batched solve with the batch split over the mesh's devices.
    x_init [B, nx] and the batch-major leaves (a full-rank C [B,T,n,n] or
    c [B,T,n], LinDx F [B,T-1,n,m] or f [B,T-1,n], the keyword arguments
    of ``_BATCH_KW_NDIM``) are split; example-invariant ones (lower ranks,
    params, scalars) go to every device whole."""
    n = len(mesh.devices)

    def split(a, full_rank):
        if not isinstance(a, torch.Tensor) or a.dim() != full_rank:
            return [a.to(d) if isinstance(a, torch.Tensor) else a for d in mesh.devices]
        return _chunks(mesh, a)

    xs = _chunks(mesh, torch.as_tensor(x_init))
    if isinstance(cost, QuadCost):
        costs = [QuadCost(C, c) for C, c in zip(split(cost.C, 4), split(cost.c, 3))]
    else:
        costs = [cost] * n
    if isinstance(dynamics, LinDx):
        dyns = [LinDx(F, f) for F, f in zip(split(dynamics.F, 4), split(dynamics.f, 3))]
    else:
        dyns = [dynamics] * n
    kws = [{} for _ in range(n)]
    for k, v in kwargs.items():
        for kw, part in zip(kws, split(v, _BATCH_KW_NDIM.get(k, -1))):
            kw[k] = part
    shards = tuple(solve(cfg, x, c, d, params=params, **kw)
                   for x, c, d, kw in zip(xs, costs, dyns, kws))
    starts = tuple(i * xs[0].shape[0] for i in range(n + 1))
    return ShardedSolve(shards, mesh.devices, starts)
