"""The port's collectives and the batch-global decisions.

Every collective the port issues goes through ``_issue``: it is recorded
with each active ``audit.recording()``, then handed to torch.distributed.
A rank's tensors live on ``BatchMesh.device``; its collectives run on
``BatchMesh.comm_device``, the device itself under NCCL and the host
under gloo, whose CUDA support covers broadcast and all_reduce only
(PyTorch's table of backends), so two ranks can share one card over gloo.

The plain loop and GMRES make decisions for the whole batch (the stopping
rule, the not-improved reset, pnqp's exit, GMRES's restart and inner exit).
They go through ``decide``: while ``batch_global(mesh)`` is open (the
multi-rank solve and train step open it), the flag is reduced across the
ranks with one all-reduce, so every rank branches on the same value and the
ranks together take the one-process path; with no mesh open it is
``bool(flag)`` and issues nothing. The whole-solve kernel needs no such
hook: it decides per 1024-example tile.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional

import torch
import torch.distributed as dist

from . import audit


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """One rank's view of a batch sharded over the ranks of the default
    process group, one device a rank (``multihost.global_batch_mesh``)."""
    rank: int
    world_size: int
    device: torch.device  # where this rank's examples live
    comm_device: torch.device  # where its collectives run


_ACTIVE: List[BatchMesh] = []


@contextlib.contextmanager
def batch_global(mesh: Optional[BatchMesh]) -> Iterator[None]:
    """Reduce ``decide``'s flags across ``mesh``'s ranks inside the block
    (None: a no-op). Every rank must run the same solves inside it."""
    if mesh is None:
        yield
        return
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active() -> Optional[BatchMesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def decide(flag: torch.Tensor, across: str = "any") -> bool:
    """A decision for the whole batch from this rank's 0-d bool ``flag``:
    true when it holds on any rank (``across="any"``) or on every rank
    ("all")."""
    mesh = active()
    if mesh is None:
        return bool(flag)
    op = {"any": dist.ReduceOp.MAX, "all": dist.ReduceOp.MIN}[across]
    return bool(all_reduce(mesh, flag.reshape(1).to(torch.int32), op, "decide").item())


def _issue(op: str, site: str, dtype, numel: int, call) -> None:
    audit.record(op, site, dtype, numel)
    call()


def all_reduce(mesh: BatchMesh, t: torch.Tensor, op, site: str) -> torch.Tensor:
    """The reduction of ``t`` over the ranks, a new tensor on comm_device."""
    buf = t.detach().to(mesh.comm_device, copy=True)
    _issue("all_reduce", site, buf.dtype, buf.numel(),
           lambda: dist.all_reduce(buf, op=op))
    return buf


def all_gather(mesh: BatchMesh, t: torch.Tensor, site: str) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order, on comm_device."""
    buf = t.detach().to(mesh.comm_device).contiguous()
    out = [torch.empty_like(buf) for _ in range(mesh.world_size)]
    _issue("all_gather", site, buf.dtype, buf.numel() * mesh.world_size,
           lambda: dist.all_gather(out, buf))
    return out


def broadcast(mesh: BatchMesh, t: torch.Tensor, site: str) -> torch.Tensor:
    """Rank 0's ``t`` on every rank, a new tensor on comm_device."""
    buf = t.detach().to(mesh.comm_device, copy=True).contiguous()
    _issue("broadcast", site, buf.dtype, buf.numel(),
           lambda: dist.broadcast(buf, src=0))
    return buf
