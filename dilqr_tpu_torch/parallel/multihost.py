"""Multi-process distribution on torch.distributed (counterpart of
``dilqr_tpu/parallel/multihost.py``): one batch sharded over every rank of
a process group, one device a rank.

Examples are independent, so each rank solves its own examples on its own
device, and the only collectives are the scalar ones: the whole batch's
decisions of the plain loop and GMRES (``comm.decide``), the max of n_iter,
and the train step's loss and gradient. The whole-solve kernel decides per
1024-example tile, so on CUDA tensors a rank's solve issues no collective
but the n_iter max, and shards that are whole tiles give the one-process
bits.

Usage (the same program on every rank; see tools/multihost_demo.py):

    from dilqr_tpu_torch.parallel import multihost as mh
    mh.initialize()                    # torchrun's environment; explicit
                                       # arguments for a local cluster
    mesh = mh.global_batch_mesh()
    res = mh.multihost_solve(mesh, cfg, x_init_local, cost, dyn, params=params)
    u_all = mh.gather(mesh, res.u)     # the whole batch on every rank

NCCL is the default for a CUDA device and gloo for the host; gloo on a
CUDA device runs its collectives on the host (comm.py), which is how two
ranks share one card: NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..core.solver import solve
from ..types import ILQRConfig, QuadCost, SolveResult
from . import comm
from .comm import BatchMesh

_DEVICE: Optional[torch.device] = None  # the device initialize chose


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None, backend: Optional[str] = None,
               timeout: float = 300.0) -> None:
    """Idempotent ``torch.distributed.init_process_group``.

    With no arguments it reads torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT), the counterpart of a TPU pod's
    argument-free ``jax.distributed.initialize``. A local cluster passes
    the store (``file:///path``, ``tcp://host:port`` or ``host:port``), the
    process count and this process's rank.

    ``device``: this rank's device, by default ``cuda:LOCAL_RANK`` (LOCAL_RANK
    from the environment, else the rank: one node). ``backend``: NCCL for a
    CUDA device, gloo for the host, unless given (gloo on a CUDA device is
    allowed). Nothing is chosen for the caller: a CUDA device without CUDA,
    or NCCL without a CUDA device, raises. ``timeout``: seconds a collective
    waits for the other ranks before it raises.
    """
    global _DEVICE
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
        if missing:
            raise RuntimeError(
                f"initialize(): no cluster given and {missing} unset; run under torchrun or pass "
                "coordinator_address, num_processes and process_id")
        init_method, process_id, num_processes = "env://", int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize(): coordinator_address needs num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    dev = torch.device(device if device is not None
                       else f"cuda:{int(env.get('LOCAL_RANK', process_id))}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"initialize(): device {dev} asked for, but CUDA is not available")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("initialize(): NCCL needs a CUDA device")
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    _DEVICE = dev


def shutdown() -> None:
    """Destroy the process group ``initialize`` made (a no-op without one)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def global_batch_mesh() -> BatchMesh:
    """This rank of the group ``initialize`` made, with its device.
    Collectives run on the device under NCCL and on the host under gloo."""
    if not dist.is_initialized() or _DEVICE is None:
        raise RuntimeError("global_batch_mesh(): call initialize() first")
    on_device = dist.get_backend() == "nccl"
    return BatchMesh(dist.get_rank(), dist.get_world_size(), _DEVICE,
                     _DEVICE if on_device else torch.device("cpu"))


class BatchLayout(NamedTuple):
    """Which examples of the global batch each rank holds: rank r holds
    offset(r) .. offset(r) + counts[r], in rank order."""
    counts: Tuple[int, ...]

    @property
    def total(self) -> int:
        return sum(self.counts)

    def offset(self, rank: int) -> int:
        return sum(self.counts[:rank])


def _leading(tree) -> int:
    sizes = {a.shape[0] for a in pytree.tree_leaves(tree) if isinstance(a, torch.Tensor)}
    if len(sizes) > 1:
        raise ValueError(f"inconsistent local batch dims: {sorted(sizes)}")
    return sizes.pop() if sizes else 0


def _on_device(mesh: BatchMesh, tree):
    return pytree.tree_map(lambda a: torch.as_tensor(a).to(mesh.device)
                           if a is not None else None, tree)


def _gather_per_process(mesh: BatchMesh, a: torch.Tensor, site: str) -> torch.Tensor:
    """[world_size, *a.shape]: every rank's ``a`` (equal shapes), in rank
    order, on comm_device. JAX's version serves heterogeneous device counts
    a process; with one device a rank it is a plain all-gather."""
    return torch.stack(comm.all_gather(mesh, a, site))


def _counts(mesh: BatchMesh, b_local: int, site: str) -> Tuple[int, ...]:
    sizes = _gather_per_process(mesh, torch.tensor([b_local], dtype=torch.int64), site)
    return tuple(int(v) for v in sizes.reshape(-1))


def _all_rows(mesh: BatchMesh, a: torch.Tensor, counts, site: str) -> torch.Tensor:
    """Every rank's rows of ``a`` (counts[r] of them on rank r) in rank
    order, by one all-gather padded to the largest count."""
    pad = a.new_zeros((max(counts) - a.shape[0],) + tuple(a.shape[1:]))
    stacked = _gather_per_process(mesh, torch.cat([a, pad]), site)
    return torch.cat([stacked[r, :c] for r, c in enumerate(counts)])


def distribute_batch(mesh: BatchMesh, tree):
    """This rank's [B_local, ...] leaves on its device, and the layout of
    the global batch (one all-gather of the local sizes). Every rank passes
    its own examples. Returns (tree, BatchLayout)."""
    tree = _on_device(mesh, tree)
    return tree, BatchLayout(_counts(mesh, _leading(tree), "distribute"))


def distribute_batch_padded(mesh: BatchMesh, tree):
    """Arbitrary uneven per-rank batches (B_local >= 0) as equal contiguous
    shares of one global batch. The global batch B = sum of the local ones
    is padded up to the next multiple of the world size; the padding rows
    duplicate the last real example (as JAX's do), which leaves the
    solver's max-based decisions for the whole batch unchanged, so real
    examples solve as in the unpadded batch. Mask the padding out of any
    mean (``loss = where(valid, l, 0).sum() / B``).

    The assembly is data loading, not a solve's collective: one size
    all-gather and one padded all-gather a leaf (O(B) traffic, site
    "distribute"). Returns (tree, valid [B_share] bool, B)."""
    b_local = _leading(tree)
    counts = _counts(mesh, b_local, "distribute")
    B, W = sum(counts), mesh.world_size
    Bp = -(-B // W) * W
    share = Bp // W
    lo = mesh.rank * share

    def put(a):
        if a is None:
            return None
        full = _all_rows(mesh, torch.as_tensor(a), counts, "distribute")
        tail = (full[-1:].expand((Bp - B,) + tuple(full.shape[1:])) if B
                else full.new_zeros((Bp,) + tuple(full.shape[1:])))
        return torch.cat([full, tail])[lo:lo + share].to(mesh.device)

    valid = (torch.arange(lo, lo + share) < B).to(mesh.device)
    return pytree.tree_map(put, tree), valid, B


def replicate(mesh: BatchMesh, tree):
    """Rank 0's leaves on every rank's device (one broadcast a leaf):
    params, optimizer state, compact costs."""
    return pytree.tree_map(
        lambda a: None if a is None else
        comm.broadcast(mesh, torch.as_tensor(a), "replicate").to(mesh.device), tree)


def gather(mesh: BatchMesh, tree):
    """The whole batch on every rank's device: each leaf's per-rank
    [B_local, ...] shards concatenated in rank order (one size all-gather,
    then one padded all-gather a leaf). For checks and logging only: O(B)
    traffic, site "gather"."""
    counts = _counts(mesh, _leading(tree), "gather")
    return pytree.tree_map(
        lambda a: _all_rows(mesh, a, counts, "gather").to(mesh.device), tree)


def multihost_solve(mesh: BatchMesh, cfg: ILQRConfig, x_init, cost, dynamics, params=None,
                    **kwargs) -> SolveResult:
    """The batched solve of a batch sharded over the ranks.

    ``x_init`` and any batch-major leaf of ``cost``, ``dynamics`` or the
    keyword arguments (a full-rank C [B,T,n,n] or c [B,T,n], F, f, u_init,
    bounds) are this rank's examples; example-invariant ones are passed the
    same by every rank. The solve runs on this rank's device inside
    ``comm.batch_global``, so the plain loop's and GMRES's decisions
    (its backward's too) are the whole batch's; n_iter is the max over the
    ranks. Returns this rank's rows of the result (``gather`` for all)."""
    x_init = _on_device(mesh, x_init)
    with comm.batch_global(mesh):
        res = solve(cfg, x_init, cost, dynamics, params=params, **kwargs)
    n_iter = comm.all_reduce(mesh, res.n_iter.reshape(1), dist.ReduceOp.MAX, "n_iter")
    return res._replace(n_iter=n_iter.reshape(()).to(res.n_iter.device))


def multihost_train_step(mesh: BatchMesh, cfg: ILQRConfig, dyn, opt):
    """The distributed imitation-learning step: the differentiable solve
    on this rank's examples, the imitation loss mean((u - u_expert)^2), its
    gradient with respect to the dynamics params, and ``opt`` (a
    ``utils.optim.Optimizer``, e.g. ``optim.rmsprop(1e-2, decay=0.5)``).
    Returns step(params, opt_state, x_init, u_expert, q, p) -> (params,
    opt_state, loss), x_init and u_expert this rank's rows, the rest the
    same on every rank.

    Each rank runs the forward and the backward (``cfg``'s backward mode;
    the KKT kernel in GMRES on a card) on its own examples inside
    ``comm.batch_global``. The loss and the gradient, each weighted by the
    rank's example count, and the count itself travel in one buffer and
    one all-reduce, so the result is the mean over the global batch. As in
    JAX's shard_map step, the global batch must divide by the world size.
    """

    def step(params, opt_state, x_init, u_expert, q, p):
        leaves, spec = pytree.tree_flatten(params)
        lv = [a.detach().to(mesh.device).requires_grad_(True) for a in leaves]
        x, ue = _on_device(mesh, (x_init, u_expert))
        q, p = _on_device(mesh, (q, p))
        with comm.batch_global(mesh):
            res = solve(cfg, x, QuadCost(torch.diag(q), p), dyn,
                        params=pytree.tree_unflatten(lv, spec),
                        u_lower=dyn.lower, u_upper=dyn.upper)
            loss = ((res.u - ue) ** 2).mean()
            grads = torch.autograd.grad(loss, lv)
        b = float(x.shape[0])
        buf = torch.cat([g.reshape(-1) * b for g in grads]
                        + [(loss.detach() * b).reshape(1), loss.new_full((1,), b)])
        buf = comm.all_reduce(mesh, buf, dist.ReduceOp.SUM, "train_step").to(mesh.device)
        B = int(buf[-1].item())
        if B % mesh.world_size:
            raise ValueError(
                f"global batch {B} not divisible by the {mesh.world_size}-rank mesh; pad the "
                "dataset-remainder batch with distribute_batch_padded (mask the loss with its "
                "validity mask) or drop the remainder")
        mean = buf[:-1] / buf[-1]  # the gradient's entries, then the loss
        parts = torch.split(mean[:-1], [g.numel() for g in grads])
        new_params, opt_state = opt.update(
            pytree.tree_unflatten([a.to(mesh.device) for a in leaves], spec),
            pytree.tree_unflatten([s.reshape(g.shape) for s, g in zip(parts, grads)], spec),
            opt_state)
        return new_params, opt_state, mean[-1]

    return step
