"""Collectives audit (counterpart of ``dilqr_tpu/parallel/audit.py``):
check that a multi-rank solve or train step moves no per-example tensor
across ranks, only the scalar stopping-rule flags and the loss and
gradient reductions.

PyTorch has no compiled module to read, so the record is kept as the
collectives are issued: every collective of the port goes through
``comm._issue``, which appends a ``Collective`` to each list that an
active ``recording()`` holds. Input distribution and ``gather`` are the
caller's O(B) traffic, as in JAX; they carry their own ``site``
(``CALLER_SITES``), so that a solve's window can be audited alone.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, NamedTuple, Sequence, Tuple

# the caller's traffic: data distribution, checks and logging
CALLER_SITES = ("distribute", "gather", "replicate")


class Collective(NamedTuple):
    op: str  # the torch.distributed call: all_reduce, all_gather, broadcast
    site: str  # who issued it: decide, n_iter, train_step, or a CALLER_SITES entry
    dtype: str
    numel: int  # elements on its larger side (an all-gather's whole result)


_RECORDERS: List[List[Collective]] = []


@contextlib.contextmanager
def recording() -> Iterator[List[Collective]]:
    """Record every collective issued in this process while the block
    runs; yields the list the records are appended to."""
    recs: List[Collective] = []
    _RECORDERS.append(recs)
    try:
        yield recs
    finally:
        _RECORDERS.remove(recs)


def record(op: str, site: str, dtype, numel: int) -> None:
    if _RECORDERS:
        c = Collective(op, site, str(dtype).replace("torch.", ""), int(numel))
        for recs in _RECORDERS:
            recs.append(c)


def audit_collectives(records: Sequence[Collective], batch: int
                      ) -> Tuple[List[Collective], List[Collective]]:
    """Returns (collectives, offending). Legitimate collectives are
    reductions over the batch of at most ``batch`` elements (the stopping
    rule's flags, n_iter, the loss and the parameter gradient); anything
    larger moved per-example data (audit.py:40-52 of the JAX package)."""
    colls = list(records)
    return colls, [c for c in colls if c.numel > batch]
