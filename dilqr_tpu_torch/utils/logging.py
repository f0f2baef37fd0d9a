"""Console iteration logging (counterpart of ``dilqr_tpu/utils/logging.py``):
the reference's table logger (util.table_log, util.py:79-101), a header
row printed once per tag, then one row per call. The solver's verbose
iterations print through it (core/ilqr.py)."""
from __future__ import annotations

from typing import Sequence, Tuple

_seen_tables = set()


def table_log(tag: str, d: Sequence[Tuple]) -> None:
    """d: (name, value) or (name, value, format) per column."""

    def print_row(r):
        print("| " + " | ".join(r) + " |")

    if tag not in _seen_tables:
        print_row([str(e[0]) for e in d])
        _seen_tables.add(tag)
    s = []
    for di in d:
        if len(di) not in (2, 3):
            raise ValueError(f"table_log: a column is (name, value[, format]), got {di!r}")
        s.append(di[2].format(di[1]) if len(di) == 3 else str(di[1]))
    print_row(s)
