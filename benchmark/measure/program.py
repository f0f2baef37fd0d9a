"""The program's own spans, placed on a traced window's clock.

Under a torch.profiler session the program logs each span of its solve path
as ``(name, start_ns, end_ns)`` on the host's clock
(``dilqr_tpu_torch/utils/profiling.span_log``): ``solve`` around
``solve.canonicalize``, ``ilqr.gate``, ``ilqr_fused.prepare`` and
``ilqr_fused.launch``. A traced window (``measure.trace.read``) holds the
runners' ``bench.*`` spans and the device's intervals, in microseconds
from the trace's start. ``place`` pairs the k-th program ``solve`` of the
window with the k-th ``bench.solve`` span (the loop runners call
``MPC.solve`` once inside each) and moves the window's program spans by the
median of the pairs' start offsets. That median places them a little early:
``bench.solve`` opens its range before the call reaches the program's.

``margins`` holds the device's side against the host's: the k-th
``ilqr_fused_kernel`` interval against the k-th ``ilqr_fused.launch`` span,
where the trace holds every launch the program counted. A kernel cannot
start before the call that launched it, so the largest margin by which a
kernel seems to start before its launch span is the window's skew: the
device's timestamps mapped onto the host's clock that far off, at least. A
reader that sets program spans against device intervals (``checked``) reads
nothing where the skew is over ``SKEW_LIMIT_US``.

A program without spans gives no log, and every reader of them reads
nothing.
"""
from __future__ import annotations

import statistics
from typing import List, NamedTuple, Optional

from benchmark.measure.trace import Interval, kernel_runs, merged

SOLVE = "solve"
LAUNCH = "ilqr_fused.launch"
KERNEL = "ilqr_fused_kernel"
SKEW_LIMIT_US = 20.0


def log():
    """The program's span log, or None where the program keeps none."""
    try:
        from dilqr_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "span_log", None)
    return None if read is None else read()


class Placed(NamedTuple):
    spans: List[Interval]  # the window's program spans, microseconds on the trace's clock
    solves: int  # the window's solves, each program solve paired with a bench.solve
    offsets: List[float]  # each pair's start offset, microseconds (bench less program)
    end_offsets: List[float]  # the same of the pair's ends


def place(tr, entries) -> Optional[Placed]:
    """The window's program spans on the trace's clock: the last as many
    program ``solve`` spans as the window has ``bench.solve`` spans, and
    the spans inside them. None without a trace, a log or a ``bench.solve``
    span, or where the log holds fewer ``solve`` spans than the window."""
    if tr is None or entries is None:
        return None
    bench = sorted((sp for sp in tr.spans if sp.name == SOLVE), key=lambda sp: sp.start)
    solves = sorted((e for e in entries if e[0] == SOLVE), key=lambda e: e[1])
    if not bench or len(solves) < len(bench):
        return None
    solves = solves[-len(bench):]
    ref = solves[0][1]  # ns; at 2**60 ns, the host clock's reading, a float's step is 256

    def us(ns):
        return (ns - ref) / 1e3

    offsets = [b.start - us(s) for b, (_, s, _) in zip(bench, solves)]
    end_offsets = [b.end - us(t) for b, (_, _, t) in zip(bench, solves)]
    shift = statistics.median(offsets)
    lo, hi = solves[0][1], solves[-1][2]
    spans = sorted((Interval(name, us(s) + shift, us(t) + shift)
                    for name, s, t in entries if lo <= s and t <= hi), key=lambda sp: sp.start)
    return Placed(spans, len(bench), offsets, end_offsets)


def margins(tr, placed: Optional[Placed], launches: int) -> Optional[List[float]]:
    """Per launch of the window, in order, how far its kernel's device
    interval seems to start before its ``ilqr_fused.launch`` span starts,
    in microseconds (negative: after). None where the trace does not hold
    every launch the program counted, or the log another number."""
    if placed is None or launches <= 0:
        return None
    runs = kernel_runs(tr, KERNEL, launches)
    calls = [sp.start for sp in placed.spans if sp.name == LAUNCH]
    if runs is None or len(runs) != launches or len(calls) != launches:
        return None
    return [c - r.start for c, r in zip(calls, sorted(runs, key=lambda r: r.start))]


def host_ms(ctx, name: str) -> Optional[float]:
    """The host ms of the window's program spans ``name``, per solve; None
    where the window has none."""
    placed = place(ctx.outcome.trace, log())
    if placed is None:
        return None
    mine = [sp.end - sp.start for sp in placed.spans if sp.name == name]
    if not mine:
        return None
    return sum(mine) / placed.solves / 1e3


def checked(ctx) -> Optional[Placed]:
    """The window's program spans where the device's timestamps may be set
    against them: placed, every launch paired, and a skew of at most
    ``SKEW_LIMIT_US``; else None."""
    placed = place(ctx.outcome.trace, log())
    m = margins(ctx.outcome.trace, placed, ctx.outcome.launches)
    if m is None or max(m) > SKEW_LIMIT_US:
        return None
    return placed


def idle_within(spans: List[Interval], device: List[Interval]) -> float:
    """The microseconds of the spans (disjoint) in which no device interval
    ran."""
    busy = merged(device)
    idle, j = 0.0, 0
    for sp in sorted(spans, key=lambda sp: sp.start):
        while j < len(busy) and busy[j][1] <= sp.start:
            j += 1
        covered, k = 0.0, j
        while k < len(busy) and busy[k][0] < sp.end:
            covered += min(sp.end, busy[k][1]) - max(sp.start, busy[k][0])
            k += 1
        idle += (sp.end - sp.start) - covered
    return idle
