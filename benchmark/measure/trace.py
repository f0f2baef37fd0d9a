"""The traced window: torch.profiler over the card, and what is read from it.

A trace in a process that has run for a while drops the device activities of
its first milliseconds. So the window starts with a priming burst of device
work, waits ``PAD_S`` on the host, and marks the measured block with the
range ``WINDOW``; only device activities from that mark on are read. (A copy
of the port's ``utils/profiling.profiled``, ``device_events`` and
``busy_ms``, kept here so that a change to the program cannot move them.)

Host spans are ``torch.profiler.record_function`` ranges the runners (``benchmark/drive``) open
around each call into the program; ``breakdown`` labels each idle gap of the
device by the span the host was in when the gap began.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple

import torch

PAD_S = 0.2
WINDOW = "benchmark traced window"
SPAN_PREFIX = "bench."
NAME_CHARS = 120  # a device operation's name is cut to this many characters


class Interval(NamedTuple):
    name: str
    start: float  # microseconds, the profiler's clock
    end: float


def _prime() -> None:
    torch.cuda._sleep(10_000_000)
    v = torch.zeros(256, device="cuda")
    for _ in range(64):
        v.add_(1.0)
    torch.cuda.synchronize()


@contextlib.contextmanager
def window():
    """torch.profiler over host and card; yields the profiler. The block runs
    inside the ``WINDOW`` range and ends synchronized."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _prime()
        time.sleep(PAD_S)
        with record_function(WINDOW):
            yield prof
            torch.cuda.synchronize()


def span(name: str, on: bool):
    """A host span around a call, when tracing; otherwise nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)


class Trace(NamedTuple):
    device: List[Interval]  # kernels and copies from the window's mark on
    spans: List[Interval]  # the runners' host spans
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6


def read(prof) -> Trace:
    """The device activities and host spans of a ``window``."""
    from torch.autograd import DeviceType

    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    marks = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not marks:
        raise RuntimeError("the trace holds no window mark")
    start = min(e.time_range.start for e in marks)
    end = max(e.time_range.end for e in marks)
    lo = start - 0.9 * PAD_S * 1e6
    device = [Interval(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
              and e.name not in host_names and e.time_range.start >= lo]
    spans = [Interval(e.name[len(SPAN_PREFIX):], e.time_range.start, e.time_range.end)
             for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith(SPAN_PREFIX)]
    return Trace(device, spans, start, end)


def merged(device: List[Interval]):
    """The union of the intervals, as sorted disjoint (start, end) pairs."""
    out = []
    for s, t in sorted((d.start, d.end) for d in device):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def kernel_runs(tr: Trace, name: str, launches: int):
    """The device intervals of the kernel whose name holds ``name``, or None
    where the trace recorded fewer than 90% of the ``launches`` the program
    counted, or more than it counted (C2: a trace can drop its first
    activities)."""
    runs = [d for d in tr.device if name in d.name]
    if not runs or not 0.9 * launches <= len(runs) <= launches:
        return None
    return runs


def busy_s(tr: Trace) -> float:
    return sum(t - s for s, t in merged(tr.device)) / 1e6


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations with the most time (by name, cut to
    ``NAME_CHARS``), and the device's idle time within the window split by
    the host span it overlapped ("outside spans" for the rest); the runners'
    spans follow one another without nesting. Each list holds the ``top``
    largest, in seconds."""
    ops: dict = {}
    for d in tr.device:
        name = d.name[:NAME_CHARS]
        ops[name] = ops.get(name, 0.0) + (d.end - d.start) / 1e6
    gaps, prev = [], tr.start
    for s, t in merged(tr.device) + [[tr.end, tr.end]]:
        s = min(max(s, tr.start), tr.end)
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    idle: dict = {}
    spans = sorted(tr.spans, key=lambda sp: sp.start)
    j = 0
    for g0, g1 in gaps:
        while j < len(spans) and spans[j].end <= g0:
            j += 1
        covered = 0.0
        for sp in spans[j:]:
            if sp.start >= g1:
                break
            ov = min(g1, sp.end) - max(g0, sp.start)
            if ov > 0:
                idle[sp.name] = idle.get(sp.name, 0.0) + ov / 1e6
                covered += ov
        rest = (g1 - g0) - covered
        if rest > 0:
            idle["outside spans"] = idle.get("outside spans", 0.0) + rest / 1e6
    def rank(d):
        return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]

    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
