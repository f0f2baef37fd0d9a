"""Profiling helpers (counterpart of ``dilqr_tpu/utils/profiling.py``):
torch.profiler traces, the program's own spans, pipelined wall times and
the device's own time read from a trace.

    with trace("/tmp/ilqr_trace"):
        run_solves()
    # -> /tmp/ilqr_trace/trace.json, for chrome://tracing or Perfetto, with
    #    the solve path's spans (dilqr.solve, ...) beside the kernels they launched
    span_totals()  # {"solve": (count, host ms), "ilqr.gate": ..., ...}

**Spans.** The solve path opens ``span(name)`` where its host work lies:
``solve`` (``core/solver.solve``), ``solve.canonicalize`` inside it,
``ilqr.gate`` (``core/ilqr.ilqr_loop`` until the kernel is chosen),
``ilqr_fused.prepare`` and ``ilqr_fused.launch`` (``ops/cuda/ilqr_fused``).
The profiler session is the switch: with none active a span reads one flag
and does nothing more; under one it is the range ``SPAN_PREFIX + name`` and
one entry ``(name, start_ns, end_ns)`` of ``span_log``, stamped on the
host's clock (``time.time_ns``, which the profiler's host timestamps
follow) inside the range. The log keeps the newest ``SPAN_LOG_LEN``
entries; ``span_totals`` sums them by name.

A device time is the union of the device activities' intervals: the
profiler also gives each host operator and annotated range the device time
of the kernels under it, so a sum over every row with device time counts a
kernel two or three times.

Every window here is opened by ``profiled``. In a process that has run
for minutes, a trace drops the device activities of its first few
milliseconds of device work: a one-call window recorded none of them, a
burst of 20 whole-solve launches lost its first 3, where a fresh process
recorded all (PERF.md, ROADMAP C2). ``profiled`` therefore starts the trace
with a priming burst of device work, waits ``PAD_S``, and marks the
caller's block with the range ``WINDOW``; ``device_events`` keeps the
activities from that mark on. Even a primed window once lost a whole burst,
for a cause still unknown: a caller that knows how many launches a window
holds opens it again, up to ``WINDOW_TRIES`` windows in all, and reads a
last window that is still short as not measured (``kernel_ms``).
"""
from __future__ import annotations

import collections
import contextlib
import math
import os
import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "dilqr."  # a span's range in the profiler: the prefix, then its name
SPAN_LOG_LEN = 1 << 17  # the span log keeps the newest this many entries

_SPAN_LOG: collections.deque = collections.deque(maxlen=SPAN_LOG_LEN)
# a span's range: the profiler's direct range where torch has it, else
# record_function. Under a CPU-only session the direct range costs about a
# microsecond, where the dispatched record_function op took 5-90 us once the
# session held a thousand ops, its timestamps as far from a stamp taken
# inside it; under a CUDA session each costs some 20-27 us
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or _autograd_profiler.record_function


class _NoSpan:
    """A span with no profiler session active: nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """A span under a profiler session: its range, and its log entry
    stamped inside the range."""

    __slots__ = ("name", "_range", "_start")

    def __init__(self, name: str):
        self.name = name
        self._range = _RANGE(SPAN_PREFIX + name)

    def __enter__(self):
        self._range.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        _SPAN_LOG.append((self.name, self._start, time.time_ns()))
        return self._range.__exit__(*exc)


def span(name: str):
    """The span ``name`` around a block of the solve path: under an active
    torch.profiler session the range ``SPAN_PREFIX + name`` and an entry
    of ``span_log``; otherwise the one shared object that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def span_log() -> List[Tuple[str, int, int]]:
    """A copy of the span log: ``(name, start_ns, end_ns)`` in the order
    the spans ended (an inner span before the one around it)."""
    return list(_SPAN_LOG)


def span_totals() -> Dict[str, Tuple[int, float]]:
    """The span log summed by name: ``{name: (count, host ms)}``."""
    out: Dict[str, Tuple[int, float]] = {}
    for name, start, end in list(_SPAN_LOG):
        n, ms = out.get(name, (0, 0.0))
        out[name] = (n + 1, ms + (end - start) / 1e6)
    return out


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


PAD_S = 0.2  # host seconds between the priming burst and the block
WINDOW = "dilqr_tpu_torch profiled window"  # the range around the block
WINDOW_TRIES = 3  # windows opened while one records fewer launches than it holds


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _prime() -> None:
    """About 5 ms of device work and 64 small kernels, synchronized: what a
    trace drops at its start (see the module docstring)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda._sleep(10_000_000)
        v = torch.zeros(256, device="cuda")
        for _ in range(64):
            v.add_(1.0)
        torch.cuda.synchronize()


@contextlib.contextmanager
def profiled():
    """torch.profiler over the block (host, and the card where there is
    one), started with the priming burst and ``PAD_S`` of host time, the
    block in the range ``WINDOW`` and the device synchronized at its end
    (see the module docstring). Yields the profiler; read it after the
    block, its device activities with ``device_events``."""
    from torch.profiler import profile, record_function

    _sync()
    with profile(activities=_activities()) as prof:
        _prime()
        time.sleep(PAD_S)
        with record_function(WINDOW):
            yield prof
            _sync()


@contextlib.contextmanager
def trace(log_dir: str):
    """``profiled`` over the block, written to ``log_dir/trace.json`` as a
    chrome trace."""
    os.makedirs(log_dir, exist_ok=True)
    with profiled() as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timeit(fn: Callable, *args, n: int = 20, warmup: int = 1) -> float:
    """Pipelined steady-state wall seconds a call: submit n calls, then
    synchronize once (a synchronize after each call would measure the
    host's round trip to the card instead)."""
    for _ in range(max(warmup, 1)):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / n


def device_events(prof):
    """The device's own activities in a torch.profiler trace: kernels and
    copies, without the host operators and ranges the profiler also gives
    device time; in a ``profiled`` trace, those from the start of its
    ``WINDOW`` range on, less 0.9 ``PAD_S`` (the priming burst ended
    ``PAD_S`` before it; the device's timestamps, mapped onto the host's
    clock, were seen 6 ms off their launches)."""
    from torch.autograd import DeviceType

    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and e.name not in host_names]
    marks = [e.time_range.start for e in events
             if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if marks:
        start = min(marks) - 0.9 * PAD_S * 1e6  # microseconds
        device = [e for e in device if e.time_range.start >= start]
    return device


def busy_ms(device) -> float:
    """Milliseconds the device was busy: the union of the activities'
    intervals (``time_range`` in microseconds)."""
    busy, end = 0.0, -math.inf
    for s, t in sorted((e.time_range.start, e.time_range.end) for e in device):
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    return busy / 1e3


def kernel_ms(fn: Callable, name: str, calls: int = 20):
    """The mean device time of the launches of kernel ``name`` in ``calls``
    calls of fn (one launch each) under torch.profiler (the kernel alone,
    without host gaps), how many launches the trace recorded, and the names
    of the other device activities it recorded. A window that records fewer
    than ``calls`` launches is opened again, up to ``WINDOW_TRIES`` in all;
    if the last is short too, the time is NaN (not measured)."""
    fn()
    for _ in range(WINDOW_TRIES):
        with profiled() as prof:
            for _ in range(calls):
                fn()
        device = device_events(prof)
        runs = [e.time_range.end - e.time_range.start for e in device if name in e.name]
        if len(runs) >= calls:
            break
    others = sorted({e.name for e in device if name not in e.name})
    return (sum(runs) / len(runs) / 1e3 if len(runs) >= calls else math.nan), len(runs), others
