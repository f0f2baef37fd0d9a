"""Profiling helpers (counterpart of ``dilqr_tpu/utils/profiling.py``):
torch.profiler traces, pipelined wall times, a throughput summary and the
device's own time read from a trace.

    with trace("/tmp/ilqr_trace"):
        run_solves()
    # -> /tmp/ilqr_trace/trace.json, for chrome://tracing or Perfetto

    report = throughput_report(fn, *args, batch=B, flops_per_example=...,
                               peak_flops=...)

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

import contextlib
import math
import os
import time
from typing import Any, Callable, Optional

import torch


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


def throughput_report(fn: Callable, *args, batch: int,
                      flops_per_example: Optional[float] = None,
                      peak_flops: Optional[float] = None, n: int = 20) -> dict:
    """Solves a second for a batched call; with a FLOP count per example
    the achieved FLOP/s, and with the device's peak FLOP/s (from its data
    sheet, for its dtype) the share of that peak. No peak, no share."""
    dt = timeit(fn, *args, n=n)
    rep: dict[str, Any] = {"wall_s_per_call": dt, "examples_per_s": batch / dt}
    if flops_per_example is not None:
        rep["achieved_flops"] = batch * flops_per_example / dt
        if peak_flops is not None:
            rep["peak_fraction"] = rep["achieved_flops"] / peak_flops
    return rep


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


def device_kernel_ms(fn: Callable, *args, n: int = 10, match: str = "ilqr") -> dict:
    """Device time a call from a torch.profiler trace of ``n`` pipelined
    calls: ``matched_ms`` (the activities whose name contains ``match``,
    e.g. a kernel), ``device_busy_ms`` (the union of all device
    activities) and ``top`` (the 5 device activities with the most time,
    by name). Host gaps and dispatch are left out, so matched_ms is the
    time a roofline share divides by."""
    fn(*args)
    with profiled() as prof:
        for _ in range(n):
            fn(*args)
    device = device_events(prof)
    durs: dict = {}
    for e in device:
        durs[e.name] = durs.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    matched = sum(v for k, v in durs.items() if match in k.lower())
    top = sorted(durs.items(), key=lambda kv: -kv[1])[:5]
    return {"matched_ms": matched / 1e3 / n, "device_busy_ms": busy_ms(device) / n,
            "top": [(k, v / 1e3 / n) for k, v in top]}


def ilqr_flops_per_example(T: int, nx: int, nu: int, lqr_iter: int,
                           ls_trials: int = 2) -> float:
    """Rough FLOP count of one iLQR solve per example (rollout, n-probe
    linearization, Riccati and line search), for roofline context."""
    n = nx + nu
    step = 8 * nx  # envs are a few dozen elementwise ops
    lin = n * 2 * step
    ric = 2 * (nx * n * nx + n * n * nx) + 4 * n * n
    obj = 2 * n * n
    trial = nu * nx * 2 + step + obj
    per_iter = T * (step + obj + lin + ric + ls_trials * trial)
    return float(lqr_iter * per_iter)
