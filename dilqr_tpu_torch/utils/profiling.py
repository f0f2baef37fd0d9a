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


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (host, and the card where there is
    one), written to ``log_dir/trace.json`` as a chrome trace."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        try:
            yield prof
        finally:
            _sync()
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
    device time."""
    from torch.autograd import DeviceType

    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name not in host_names]


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
    calls of fn under torch.profiler (the kernel alone, without host gaps),
    how many launches the trace recorded, and the names of the other device
    activities it recorded."""
    from torch.profiler import profile

    fn()
    _sync()
    with profile(activities=_activities()) as prof:
        for _ in range(calls):
            fn()
        _sync()
    device = device_events(prof)
    runs = [e.time_range.end - e.time_range.start for e in device if name in e.name]
    others = sorted({e.name for e in device if name not in e.name})
    return (sum(runs) / len(runs) / 1e3 if runs else math.nan), len(runs), others


def device_kernel_ms(fn: Callable, *args, n: int = 10, match: str = "ilqr") -> dict:
    """Device time a call from a torch.profiler trace of ``n`` pipelined
    calls: ``matched_ms`` (the activities whose name contains ``match``,
    e.g. a kernel), ``device_busy_ms`` (the union of all device
    activities) and ``top`` (the 5 device activities with the most time,
    by name). Host gaps and dispatch are left out, so matched_ms is the
    time a roofline share divides by."""
    from torch.profiler import profile

    fn(*args)
    _sync()
    with profile(activities=_activities()) as prof:
        for _ in range(n):
            fn(*args)
        _sync()
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
