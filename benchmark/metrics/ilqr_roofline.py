"""ilqr_roofline: the whole-solve kernel's share of its roofline, in %: the
least time of one solve (``work/ilqr.py``: the larger of its operations over
the float32 peak and its bytes over the memory rate, the operations from the
iterations each example needs by the reference's own stopping rule on the
sampled solves' inputs) over the kernel's mean device time per launch in the
traced window. Nothing is read where the trace does not hold the launches
the program counted (``measure.trace.kernel_runs``)."""

from benchmark.measure.trace import kernel_runs

KERNEL = "ilqr_fused_kernel"


def read(ctx):
    if ctx.outcome.trace is None or ctx.least_s is None:
        return None
    runs = kernel_runs(ctx.outcome.trace, KERNEL, ctx.outcome.launches)
    if runs is None:
        return None
    mean_s = sum(d.end - d.start for d in runs) / len(runs) / 1e6
    return 100.0 * ctx.least_s / mean_s
