"""off_kernel_ms: the mean host time of a closed-loop step less the
whole-solve kernel's device time per step, in ms: what the solver's host
path, the plant, the shift and the synchronize add to the kernel. The
kernel's time is scaled up by the launches the trace did not record."""

from benchmark.measure.trace import kernel_runs

KERNEL = "ilqr_fused_kernel"


def read(ctx):
    steps, tr = ctx.outcome.step_ms, ctx.outcome.trace
    if not steps or tr is None:
        return None
    runs = kernel_runs(tr, KERNEL, ctx.outcome.launches)
    if runs is None:
        return None
    kernel_ms = sum(d.end - d.start for d in runs) / 1e3 * (ctx.outcome.launches / len(runs))
    return sum(steps) / len(steps) - kernel_ms / len(steps)
