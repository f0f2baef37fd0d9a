"""prepare_ms: the host ms a solve of the traced window spends in the
program's ``ilqr_fused.prepare`` span (``ops/cuda/ilqr_fused._launch`` up
to the kernel call: the geometry, the inputs' layouts, the output buffers,
the library's entry and the call's arguments). Nothing is read without the
program's spans, or where no solve launched the kernel."""

from benchmark.measure import program


def read(ctx):
    return program.host_ms(ctx, "ilqr_fused.prepare")
