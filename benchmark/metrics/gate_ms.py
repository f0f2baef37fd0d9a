"""gate_ms: the host ms a solve of the traced window spends in the
program's ``ilqr.gate`` span (``core/ilqr.ilqr_loop`` until ``use_kernel``
has chosen the kernel or the plain loop). Nothing is read without the
program's spans."""

from benchmark.measure import program


def read(ctx):
    return program.host_ms(ctx, "ilqr.gate")
