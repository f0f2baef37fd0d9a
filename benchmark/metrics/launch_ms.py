"""launch_ms: the host ms a solve of the traced window spends in the
program's ``ilqr_fused.launch`` span, the call into the kernel's library
alone. Nothing is read without the program's spans, or where no solve
launched the kernel."""

from benchmark.measure import program


def read(ctx):
    return program.host_ms(ctx, "ilqr_fused.launch")
