"""plain_share: the share of the process's solves that took the plain
PyTorch loop rather than the whole-solve kernel, in %: 100 PLAIN_SOLVES /
(PLAIN_SOLVES + LAUNCHES), the program's two counters
(``core.ilqr.PLAIN_SOLVES``, ``ops.cuda.ilqr_fused.LAUNCHES``) read after
the window, set-up included. A configuration that falls off the kernel
runs 5-10x slower. Nothing is read where the program keeps no such counter
or counted no solve."""


def read(ctx):
    try:
        from dilqr_tpu_torch.core import ilqr
        from dilqr_tpu_torch.ops.cuda import ilqr_fused
    except ImportError:
        return None
    plain = getattr(ilqr, "PLAIN_SOLVES", None)
    kernel = getattr(ilqr_fused, "LAUNCHES", None)
    if plain is None or kernel is None or plain + kernel == 0:
        return None
    return 100.0 * plain / (plain + kernel)
