"""lqr_iters: the mean over the traced window's solves of the iterations the
solve reports (``SolveResult.n_iter``, the most any tile of the batch ran)."""

import torch


def read(ctx):
    its = ctx.outcome.n_iters
    if not its:
        return None
    return float(torch.stack([t.reshape(()) for t in its]).double().mean())
