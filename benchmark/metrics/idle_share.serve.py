"""idle_share.serve: the share of the traced window in which no operation
ran on the card, in %: 100 (1 - busy / window), busy the union of the device
activities' intervals."""


def read(ctx):
    tr = ctx.outcome.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / tr.window_s)
