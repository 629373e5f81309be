"""K1's grads mode's share of its roofline: the frozen bound of one frame
with its path-replay planes over the device time of one launch, in %."""


def read(ctx):
    if ctx.trace is None or "k1_grad" not in ctx.work:
        return None
    ms, n = ctx.trace.device("k1_grad")
    return 100.0 * ctx.work["k1_grad"] / (ms / n) if n else None
