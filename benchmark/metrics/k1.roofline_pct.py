"""K1's share of its roofline (forward): the frozen bound of one launch at
the view counted (``benchmark.workcounts``) over the mean device time of
the K1 launches of that view's requests, in %."""


def read(ctx):
    if ctx.trace is None or "k1" not in ctx.work:
        return None
    spans = ctx.trace.request_spans(ctx.units, ctx.work["view"])
    ms, n = ctx.trace.device_launched_in("k1", spans)
    return 100.0 * ctx.work["k1"] / (ms / n) if n else None
