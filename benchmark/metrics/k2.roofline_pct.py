"""K2's share of its roofline: the frozen bound of a request's pools
(``staged_work`` of each pool) at the view counted, times that view's
requests traced, over the device time of their K2 phases, in %."""


def read(ctx):
    if ctx.trace is None or "k2_request" not in ctx.work:
        return None
    spans = ctx.trace.request_spans(ctx.units, ctx.work["view"])
    ms, n = ctx.trace.device_launched_in("k2", spans)
    return 100.0 * ctx.work["k2_request"] * len(spans) / ms if n else None
