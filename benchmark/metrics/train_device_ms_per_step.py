"""The device's time an Adam step: the union of the device operations'
intervals over the whole window (the target renders, the steps, Adam),
recorded by CUPTI, over the steps of the jobs completed, in ms."""


def read(ctx):
    steps = sum(u.get("steps", 0) for u in ctx.units)
    return 1e3 * ctx.busy.seconds / steps if ctx.busy is not None and ctx.busy.seconds > 0 and steps else None
