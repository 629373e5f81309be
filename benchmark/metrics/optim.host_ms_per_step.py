"""The optimiser loop's host time a step: the benchmark's spans around each
job's call (the target render and ``optimize``, which has no sync inside),
over the steps of those jobs, in ms."""


def read(ctx):
    seconds, jobs = ctx.spans.total("job")
    steps = sum(u.get("steps", 0) for u in ctx.units)
    return 1e3 * seconds / steps if jobs and steps else None
