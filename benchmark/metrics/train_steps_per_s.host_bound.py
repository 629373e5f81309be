"""``train_steps_per_s`` where the host bounds the step and its runs spread
too widely to be held end to end: Adam steps completed over the traced
window, under the profiler."""


def read(ctx):
    if ctx.trace is None:
        return None
    steps = sum(u.get("steps", 0) for u in ctx.units)
    return steps / ctx.window_s if steps else None
