"""Adam steps completed over the window: the steps of every job the window
ran, whole, over the window extended to the last job's end."""


def read(ctx):
    steps = sum(u.get("steps", 0) for u in ctx.units)
    return steps / ctx.window_s if steps else None
