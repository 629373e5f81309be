"""Rays completed over the window, in millions a second: H * W * bounces
a frame (``bench.py``'s count), every frame of every request, over the
window extended to the last request's end."""


def read(ctx):
    rays = sum(u.get("rays", 0) for u in ctx.units if "latency_s" in u)
    return rays / ctx.window_s / 1e6 if rays else None
