"""The path-replay VJP's device time a step: the device time of the
operations that autograd's backward thread launched (``_PathReplay``'s
backward, ``compose_deferred``'s and the texel gradient), over the steps
of the traced window, in ms."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms, n = ctx.trace.device_where(ctx.trace.off_main_thread)
    steps = sum(u.get("steps", 0) for u in ctx.units)
    return ms / steps if n and steps else None
