"""The staged pool's boundaries a pool: the device time of the key
kernel's passes and of ``torch.sort``'s kernels between K2's phases, over
the pools traced (K2 launches / bounces), in ms."""


def read(ctx):
    if ctx.trace is None or not ctx.counters.get("k2"):
        return None
    pools = ctx.counters["k2"] / int(ctx.cell.spec["integrator"]["bounces"])
    key_ms, _ = ctx.trace.device("key")
    sort_ms, _ = ctx.trace.device("sort")
    return (key_ms + sort_ms) / pools
