"""The 95th percentile of every request's latency, from its start to the
sync after its display, in ms (``statistics.quantiles``, inclusive)."""

import statistics


def read(ctx):
    lat = [u["latency_s"] for u in ctx.units if "latency_s" in u]
    if len(lat) < 2:
        return 1e3 * lat[0] if lat else None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
