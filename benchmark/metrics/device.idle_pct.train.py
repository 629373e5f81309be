"""The device's idle share of the traced window in the train cells: the
window minus the union of the device operations' intervals, in %."""


def read(ctx):
    if ctx.trace is None or ctx.cell.mix["kind"] != "train":
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
