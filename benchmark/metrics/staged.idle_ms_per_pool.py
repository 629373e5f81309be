"""The device's idle time begun inside the port's ``bpt.staged.batch`` spans
(a staged pool and its frames' ``finish_frame``), over the pools
(``bpt.staged.pool`` spans), in ms.

Read from ``benchmark.program_spans``' window with the port's spans on;
None outside a traced run or where the port has no spans."""

from benchmark.program_spans import program_trace


def read(ctx):
    trace = program_trace(ctx)
    if trace is None:
        return None
    return trace.per_unit("idle_ms", ("bpt.staged.batch",), "bpt.staged.pool")
