"""The CUDA calls that block the host (``benchmark.program_spans.SYNC_CALLS``)
made inside the port's ``bpt.staged.batch`` spans, over the pools
(``bpt.staged.pool`` spans).

Read from ``benchmark.program_spans``' window with the port's spans on;
None outside a traced run or where the port has no spans."""

from benchmark.program_spans import program_trace


def read(ctx):
    trace = program_trace(ctx)
    if trace is None:
        return None
    return trace.per_unit("syncs", ("bpt.staged.batch",), "bpt.staged.pool")
