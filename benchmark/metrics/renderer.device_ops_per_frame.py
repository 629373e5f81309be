"""The device operations (kernels, copies, memsets) launched inside the
port's ``bpt.renderer.frame`` and ``bpt.renderer.display`` spans, over the
frames.

Read from ``benchmark.program_spans``' window with the port's spans on;
None outside a traced run or where the port has no spans."""

from benchmark.program_spans import program_trace


def read(ctx):
    trace = program_trace(ctx)
    if trace is None:
        return None
    return trace.per_unit("ops", ("bpt.renderer.frame", "bpt.renderer.display"), "bpt.renderer.frame")
