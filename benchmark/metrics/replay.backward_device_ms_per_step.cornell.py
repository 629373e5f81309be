"""``replay.backward_device_ms_per_step`` in a cell whose end-to-end step
metric is the device's time a step: the same reading."""

from benchmark.harness import metric_reader


def read(ctx):
    return metric_reader("replay.backward_device_ms_per_step").read(ctx)
