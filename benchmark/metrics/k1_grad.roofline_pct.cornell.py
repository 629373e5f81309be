"""``k1_grad.roofline_pct`` in a cell whose end-to-end step metric is the
device's time a step: the same reading."""

from benchmark.harness import metric_reader


def read(ctx):
    return metric_reader("k1_grad.roofline_pct").read(ctx)
