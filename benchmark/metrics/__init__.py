"""One reader a metric: ``<metric name>.py`` holds ``read(ctx)``, the
metric's value from the run's context (``benchmark.harness.run``'s
``ctx``: ``setup_s``, ``window_s``, ``units``, ``spans``; in a traced run
``trace``, ``work`` and ``counters``; in an untraced run of a cell with an
end-to-end metric from the device trace ``busy``, a
``benchmark.tracing.Busy``), or None where the run holds nothing for it to
read."""
