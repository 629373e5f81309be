"""Transform helpers and profiling (port of ``bpt_tpu.utils``)."""
