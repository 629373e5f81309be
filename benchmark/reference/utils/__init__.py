"""Frozen copies of bpt_tpu_torch modules (the benchmark's plain reference)."""
