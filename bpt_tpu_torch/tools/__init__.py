"""Measurement tools of the port: ``python -m bpt_tpu_torch.tools.<tool> --help``."""
