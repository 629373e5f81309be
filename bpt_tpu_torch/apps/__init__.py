"""Demo CLIs of the port (counterparts of the JAX package's ``apps/``):
``python -m bpt_tpu_torch.apps.<demo> --help``."""
