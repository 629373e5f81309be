"""The port's device rule: entry points run on the card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card, ``"cuda"``, and
    raises where torch sees no CUDA device (pass ``device="cpu"`` to run the
    plain PyTorch versions on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bpt_tpu_torch runs on the card by default; "
                           "pass device='cpu' to run its plain PyTorch version on the CPU")
    return torch.device("cuda")
