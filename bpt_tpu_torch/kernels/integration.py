"""Wiring the CUDA megakernel into the progressive renderer.

A ``ProgressiveRenderer`` runs its radiance pass through
``trace_image_fused``, so on a CUDA device it launches the kernel from
construction.  ``attach_cuda_path(renderer)``, the port of
``attach_pallas_path``, is kept for callers of the JAX package's API: it
checks that the renderer is on a CUDA device and that the kernel takes its
scene and config, and changes nothing.  Edge detection and the accumulation protocol stay in
plain PyTorch (``finish_frame``), so the renderer's behaviour — denoiser
alpha flags, motion resets — is unchanged up to float tolerance.
"""

from __future__ import annotations

from bpt_tpu_torch.integrator.radiance import check_supported
from bpt_tpu_torch.renderer import ProgressiveRenderer


def attach_cuda_path(renderer: ProgressiveRenderer) -> None:
    """Check that the renderer's radiance pass runs the CUDA kernel."""
    if renderer.device.type != "cuda":
        raise ValueError(f"attach_cuda_path needs a renderer on a CUDA device, not {renderer.device}")
    check_supported(renderer.scene, renderer.cfg)
