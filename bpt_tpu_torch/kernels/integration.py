"""Wiring the CUDA kernels into the progressive renderer.

A ``ProgressiveRenderer`` runs its radiance pass through
``trace_image_fused``, so on a CUDA device it launches the megakernel from
construction.  ``attach_cuda_path(renderer, reorder, fast_quads)``, the
port of ``attach_pallas_path``, checks that the renderer is on a CUDA
device and that the kernel takes its scene and config, and decides the
parallelogram quad test for the scene once; with ``reorder=True`` it also
installs ``staged_batch_step`` as the renderer's ``batch_step``, so that
``render(spp, batch)`` traces each batch of k frames as one staged pool
(``trace_frames_fused``), and an attach with ``reorder=False`` removes it.
Edge detection and the accumulation protocol stay in plain PyTorch
(``finish_frame``, replayed per frame in order), so the renderer's
behaviour — denoiser alpha flags, motion resets — is unchanged bit for bit.
"""

from __future__ import annotations

from bpt_tpu_torch.geometry.triangles import resolve_fast_quads
from bpt_tpu_torch.integrator.frame import finish_frame
from bpt_tpu_torch.integrator.radiance import RadianceResult, check_supported
from bpt_tpu_torch.kernels.megakernel import trace_frames_fused
from bpt_tpu_torch.renderer import ProgressiveRenderer, RenderState
from bpt_tpu_torch.utils.profiling import span, spanned


def staged_batch_step(renderer: ProgressiveRenderer):
    """The renderer's batch step on the staged path, the port of
    ``multi_frame_scan``: k still-camera frames (counters frame_counter + 1
    .. + k) traced as one pool, then ``finish_frame`` for each in order."""
    height, width = renderer.height, renderer.width

    @spanned("bpt.staged.batch")
    def step(scene, camera, cfg, state: RenderState, rand_vec2s, blue_noise) -> RenderState:
        k = len(rand_vec2s)
        counters = [state.frame_counter + 1.0 + i for i in range(k)]
        pool = trace_frames_fused(scene, camera, cfg, width, height, counters, list(rand_vec2s), blue_noise,
                                  fast_quads=renderer.fast_quads)
        accum = state.accum
        for i, frame_counter in enumerate(counters):
            with span("bpt.renderer.finish"):
                accum = finish_frame(RadianceResult(*(t[i] for t in pool)), accum, frame_counter, False)
        return RenderState(accum=accum, sample_counter=state.sample_counter + k, frame_counter=counters[-1])

    return step


def attach_cuda_path(renderer: ProgressiveRenderer, reorder: bool = False, fast_quads: bool | None = None) -> None:
    """Check that the renderer's radiance pass runs the CUDA kernel; with
    ``reorder=True`` route its batched samples through the staged pool, with
    ``reorder=False`` step them one frame at a time again.

    ``fast_quads`` (None: every quad of the renderer's scene is a
    parallelogram; True demands it, ValueError otherwise; False: the two
    triangle fans) is decided here, once, as JAX's attach decides it, and
    every later frame takes it: a scene swapped in later whose quads are
    not parallelograms then raises ValueError instead of tracing wrong quad
    hits."""
    if renderer.device.type != "cuda":
        raise ValueError(f"attach_cuda_path needs a renderer on a CUDA device, not {renderer.device}")
    check_supported(renderer.scene, renderer.cfg)
    renderer.fast_quads = resolve_fast_quads(renderer.scene.quads, fast_quads)
    renderer.batch_step = staged_batch_step(renderer) if reorder else None
