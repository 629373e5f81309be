"""Per-frame image tracing: ray-gen → radiance → edge detect → accumulate.

Port of ``bpt_tpu.integrator.frame``.  Image layout: (H, W) with row 0 at
the *bottom* (gl_FragCoord convention), so pixel ids and RNG seeds match a
bottom-left origin.
"""

from __future__ import annotations

import torch

from bpt_tpu_torch.camera import Camera, generate_rays
from bpt_tpu_torch.core.rng import blue_noise_fetch, rng_seed
from bpt_tpu_torch.core.vecmath import smoothstep
from bpt_tpu_torch.geometry.triangles import resolve_fast_quads
from bpt_tpu_torch.integrator.config import IntegratorConfig
from bpt_tpu_torch.integrator.radiance import RadianceResult, calculate_radiance
from bpt_tpu_torch.scenes.types import Scene


def pixel_grid(height: int, width: int, device=None, row_offset: int = 0):
    """Absolute integer pixel coords, (H, W) each, bottom-left origin: rows
    ``row_offset`` to ``row_offset + height`` of the film."""
    py, px = torch.meshgrid(
        torch.arange(row_offset, row_offset + height, device=device), torch.arange(width, device=device),
        indexing="ij",
    )
    return px, py


def _quad_dfdx(v: torch.Tensor) -> torch.Tensor:
    """GPU dFdx over 2x2 pixel quads (right - left of each horizontal pair)."""
    h, w = v.shape[0], v.shape[1]
    pairs = v.reshape((h, w // 2, 2) + tuple(v.shape[2:]))
    d = pairs[:, :, 1] - pairs[:, :, 0]
    return torch.repeat_interleave(d, 2, dim=1).reshape(v.shape)


def _quad_dfdy(v: torch.Tensor) -> torch.Tensor:
    """GPU dFdy over 2x2 pixel quads (top - bottom of each vertical pair)."""
    h = v.shape[0]
    pairs = v.reshape((h // 2, 2) + tuple(v.shape[1:]))
    d = pairs[:, 1] - pairs[:, 0]
    return torch.repeat_interleave(d[:, None], 2, dim=1).reshape(v.shape)


def _fwidth(v: torch.Tensor) -> torch.Tensor:
    return torch.abs(_quad_dfdx(v)) + torch.abs(_quad_dfdy(v))


def detect_edges(result: RadianceResult):
    """The three edge detectors: (normal, object, color) differences, (H, W)
    each.  Needs even H and W (2x2 pixel quads)."""
    fw_n = _fwidth(result.object_normal)
    normal_difference = (
        smoothstep(0.2, 0.6, fw_n[..., 0])
        + smoothstep(0.2, 0.6, fw_n[..., 1])
        + smoothstep(0.2, 0.6, fw_n[..., 2])
    )
    d_obj = (torch.abs(_quad_dfdx(result.object_id)) > 0.0).float() + (
        torch.abs(_quad_dfdy(result.object_id)) > 0.0
    ).float()
    object_difference = smoothstep(0.0, 0.5, d_obj)
    col_x = torch.linalg.vector_norm(_quad_dfdx(result.object_color), dim=-1)
    col_y = torch.linalg.vector_norm(_quad_dfdy(result.object_color), dim=-1)
    d_col = (col_x > 0.0).float() + (col_y > 0.0).float()
    color_difference = smoothstep(0.0, 0.5, d_col)
    return normal_difference, object_difference, color_difference


def trace_image(
    scene: Scene,
    camera: Camera,
    cfg: IntegratorConfig,
    width: int,
    height: int,
    frame_counter,
    rand_vec2,
    blue_noise: torch.Tensor,
    param_grads: bool = False,
    lane_counts: list | None = None,
    plain_walk: bool = False,
    fast_quads: bool | None = False,
    tile_rows: int | None = None,
    row_offset: int = 0,
):
    """Trace one 1-sample-per-pixel frame; returns the raw per-pixel result.

    ``width`` and ``height`` are the whole film's (they define the film
    plane).  A row tile, as the sharded renderer traces it, is ``tile_rows``
    rows starting at absolute row ``row_offset``: the RNG, the blue noise and
    the rays are keyed by absolute rows, so a tile equals the same rows of
    the whole frame.

    Runs on the device of ``blue_noise``; ``frame_counter`` is a host number
    and ``rand_vec2`` a host pair in [0, 1).  With ``param_grads=True`` it
    returns ``(result, sg, deferred)``, sg the (n_sg, H, W) path-replay
    planes and deferred the (n_def, H, W) deferred planes of
    ``calculate_radiance`` (which also explains ``lane_counts``).  A mesh is
    walked by the closest-hit kernel on the card unless ``plain_walk``.
    ``fast_quads=True`` tests the quads with the parallelogram test of the
    TPU kernel's fast path (every quad must be a parallelogram, else
    ValueError; None decides as the kernel's entry points do), the default
    with the two triangle fans of the wavefront.
    """
    fast_quads = resolve_fast_quads(scene.quads, fast_quads)
    rows = height if tile_rows is None else tile_rows
    if rows <= 0 or row_offset < 0 or row_offset + rows > height:
        raise ValueError(f"rows [{row_offset}, {row_offset + rows}) of a {width}x{height} film")
    px, py = pixel_grid(rows, width, blue_noise.device, row_offset)
    rng = rng_seed(frame_counter, px, py)
    bn = blue_noise_fetch(blue_noise, px, py, rand_vec2)
    ro, rd, rng = generate_rays(camera, px, py, width, height, rng)
    out = calculate_radiance(scene, cfg, ro, rd, rng, bn, frame_counter, param_grads=param_grads,
                             lane_counts=lane_counts, plain_walk=plain_walk, fast_quads=fast_quads)
    return (out[0], out[3], out[4]) if param_grads else out[0]


def render_frame(scene: Scene, camera: Camera, cfg: IntegratorConfig, previous: torch.Tensor,
                 frame_counter, camera_is_moving: bool, rand_vec2, blue_noise: torch.Tensor,
                 full_height: int | None = None, row_offset: int = 0) -> torch.Tensor:
    """One progressive step: previous (H,W,4) buffer -> new (H,W,4) buffer.

    ``previous`` may be a row tile of a ``full_height``-row film starting at
    absolute row ``row_offset`` (``trace_image``'s ``tile_rows``); its row
    count must be even, since the edge detector's 2x2 quads must not
    straddle tiles."""
    rows, width = previous.shape[0], previous.shape[1]
    height = rows if full_height is None else full_height
    result = trace_image(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
                         tile_rows=rows, row_offset=row_offset)
    return finish_frame(result, previous, frame_counter, camera_is_moving)


def finish_frame(result: RadianceResult, previous: torch.Tensor, frame_counter,
                 camera_is_moving: bool) -> torch.Tensor:
    """Edge detection + the accumulation protocol: history cleared when
    frame_counter == 1; while the camera moves old and new are halved and the
    alpha chain resets; alpha 1.01 is a sticky sharp edge, -1 provisional."""
    normal_diff, object_diff, color_diff = detect_edges(result)
    sharp = result.pixel_sharpness
    edge = (color_diff >= 1.0) | (normal_diff >= 1.0) | (object_diff >= 1.0)
    sharp = torch.where(edge, torch.full_like(sharp, 1.01), sharp)

    prev = torch.zeros_like(previous) if float(frame_counter) == 1.0 else previous
    if camera_is_moving:
        prev_rgb = prev[..., :3] * 0.5
        prev_a = torch.zeros_like(prev[..., 3])
        cur_rgb = result.color * 0.5
    else:
        prev_rgb, prev_a, cur_rgb = prev[..., :3], prev[..., 3], result.color

    cur_a = torch.zeros_like(sharp)
    cur_a = torch.where(sharp == 1.01, torch.full_like(cur_a, 1.01), cur_a)
    cur_a = torch.where(sharp == -1.0, torch.full_like(cur_a, -1.0), cur_a)
    cur_a = torch.where(prev_a == 1.01, torch.full_like(cur_a, 1.01), cur_a)  # sticky sharp
    cur_a = torch.where(prev_a == -1.0, torch.zeros_like(cur_a), cur_a)  # provisional clears
    return torch.cat([prev_rgb + cur_rgb, cur_a[..., None]], dim=-1)
