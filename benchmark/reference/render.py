"""Sampled pixels of a progressive render, traced and displayed plainly.

The reference for the render cells.  A request's display at a pixel
depends on the accumulation of its 5x5 neighbourhood (the denoiser) and the
edge flags of their 2x2 quads, so the reference traces whole 8x8 patches at
even offsets and compares the display of each patch's inner 4x4 pixels.
The patches of all the frames of a check are traced as one batch of lanes
(each lane with its own frame counter, blue-noise offset and camera), then
replayed frame by frame through the renderer's accumulation protocol
(``finish_frame``) and ``screen_output`` on a strip of patches side by side:
8 is even, so no 2x2 quad and no inner pixel's neighbourhood crosses from
one patch into the next.

``lowp=True`` is the control: the reference with its radiance and its
accumulation held in bfloat16 (rounded after each frame), the precision
below the configuration's float32 that a change storing the render's
buffers in 16 bits would take.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from benchmark.reference.camera import Camera, generate_rays
from benchmark.reference.core.rng import BlueNoise, RngState, blue_noise_fetch, rng_seed
from benchmark.reference.geometry.triangles import resolve_fast_quads
from benchmark.reference.integrator.frame import finish_frame
from benchmark.reference.integrator.radiance import RadianceResult, calculate_radiance
from benchmark.reference.postprocess import screen_output

PATCH = 8
INNER = slice(2, 6)  # the pixels whose 5x5 neighbourhood lies inside their patch


class Frame(NamedTuple):
    """One frame of a request: its camera, frame and sample counters, blue
    noise offset and whether the camera moved."""

    camera: Camera
    frame_counter: float
    sample_counter: float
    rand_vec2: np.ndarray
    moving: bool


def next_counters(sample_counter: float, frame_counter: float, moving: bool) -> tuple[float, float]:
    """(frame_counter, sample_counter) of the next frame: the renderer's
    counter protocol (frozen copy of ``bpt_tpu_torch/renderer.py``
    ``next_counters`` at commit 930457f)."""
    was_still = sample_counter != 1.0
    frame = 1.0 if (moving and was_still) else frame_counter + 1.0
    return frame, 1.0 if moving else sample_counter + 1.0


def patch_pixels(origins: torch.Tensor, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(px, py) of the patches at the (P, 2) even (x, y) ``origins``, laid
    out patch by patch, row by row: (P * 64,) each."""
    r = torch.arange(PATCH, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    o = origins.to(device)
    px = (o[:, 0, None, None] + dx).reshape(-1)
    py = (o[:, 1, None, None] + dy).reshape(-1)
    return px, py


def strip(values: torch.Tensor, n_patches: int) -> torch.Tensor:
    """(P * 64, ...) patch-major values -> an (8, P * 8, ...) strip."""
    tail = tuple(values.shape[1:])
    return values.reshape((n_patches, PATCH, PATCH) + tail).transpose(0, 1).reshape((PATCH, n_patches * PATCH) + tail)


def inner(image: torch.Tensor, n_patches: int) -> torch.Tensor:
    """The inner 4x4 pixels of each patch of an (8, P * 8, C) strip: (P, 4, 4, C)."""
    return image.reshape(PATCH, n_patches, PATCH, -1).transpose(0, 1)[:, INNER, INNER]


def trace_lanes(scene, cfg, width: int, height: int, frames: Sequence[Frame], px, py, blue_noise: torch.Tensor,
                lane_counts: list | None = None) -> RadianceResult:
    """The radiance pass at pixels (px, py) for every frame, as one batch of
    lanes (frame-major): a RadianceResult of (F, n) planes.  The quad test
    is decided as the kernels decide it (``fast_quads=None``); the mesh walk
    is the plain one."""
    ro, rd, sx, sy, bns, fcs = [], [], [], [], [], []
    for f in frames:
        rng = rng_seed(f.frame_counter, px, py)
        bn = blue_noise_fetch(blue_noise, px, py, f.rand_vec2)
        o, d, rng = generate_rays(f.camera, px, py, width, height, rng)
        ro.append(o), rd.append(d), sx.append(rng.sx), sy.append(rng.sy), bns.append(bn)
        fcs.append(torch.full(px.shape, float(f.frame_counter), dtype=torch.float32, device=px.device))
    bn = BlueNoise(*(torch.cat([getattr(b, c) for b in bns]) for c in "rgba"), count=0)
    result = calculate_radiance(scene, cfg, torch.cat(ro), torch.cat(rd), RngState(torch.cat(sx), torch.cat(sy)), bn,
                                torch.cat(fcs), lane_counts=lane_counts, plain_walk=True,
                                fast_quads=resolve_fast_quads(scene.quads, None))[0]
    return RadianceResult(*(t.reshape((len(frames), px.shape[0]) + tuple(t.shape[1:])) for t in result))


def to_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and held as float32: the control's precision."""
    return t.to(torch.bfloat16).to(torch.float32)


def display_patches(scene, cfg, width: int, height: int, frames: Sequence[Frame], origins: torch.Tensor,
                    blue_noise: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    """The display after the last of ``frames`` at the inner 4x4 pixels of
    the 8x8 patches at ``origins``: (P, 4, 4, 3).  The accumulation starts
    from zeros, so the frames must reach back to the request's reset (or far
    enough that the halved history no longer shows)."""
    device = blue_noise.device
    n = origins.shape[0]
    px, py = patch_pixels(origins, device)
    traced = trace_lanes(scene, cfg, width, height, frames, px, py, blue_noise)
    accum = torch.zeros((PATCH, n * PATCH, 4), dtype=torch.float32, device=device)
    for i, f in enumerate(frames):
        result = RadianceResult(*(strip(t[i], n) for t in traced))
        if lowp:
            result = result._replace(color=to_bf16(result.color))
        accum = finish_frame(result, accum, f.frame_counter, f.moving)
        if lowp:
            accum = torch.cat([to_bf16(accum[..., :3]), accum[..., 3:]], dim=-1)
    inv_n = np.float32(1.0) / np.float32(max(frames[-1].sample_counter, 1.0))
    image = screen_output(accum, float(inv_n), 1.0, True)
    return inner(to_bf16(image) if lowp else image, n)
