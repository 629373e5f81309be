"""Inverse rendering: optimize scene parameters to match a target image
(port of ``bpt_tpu.diff.inverse``).

The loop renders with matched RNG per step (the frame ids are shared with
the target), takes the MSE against the target and steps Adam
(``torch.optim.Adam`` with optax's defaults: betas 0.9 / 0.999, eps 1e-8
added outside the square root).  By default it runs on the card, through the
CUDA kernel's path-replay gradient.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from bpt_tpu_torch.core.rng import blue_noise_table
from bpt_tpu_torch.device import default_device
from bpt_tpu_torch.integrator.config import IntegratorConfig
from bpt_tpu_torch.integrator.frame import trace_image
from bpt_tpu_torch.kernels.megakernel import trace_frames_fused, trace_image_fused
from bpt_tpu_torch.utils.profiling import span

_RAND_VEC2 = np.array([0.3, 0.7], np.float32)


class OptimizeResult(NamedTuple):
    params: dict  # {name: detached tensor}
    losses: torch.Tensor  # (steps,)


def render_avg(scene, camera, cfg: IntegratorConfig, size: int, frames: Sequence[float], rand_vec2, blue_noise,
               fused: bool = True, reorder: bool = False) -> torch.Tensor:
    """Average of several 1-spp frames, (size, size, 3), on the camera's device:
    the render on both sides of the inverse-rendering loss.

    ``fused=True`` runs ``trace_image_fused(differentiable=True)``: the CUDA
    kernel and its path-replay VJP on a CUDA device (gradients of material
    and emission colors, the HDR map and its exposure, a textured mesh's
    albedo and emissive maps), its plain version on the CPU; a geometry or
    camera tensor that requires a gradient raises ``NotImplementedError``
    there.  ``fused=False`` is autograd through the wavefront ``trace_image``
    (every parameter; a mesh is walked by the closest-hit kernel on the card,
    with its recompute VJP).
    ``reorder=True`` (fused only) traces all the frames as one
    differentiable pool on the staged path (``trace_frames_fused``): the
    same average, and gradients equal to the unsorted route's up to the
    order of the backward's sums.
    """
    bn = torch.as_tensor(blue_noise, dtype=torch.float32).to(camera.position.device)
    if reorder:
        if not fused:
            raise ValueError("reorder=True is the fused route's staged pool; the wavefront route has none")
        colors = trace_frames_fused(scene, camera, cfg, size, size, list(frames), [rand_vec2] * len(frames), bn,
                                    differentiable=True).color.unbind(0)
    elif fused:
        colors = (trace_image_fused(scene, camera, cfg, size, size, f, rand_vec2, bn, differentiable=True).color
                  for f in frames)
    else:
        colors = (trace_image(scene, camera, cfg, size, size, f, rand_vec2, bn).color for f in frames)
    acc = 0.0
    for color in colors:
        acc = acc + color
    return acc / len(frames)


def optimize(
    build_scene: Callable[[dict], tuple],
    init_params: dict,
    target,
    cfg: IntegratorConfig,
    size: int,
    steps: int = 50,
    lr: float = 2e-2,
    frames: Sequence[float] = (1.0, 2.0),
    param_clip=None,
    fused: bool = True,
    reorder: bool = False,
    device=None,
) -> OptimizeResult:
    """Adam loop: params -> scene -> render -> MSE(target).

    ``build_scene(params) -> (scene, camera)``; the scene and camera are moved
    to ``device`` (None means ``"cuda"``, and raises without a card), as are
    the parameters and the target.  A mesh built on the device keeps its
    kernel tables from step to step (``Scene.to`` keeps resident tables), so
    a ``build_scene`` that swaps maps or colors into a resident scene
    (``mesh._replace(albedo=params["albedo"])``) moves nothing per step.  ``param_clip(params) -> params``
    optionally maps the parameters back to a valid domain after each step
    (applied in place, without gradient).  ``losses`` holds each step's loss
    before its update.  ``reorder=True`` renders on the staged path
    (``render_avg``).
    """
    device = default_device(device)
    bn = torch.as_tensor(blue_noise_table()).to(device)
    target = torch.as_tensor(target, dtype=torch.float32).to(device)
    params = {k: torch.as_tensor(v, dtype=torch.float32).to(device).detach().clone().requires_grad_(True)
              for k, v in init_params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(steps):
        with span("bpt.optim.step"):
            opt.zero_grad(set_to_none=True)
            with span("bpt.optim.forward"):
                scene, camera = build_scene(params)
                img = render_avg(scene.to(device), camera.to(device), cfg, size, frames, _RAND_VEC2, bn, fused=fused,
                                 reorder=reorder)
                loss = torch.mean((img - target) ** 2)
            with span("bpt.optim.backward"):
                loss.backward()
            with span("bpt.optim.update"):
                opt.step()
                if param_clip is not None:
                    with torch.no_grad():
                        clipped = param_clip(params)
                        for k, p in params.items():
                            p.copy_(clipped[k])
            losses.append(loss.detach())
    return OptimizeResult(params={k: p.detach() for k, p in params.items()}, losses=torch.stack(losses))
