"""The first steps of an inverse-rendering job, followed plainly.

The reference for the train cells: the target rendered from the true
parameters, then each step's render (the mean of the job's frames through
the plain wavefront ``trace_image``, autograd through every bounce), its
MSE to the target, the gradient, and Adam with the optimizer's constants
(betas 0.9 / 0.999, eps 1e-8 outside the square root) and the job's clip.
The loss is the mean over all pixels and frames, so the gradient is taken
frame by frame: the mean image first, then each frame's render again with
the weight 2 (mean - target) / n, which keeps one frame's graph alive at a
time.

A mesh's walks do not depend on the parameters these jobs optimise (a
light's colour, an albedo map): the path a lane takes is decided by the
geometry, the material classes and the random numbers alone (the port's
grads mode defers the albedo for that reason).  So within one follow the
walk is computed once per set of rays and reused whenever the same rays
come again (compared bit for bit), which makes the textured reference
seconds instead of minutes and changes no result.

``lowp=True`` is the control: images, loss, gradient, Adam's moments and
the parameters held in bfloat16 (rounded after each operation that makes
them).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

from benchmark.reference.accel import traverse
from benchmark.reference.integrator.frame import trace_image
from benchmark.reference.render import to_bf16

BETAS = (0.9, 0.999)
EPS = 1e-8


@contextlib.contextmanager
def walks_memoised():
    """``traverse_bvh`` answering a repeated set of rays from memory."""
    walk = traverse.traverse_bvh
    seen: list = []

    def memo(node_tri, node_right, node_min, node_max, p0, p1, p2, ro, rd, cull, *args, **kwargs):
        if kwargs.get("steps_out") is not None:
            return walk(node_tri, node_right, node_min, node_max, p0, p1, p2, ro, rd, cull, *args, **kwargs)
        active = kwargs.get("active")
        for key, out in seen:
            if (key[0].shape == ro.shape and key[3] == cull and torch.equal(key[0], ro) and torch.equal(key[1], rd)
                    and (key[2] is None) == (active is None) and (active is None or torch.equal(key[2], active))):
                return out
        out = walk(node_tri, node_right, node_min, node_max, p0, p1, p2, ro, rd, cull, *args, **kwargs)
        seen.append(((ro.detach().clone(), rd.detach().clone(), None if active is None else active.clone(), cull),
                     tuple(t.detach() for t in out)))
        return out

    traverse.traverse_bvh = memo
    try:
        yield
    finally:
        traverse.traverse_bvh = walk


def _mean_image(scene, camera, cfg, size, frames, rand_vec2, blue_noise, lowp: bool) -> torch.Tensor:
    acc = 0.0
    for f in frames:
        color = trace_image(scene, camera, cfg, size, size, f, rand_vec2, blue_noise, fast_quads=None).color
        acc = acc + (to_bf16(color) if lowp else color)
    out = acc / len(frames)
    return to_bf16(out) if lowp else out


def follow(scene, camera, cfg, size: int, frames: Sequence[float], rand_vec2, blue_noise: torch.Tensor,
           apply: Callable, true_params: dict, init_params: dict, lr: float, clip, steps: int = 3,
           lowp: bool = False) -> dict:
    """The job's first ``steps`` steps: ``{"losses": [...], "grad": {name:
    the first step's gradient}, "params": {name: the parameters step
    steps + 1 starts from}}``.  ``apply(scene, params)`` puts the parameters
    into the scene; ``clip`` is None or (low, high)."""
    rnd = to_bf16 if lowp else (lambda t: t)
    with walks_memoised():
        with torch.no_grad():
            target = _mean_image(apply(scene, true_params), camera, cfg, size, frames, rand_vec2, blue_noise, lowp)
        params = {k: rnd(torch.as_tensor(v, dtype=torch.float32, device=blue_noise.device).clone())
                  for k, v in init_params.items()}
        m = {k: torch.zeros_like(p) for k, p in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
        losses, first_grad = [], None
        for step in range(1, steps + 1):
            with torch.no_grad():
                mean = _mean_image(apply(scene, params), camera, cfg, size, frames, rand_vec2, blue_noise, lowp)
                diff = rnd(mean - target)
                losses.append(float(rnd(torch.mean(diff * diff))))
                weight = rnd(2.0 * diff / diff.numel() / len(frames))
            leaves = {k: p.detach().clone().requires_grad_(True) for k, p in params.items()}
            for f in frames:
                color = trace_image(apply(scene, leaves), camera, cfg, size, size, f, rand_vec2, blue_noise,
                                    fast_quads=None).color
                (rnd(color) * weight).sum().backward()
            grads = {k: rnd(p.grad) for k, p in leaves.items()}
            if first_grad is None:
                first_grad = grads
            with torch.no_grad():
                for k in params:
                    g = grads[k]
                    m[k] = rnd(BETAS[0] * m[k] + (1.0 - BETAS[0]) * g)
                    v[k] = rnd(BETAS[1] * v[k] + (1.0 - BETAS[1]) * g * g)
                    m_hat = m[k] / (1.0 - BETAS[0] ** step)
                    v_hat = v[k] / (1.0 - BETAS[1] ** step)
                    p = params[k] - lr * m_hat / (torch.sqrt(v_hat) + EPS)
                    params[k] = rnd(p if clip is None else torch.clamp(p, clip[0], clip[1]))
    return {"losses": losses, "grad": first_grad, "params": params}
