"""Inverse-rendering parameter gradients (port of ``bpt_tpu.diff.gradients``).

The estimator is that of the integrator: every discrete sampling decision
is detached, so the gradient is that of the integrand along the fixed
sampled paths (biased at visibility silhouettes, unbiased for shading,
material, light and camera parameters).  Parameters are a flat dict of
tensors.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from bpt_tpu_torch.core.rng import blue_noise_table
from bpt_tpu_torch.integrator.config import IntegratorConfig
from bpt_tpu_torch.integrator.frame import trace_image


def make_render_loss(
    build_scene_and_camera: Callable,
    cfg: IntegratorConfig,
    height: int,
    width: int,
    frames=(1.0, 2.0, 3.0, 4.0),
    rand_vec2=(0.3, 0.7),
    target=None,
    blue_noise=None,
):
    """Build ``loss(params) -> scalar`` averaging several progressive frames
    through the wavefront ``trace_image`` (autograd reaches every tensor the
    scene and camera are built from).

    ``build_scene_and_camera(params) -> (scene, camera)``; the loss runs on
    the camera's device.  With ``target`` (H, W, 3) the loss is the MSE to
    it, without it the mean radiance.
    """
    bn = torch.as_tensor(blue_noise if blue_noise is not None else blue_noise_table(), dtype=torch.float32)
    rv = np.asarray(rand_vec2, np.float32)
    frames = tuple(float(f) for f in frames)

    def loss(params):
        scene, camera = build_scene_and_camera(params)
        device = camera.position.device
        bn_d = bn.to(device)
        acc = 0.0
        for f in frames:
            acc = acc + trace_image(scene, camera, cfg, width, height, f, rv, bn_d).color
        img = acc / len(frames)
        if target is None:
            return img.mean()
        return ((img - torch.as_tensor(target, dtype=img.dtype).to(device)) ** 2).mean()

    return loss


def value_and_param_grads(loss, params: dict):
    """(loss value, {name: gradient}) at ``params``, a dict of tensors.  A
    parameter the loss does not reach gets a zero gradient, as in JAX."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    value = loss(leaves)
    grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
    return value.detach(), {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(leaves.items(), grads)}


def finite_difference(loss, params: dict, eps: float = 1e-3) -> dict:
    """Central-difference gradient of ``loss`` over a dict of tensors, one
    element at a time: the validation oracle for the analytic estimators.
    Steps are taken in float64 and cast to each parameter's dtype."""
    grads = {}
    with torch.no_grad():
        for name, value in params.items():
            flat = value.detach().reshape(-1).to(torch.float64)
            g = torch.zeros_like(flat)
            for i in range(flat.numel()):
                f = []
                for step in (eps, -eps):
                    moved = flat.clone()
                    moved[i] += step
                    f.append(float(loss({**params, name: moved.to(value.dtype).reshape(value.shape)})))
                g[i] = (f[0] - f[1]) / (2 * eps)
            grads[name] = g.to(value.dtype).reshape(value.shape)
    return grads
