"""The traced run's roofline bounds, from one plain frame of the reference.

The lane counts come from the benchmark's plain reference
(``benchmark.reference``: its wavefront with ``lane_counts``, its own SAH
tree for a mesh), one frame at the cell's size, so the bound stays the same
whatever implements the kernel.  ``benchmark.work.roofline`` turns them
into operations and bytes.  The train kinds' frame is the grads mode's, at
the base camera, the one view their jobs trace; the render kinds' is the
forward's at one view, the one the readers divide by the device time of
that view's requests, and the render kind's each pool's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import sides
from benchmark.reference.scenes.types import is_textured
from benchmark.work import roofline


def bounds(cell, view: int | None) -> dict:
    """{"k1" | "k1_grad": ms per launch, "k2_request": ms of K2's pools per
    request, "view": ``view``}: the least time the card could take, as the
    cell traces at ``view`` (an index of the mix's orbit views; None: the
    base camera)."""
    from benchmark.reference.camera import Camera
    from benchmark.reference.core.rng import blue_noise_table
    from benchmark.reference.integrator.config import IntegratorConfig
    from benchmark.reference.integrator.frame import trace_image

    spec, mix = cell.spec, cell.mix
    size = int(spec["size"])
    scene = cell.config.reference_scene(cell.inputs, cell.device)
    cfg = sides.integrator(IntegratorConfig, spec)
    bn = torch.as_tensor(blue_noise_table()).to(cell.device)
    if view is None:
        camera = sides.camera(Camera, spec["camera"])
    else:
        from benchmark.generator import orbit_views

        camera = sides.camera(Camera, spec["camera"], *orbit_views(spec, mix)[view])
    camera = camera.to(cell.device)
    grads = mix["kind"] == "train"
    lanes: list = []
    with torch.no_grad():
        out = trace_image(scene, camera, cfg, size, size, 2.0, np.array([0.3, 0.7], np.float32), bn,
                          param_grads=grads, lane_counts=lanes, plain_walk=True, fast_quads=None)
    n_quads = 0 if scene.quads is None else scene.quads.v0.shape[0]
    n_spheres = 0 if scene.spheres is None else scene.spheres.color.shape[0]
    textured = is_textured(scene.mesh)
    kw = dict(n_quads=n_quads, n_spheres=n_spheres, mesh=scene.mesh is not None, textured=textured)
    pixels = size * size
    if grads:
        _, sg, deferred = out
        flop, nbytes = roofline.kernel_work(lanes, pixels=pixels, deferred=textured, **kw)
        f2, b2 = roofline.grad_planes_work(sg, n_quads + n_spheres, deferred.shape[0], pixels)
        return {"k1_grad": roofline.bound(flop + f2, nbytes + b2)[0], "view": view}
    result = {"k1": roofline.bound(*roofline.kernel_work(lanes, pixels=pixels, **kw))[0], "view": view}
    if mix["kind"] == "render":  # the staged batch step's pools
        spp, batch = int(mix["spp"]), int(mix["batch"])
        pools, left = [], spp - 1  # the first sample is a single frame (K1)
        while left > 0:
            pools.append(min(batch, left))
            left -= pools[-1]
        result["k2_request"] = sum(
            roofline.bound(*roofline.staged_work(lanes, k, k * pixels, scale=k, pixels=pixels, **kw))[0]
            for k in pools)
    return result
