# Frozen copy of bpt_tpu_torch/scenes/cornell.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.
"""Cornell-box demo scene (port of ``bpt_tpu.scenes.cornell``).

Walls, the selectable quad light, and the two matrix-instanced spheres
(sphereRadius 16, wallRadius 50): the left one clearcoat yellow, the right
one of the caller's material.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.camera import Camera
from benchmark.reference.scenes.types import (
    CLEARCOAT_DIFFUSE,
    DIFFUSE,
    LIGHT,
    METAL,
    Scene,
    UnitSpheres,
    make_quad,
    quads_from_rows,
)
from benchmark.reference.utils.transforms import invert_rigid, trs_matrix

WALL_RADIUS = 50.0
SPHERE_RADIUS = 16.0


def quad_light_rows(plane_selection: int, light_radius: float, emission_scale: float = 10.0):
    """The 6-way selectable quad area light.

    plane_selection: 1 right wall, 2 left wall, 3 front opening, 4 back wall,
    5 floor, 6 ceiling (the demo default).
    """
    w = WALL_RADIUS
    r = light_radius * 0.2
    e = (emission_scale, emission_scale, emission_scale)
    table = {
        1: ((-1, 0, 0), (w - 1, -r, r), (w - 1, r, r), (w - 1, r, -r), (w - 1, -r, -r)),
        2: ((1, 0, 0), (-w + 1, -r, -r), (-w + 1, r, -r), (-w + 1, r, r), (-w + 1, -r, r)),
        3: ((0, 0, 1), (-r, -r, -w + 1), (r, -r, -w + 1), (r, r, -w + 1), (-r, r, -w + 1)),
        4: ((0, 0, -1), (-r, -r, w - 1), (-r, r, w - 1), (r, r, w - 1), (r, -r, w - 1)),
        5: ((0, 1, 0), (-r, -w + 1, -r), (-r, -w + 1, r), (r, -w + 1, r), (r, -w + 1, -r)),
        6: ((0, -1, 0), (-r, w - 1, -r), (r, w - 1, -r), (r, w - 1, r), (-r, w - 1, r)),
    }
    n, v0, v1, v2, v3 = table[int(plane_selection)]
    return make_quad(n, v0, v1, v2, v3, e, LIGHT)


def cornell_walls_rows():
    """The five diffuse walls."""
    w = WALL_RADIUS
    return [
        make_quad((0, 0, 1), (-w, w, w), (w, w, w), (w, -w, w), (-w, -w, w), (1, 1, 1), DIFFUSE),  # back
        make_quad((1, 0, 0), (-w, -w, w), (-w, -w, -w), (-w, w, -w), (-w, w, w), (0.7, 0.05, 0.05), DIFFUSE),  # left red
        make_quad((-1, 0, 0), (w, -w, -w), (w, -w, w), (w, w, w), (w, w, -w), (0.05, 0.05, 0.7), DIFFUSE),  # right blue
        make_quad((0, -1, 0), (-w, w, -w), (w, w, -w), (w, w, w), (-w, w, w), (1, 1, 1), DIFFUSE),  # ceiling
        make_quad((0, 1, 0), (-w, -w, w), (w, -w, w), (w, -w, -w), (-w, -w, -w), (1, 1, 1), DIFFUSE),  # floor
    ]


def cornell_scene(quad_light_plane: int = 6, quad_light_radius: float = 50.0,
                  right_sphere_mat: int = METAL, device=None) -> Scene:
    """Walls + selectable light + the two matrix-instanced spheres."""
    rows = cornell_walls_rows()
    rows.append(quad_light_rows(quad_light_plane, quad_light_radius))
    quads = quads_from_rows(rows, device=device)

    w, sr = WALL_RADIUS, SPHERE_RADIUS
    left_m = trs_matrix(translation=(-w * 0.45, -w + sr + 0.1, -w * 0.2), scale=(sr, sr, sr), device=device)
    right_m = trs_matrix(translation=(w * 0.45, -w + sr + 0.1, -w * 0.2), scale=(sr, sr, sr), device=device)
    spheres = UnitSpheres(
        inv_matrix=torch.stack([invert_rigid(left_m), invert_rigid(right_m)]),
        color=torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]], dtype=torch.float32, device=device),
        mat_type=torch.tensor(np.array([CLEARCOAT_DIFFUSE, right_sphere_mat], np.int32), device=device),
    )
    return Scene(quads=quads, spheres=spheres)


def cornell_camera(device=None) -> Camera:
    """Demo start camera: position (0, -20, -120), focus 113, aperture 0."""
    return Camera.look(
        position=(0.0, -20.0, -120.0),
        yaw=0.0,
        pitch=0.0,
        fov=0.8,
        aperture_size=0.0,
        focus_distance=113.0,
        device=device,
    )
