"""Transformed-quadric-geometry demo scene (port of
``bpt_tpu.scenes.quadric_geometry``).

The 12 floor-grid shapes (shapeRadius 10, wallRadius 50) in the order of
``geometry.quadrics.UNIT_INTERSECTORS``, with one shape parameter, one
material for all, the Cornell walls and the selectable quad light.
"""

from __future__ import annotations

import torch

from bpt_tpu_torch.camera import Camera
from bpt_tpu_torch.scenes.cornell import cornell_walls_rows, quad_light_rows
from bpt_tpu_torch.scenes.types import CLEARCOAT_DIFFUSE, Quadrics, Scene, quads_from_rows
from bpt_tpu_torch.utils.transforms import invert_rigid, trs_matrix

WALL_RADIUS = 50.0
SHAPE_RADIUS = 10.0


def _positions(w: float, s: float):
    """(x, y, z) of each shape, in UNIT_INTERSECTORS order."""
    base_y = -w + s + 0.01
    return [
        (-w * 0.75, base_y, -w * 0.75),  # sphere
        (w * 0.75, base_y, -w * 0.75),  # cylinder
        (-w * 0.25, base_y, 0.0),  # cone
        (w * 0.25, base_y, 0.0),  # paraboloid
        (-w * 0.25, base_y, -w * 0.75),  # hyperboloid
        (-w * 0.25, -w + 2.25 * s + 0.01, w * 0.75),  # capsule (taller)
        (w * 0.75, base_y, 0.0),  # flattened ring
        (w * 0.25, base_y, w * 0.75),  # box
        (-w * 0.75, base_y, 0.0),  # pyramid/frustum
        (w * 0.75, base_y, w * 0.75),  # disk
        (-w * 0.75, base_y, w * 0.75),  # rectangle
        (w * 0.25, base_y, -w * 0.75),  # torus
    ]


def quadric_geometry_scene(
    shape_k: float = 0.5,
    all_shapes_mat: int = CLEARCOAT_DIFFUSE,
    quad_light_plane: int = 6,
    quad_light_radius: float = 50.0,
    extra_rotation=(0.0, 0.0, 0.0),
    extra_translation=(0.0, 0.0, 0.0),
    extra_scale=(1.0, 1.0, 1.0),
    device=None,
) -> Scene:
    """All 12 shapes share ``shape_k`` and ``all_shapes_mat``, and the
    global rotation, translation and scale applied to every shape."""
    rows = cornell_walls_rows()
    rows.append(quad_light_rows(quad_light_plane, quad_light_radius))
    quads = quads_from_rows(rows, device=device)
    inv_ms = []
    for px, py, pz in _positions(WALL_RADIUS, SHAPE_RADIUS):
        m = trs_matrix(
            translation=(px + extra_translation[0], py + extra_translation[1], pz + extra_translation[2]),
            rotation=extra_rotation,
            scale=(SHAPE_RADIUS * extra_scale[0], SHAPE_RADIUS * extra_scale[1], SHAPE_RADIUS * extra_scale[2]),
            device=device,
        )
        inv_ms.append(invert_rigid(m))
    quadrics = Quadrics(
        inv_matrix=torch.stack(inv_ms),
        shape_k=torch.as_tensor(shape_k, dtype=torch.float32, device=device),
        color=torch.ones((12, 3), dtype=torch.float32, device=device),
        mat_type=torch.full((12,), int(all_shapes_mat), dtype=torch.int32, device=device),
    )
    return Scene(quads=quads, quadrics=quadrics)


def quadric_camera(device=None) -> Camera:
    """Demo start camera."""
    return Camera.look(position=(0.0, -20.0, -120.0), fov=0.8, aperture_size=0.0, focus_distance=113.0,
                       device=device)
