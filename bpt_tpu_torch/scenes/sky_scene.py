"""Physical-sky (Preetham) demo scene (port of ``bpt_tpu.scenes.sky_scene``).

An open Cornell box (back, left and right walls and the floor; no ceiling
and no quad light) with the Cornell demo's two matrix-instanced spheres.
The sun is the only light; its direction is a Babylon TransformNode's
forward vector under two GUI rotations (default X = 298°, Y = 318°).
"""

from __future__ import annotations

import numpy as np
import torch

from bpt_tpu_torch.camera import Camera
from bpt_tpu_torch.scenes.cornell import SPHERE_RADIUS, WALL_RADIUS
from bpt_tpu_torch.scenes.types import (
    CLEARCOAT_DIFFUSE,
    DIFFUSE,
    METAL,
    Environment,
    Scene,
    UnitSpheres,
    make_quad,
    quads_from_rows,
)
from bpt_tpu_torch.utils.transforms import invert_rigid, trs_matrix


def sun_direction_from_rotation(rot_x_deg, rot_y_deg, device=None) -> torch.Tensor:
    """TransformNode.forward for rotation (x, y, 0) in YXZ order: the +Z
    axis rotated.  Differentiable in both angles: tensor angles keep their
    graph (and their device)."""
    rx = torch.deg2rad(torch.as_tensor(rot_x_deg, dtype=torch.float32, device=device))
    ry = torch.deg2rad(torch.as_tensor(rot_y_deg, dtype=torch.float32, device=device))
    cp, sp = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    return torch.stack([sy * cp, -sp, cy * cp])


def physical_sky_scene(sun_rot_x_deg=298.0, sun_rot_y_deg=318.0, right_sphere_mat: int = METAL,
                       device=None) -> Scene:
    """Open box + two spheres + the Preetham sun."""
    w = WALL_RADIUS
    rows = [
        make_quad((0, 0, 1), (-w, w, w), (w, w, w), (w, -w, w), (-w, -w, w), (1, 1, 1), DIFFUSE),
        make_quad((1, 0, 0), (-w, -w, w), (-w, -w, -w), (-w, w, -w), (-w, w, w), (0.7, 0.05, 0.05), DIFFUSE),
        make_quad((-1, 0, 0), (w, -w, -w), (w, -w, w), (w, w, w), (w, w, -w), (0.05, 0.05, 0.7), DIFFUSE),
        make_quad((0, 1, 0), (-w, -w, w), (w, -w, w), (w, -w, -w), (-w, -w, -w), (1, 1, 1), DIFFUSE),
    ]
    quads = quads_from_rows(rows, device=device)
    sr = SPHERE_RADIUS
    left_m = trs_matrix(translation=(-w * 0.45, -w + sr + 0.1, -w * 0.2), scale=(sr, sr, sr), device=device)
    right_m = trs_matrix(translation=(w * 0.45, -w + sr + 0.1, -w * 0.2), scale=(sr, sr, sr), device=device)
    spheres = UnitSpheres(
        inv_matrix=torch.stack([invert_rigid(left_m), invert_rigid(right_m)]),
        color=torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]], dtype=torch.float32, device=device),
        mat_type=torch.tensor(np.array([CLEARCOAT_DIFFUSE, right_sphere_mat], np.int32), device=device),
    )
    env = Environment(sun_direction=sun_direction_from_rotation(sun_rot_x_deg, sun_rot_y_deg, device),
                      sun_power=torch.tensor(1.0, dtype=torch.float32, device=device))
    return Scene(quads=quads, spheres=spheres, env=env)


def sky_camera(device=None) -> Camera:
    """Demo start camera."""
    return Camera.look(position=(0.0, -10.0, -200.0), fov=0.8, aperture_size=0.0, focus_distance=113.0,
                       device=device)
