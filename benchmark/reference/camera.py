# Frozen copy of bpt_tpu_torch/camera.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.
"""Camera model and primary-ray generation (tent AA + thin-lens DoF).

Port of ``bpt_tpu.camera``.  Babylon's left-handed Y-up frame; yaw/pitch in
YXZ order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.core.rng import RngState, rng_next
from benchmark.reference.core.sampling import TWO_PI, tent_filter
from benchmark.reference.core.vecmath import cross, normalize, safe_sqrt


class Camera(NamedTuple):
    """Pinhole + thin-lens camera; every field is a float32 tensor."""

    position: torch.Tensor  # (3,)
    right: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    forward: torch.Tensor  # (3,)
    fov: torch.Tensor  # vertical field of view, radians (scalar)
    aperture_size: torch.Tensor  # scalar, world units
    focus_distance: torch.Tensor  # scalar

    @staticmethod
    def look(position, yaw=0.0, pitch=0.0, fov=1.0471975512, aperture_size=0.0,
             focus_distance=100.0, device=None) -> "Camera":
        """Camera from Babylon-style yaw (rotation.y) and pitch (rotation.x)."""
        f32 = dict(dtype=torch.float32, device=device)
        yaw = torch.as_tensor(yaw, **f32)
        pitch = torch.as_tensor(pitch, **f32)
        cy, sy = torch.cos(yaw), torch.sin(yaw)
        cp, sp = torch.cos(pitch), torch.sin(pitch)
        forward = torch.stack([sy * cp, -sp, cy * cp])
        right = torch.stack([cy, torch.zeros_like(cy), -sy])
        up = cross(forward, right)  # LH: up = forward x right
        return Camera(
            position=torch.as_tensor(position, **f32),
            right=right,
            up=up,
            forward=forward,
            fov=torch.as_tensor(fov, **f32),
            aperture_size=torch.as_tensor(aperture_size, **f32),
            focus_distance=torch.as_tensor(focus_distance, **f32),
        )

    def world_matrix(self) -> torch.Tensor:
        """4x4 row-layout matrix [right; up; forward; position] (the
        reference's uCameraMatrix), used for the "camera moved?" test."""
        m = torch.zeros((4, 4), dtype=torch.float32, device=self.position.device)
        m[0, :3] = self.right
        m[1, :3] = self.up
        m[2, :3] = self.forward
        m[3, :3] = self.position
        m[3, 3] = 1.0
        return m

    def to(self, device) -> "Camera":
        return Camera(*(t.to(device) for t in self))


def film_extents(camera: Camera, width: int, height: int):
    """uVLen = tan(fov*0.5); uULen = uVLen * aspect."""
    vlen = torch.tan(camera.fov * 0.5)
    ulen = vlen * (width / height)
    return ulen, vlen


def generate_rays(camera: Camera, px: torch.Tensor, py: torch.Tensor, width: int, height: int,
                  rng: RngState) -> tuple[torch.Tensor, torch.Tensor, RngState]:
    """Primary rays for bottom-left-origin pixel coordinates (px, py).

    Consumes exactly 4 draws per pixel: tent-x, tent-y, aperture angle,
    aperture radius.
    """
    ulen, vlen = film_extents(camera, width, height)

    tx, rng = rng_next(rng)
    ty, rng = rng_next(rng)
    offset_x = tent_filter(tx)
    offset_y = tent_filter(ty)

    # Divide by device tensors: on CUDA, PyTorch divides by a host scalar
    # through its reciprocal, which is not the IEEE quotient the reference
    # and the kernel compute (it differs whenever the size is not a power of 2).
    w = torch.tensor(float(width), device=px.device)
    h = torch.tensor(float(height), device=py.device)
    ndc_x = ((px.to(torch.float32) + 0.5 + offset_x) / w) * 2.0 - 1.0
    ndc_y = ((py.to(torch.float32) + 0.5 + offset_y) / h) * 2.0 - 1.0

    ray_dir = normalize(
        ndc_x[..., None] * camera.right * ulen
        + ndc_y[..., None] * camera.up * vlen
        + camera.forward
    )

    ra, rng = rng_next(rng)
    rr, rng = rng_next(rng)
    angle = ra * TWO_PI
    radius = rr * camera.aperture_size
    aperture_offset = (
        torch.cos(angle)[..., None] * camera.right + torch.sin(angle)[..., None] * camera.up
    ) * safe_sqrt(radius)[..., None]
    focal_point = camera.focus_distance * ray_dir
    final_dir = normalize(focal_point - aperture_offset)

    ray_origin = camera.position + aperture_offset
    return ray_origin, final_dir, rng

