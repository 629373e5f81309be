# Frozen copy of bpt_tpu_torch/lights.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.
"""Light samplers: the quad light, a sphere light and the sun lobe (port of
``bpt_tpu.lights``).  The integrator calls ``quad_light_from_uniforms``
with uniforms drawn at its fixed sites; the ``sample_*`` forms draw their
own from an ``RngState``."""

from __future__ import annotations

import torch

from benchmark.reference.core.rng import RngState, rng_next
from benchmark.reference.core.sampling import TWO_PI, random_direction_in_specular_lobe
from benchmark.reference.core.vecmath import dot, length, mix, normalize, orthonormal_basis, safe_sqrt


def quad_light_from_uniforms(x, nl, light_v0, light_v1, light_v2, light_v3, light_normal, rx, ry, rz):
    """NEE direction and weight toward a quad light from three uniforms.

    weight = clamp(2*(1-cos_a_max) * max(0,-dot(dir,lightN)) * max(0,dot(nl,dir)), 0, 1)
    with the point clamped to the [0.1, 0.9] margin of the quad.
    """
    rand_point = torch.stack(
        [
            mix(light_v0[..., 0], light_v2[..., 0], torch.clamp(rx, 0.1, 0.9)),
            mix(light_v0[..., 1], light_v2[..., 1], torch.clamp(ry, 0.1, 0.9)),
            mix(light_v0[..., 2], light_v2[..., 2], torch.clamp(rz, 0.1, 0.9)),
        ],
        dim=-1,
    )
    dir_to_light = rand_point - x
    r2 = length(light_v1 - light_v0) * length(light_v3 - light_v0)
    d2 = dot(dir_to_light, dir_to_light)
    cos_a_max = safe_sqrt(1.0 - torch.clamp(r2 / torch.clamp(d2, min=1e-20), 0.0, 1.0))
    dir_to_light = normalize(dir_to_light)
    dot_nl = torch.clamp(dot(nl, dir_to_light), min=0.0)
    weight = 2.0 * (1.0 - cos_a_max) * torch.clamp(-dot(dir_to_light, light_normal), min=0.0) * dot_nl
    return dir_to_light, torch.clamp(weight, 0.0, 1.0)


def sample_quad_light(x, nl, light_v0, light_v1, light_v2, light_v3, light_normal, rng: RngState):
    """``quad_light_from_uniforms`` of three draws: (dir, weight, rng)."""
    rx, rng = rng_next(rng)
    ry, rng = rng_next(rng)
    rz, rng = rng_next(rng)
    d, w = quad_light_from_uniforms(x, nl, light_v0, light_v1, light_v2, light_v3, light_normal, rx, ry, rz)
    return d, w, rng


def sample_sphere_light(x, nl, light_pos, light_radius, rng: RngState):
    """Cone sampling toward a spherical light: (dir, weight, rng), two
    draws.  sin(alpha) is shrunk by 0.75, the reference's shadow-ray
    robustness factor."""
    to_light = light_pos - x
    cos_alpha_max = torch.sqrt(torch.clamp(1.0 - torch.clamp(
        light_radius * light_radius / torch.clamp(dot(to_light, to_light), min=1e-20), 0.0, 1.0), min=0.0))
    rc, rng = rng_next(rng)
    rp, rng = rng_next(rng)
    cos_alpha = mix(cos_alpha_max, 1.0, rc)
    sin_alpha = safe_sqrt(1.0 - cos_alpha * cos_alpha) * 0.75
    phi = rp * TWO_PI
    dir_to_light = normalize(to_light)
    u, v = orthonormal_basis(dir_to_light)
    sample_dir = normalize(u * (torch.cos(phi) * sin_alpha)[..., None] + v * (torch.sin(phi) * sin_alpha)[..., None]
                           + dir_to_light * cos_alpha[..., None])
    weight = torch.clamp(2.0 * (1.0 - cos_alpha_max) * torch.clamp(dot(nl, sample_dir), min=0.0), 0.0, 1.0)
    return sample_dir, weight, rng


def sample_sun(nl, sun_direction, lobe_roughness: float, rng: RngState):
    """The sun-directed NEE lobe: (dir, max(0, dir . nl), rng), two draws;
    the caller applies its scene's weight."""
    d, rng = random_direction_in_specular_lobe(sun_direction.expand(nl.shape), lobe_roughness, rng)
    return d, torch.clamp(dot(d, nl), min=0.0), rng
