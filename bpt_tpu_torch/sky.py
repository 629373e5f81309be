"""Preetham analytic physical sky (port of ``bpt_tpu.sky``).

Differentiable with respect to the view and the sun direction through
autograd.  The terms that depend on the sun alone (``sky_sun_terms``: the
sun intensity, the final gamma and the horizon blend) are computed once per
call; the CUDA kernel receives the same three floats, computed by the same
function on the device, and evaluates the per-direction part
(``csrc/sky.cuh``) with the operations of ``get_sky_color`` in their order.
Divisions by a host constant are written as products with its reciprocal:
that is what PyTorch computes on CUDA, stated here so that the CPU computes
it too.
"""

from __future__ import annotations

import numpy as np
import torch

from bpt_tpu_torch.core.vecmath import dot, mix, normalize

TURBIDITY = 0.5
RAYLEIGH_COEFFICIENT = 2.0
MIE_COEFFICIENT = 0.03
MIE_DIRECTIONAL_G = 0.76
THREE_OVER_SIXTEENPI = 0.05968310365946075
ONE_OVER_FOURPI = 0.07957747154594767
TOTAL_RAYLEIGH = np.array([5.804542996261093e-6, 1.3562911419845635e-5, 3.0265902468824876e-5], np.float32)
MIE_CONST = np.array([1.8399918514433978e14, 2.7798023919660528e14, 4.0790479543861094e14], np.float32)
RAYLEIGH_ZENITH_LENGTH = 8400.0
MIE_ZENITH_LENGTH = 1250.0
SUN_POWER = 200.0
SUN_ANGULAR_DIAMETER_COS = 0.9998
CUTOFF_ANGLE = 1.6110731556870734
STEEPNESS = 1.5
E_CONST = 2.71828182845904524
PI = 3.14159265358979323
NIGHT = np.array([0.0, 0.0003, 0.00075], np.float32)


def total_mie() -> np.ndarray:
    c = (0.2 * TURBIDITY) * 10e-18
    return (0.434 * c * MIE_CONST).astype(np.float32)


#: beta_R and beta_M at the eye (float32), and their sum: the per-channel
#: constants of the scattering terms, passed to the kernel as they are.
RAYLEIGH_AT_X = (TOTAL_RAYLEIGH * RAYLEIGH_COEFFICIENT).astype(np.float32)
MIE_AT_X = (total_mie() * MIE_COEFFICIENT).astype(np.float32)
EXTINCTION_SUM = (RAYLEIGH_AT_X + MIE_AT_X).astype(np.float32)


def rayleigh_phase(cos_theta):
    return THREE_OVER_SIXTEENPI * (1.0 + cos_theta * cos_theta)


def hg_phase(cos_theta, g):
    g2 = g * g
    denom = torch.pow(torch.clamp(1.0 - 2.0 * g * cos_theta + g2, min=0.0), 1.5)
    return ONE_OVER_FOURPI * (torch.reciprocal(torch.clamp(denom, min=1e-20)) * (1.0 - g2))


def sun_intensity(zenith_angle_cos):
    z = torch.clamp(zenith_angle_cos, -1.0, 1.0)
    return SUN_POWER * torch.clamp(
        1.0 - torch.pow(torch.full_like(z, E_CONST), -((CUTOFF_ANGLE - torch.acos(z)) * (1.0 / STEEPNESS))),
        min=0.0)


def sky_sun_terms(sun_direction: torch.Tensor):
    """(sun_e, gamma, blend), 0-d tensors that depend on the sun only: the
    sun's intensity, the exponent of the final power and the weight of the
    horizon mix."""
    cos_sun_up = sun_direction[..., 1]
    sun_e = sun_intensity(cos_sun_up)
    sunfade = 1.0 - torch.clamp(1.0 - torch.exp(sun_direction[..., 1] * (1.0 / 450000.0)), 0.0, 1.0)
    gamma = torch.reciprocal(1.2 + 1.2 * sunfade)
    blend = torch.clamp(torch.pow(1.0 - cos_sun_up, 5.0), 0.0, 1.0)
    return sun_e, gamma, blend


def _smoothstep(edge0: float, edge1: float, x):
    t = torch.clamp((x - edge0) * (1.0 / (edge1 - edge0)), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def get_sky_color(ray_dir: torch.Tensor, sun_direction: torch.Tensor) -> torch.Tensor:
    """The Preetham sky radiance toward ``ray_dir`` (..., 3) for the unit
    ``sun_direction`` (3,): (..., 3)."""
    dev, f32 = ray_dir.device, ray_dir.dtype
    view = normalize(ray_dir)
    sun = sun_direction.to(device=dev, dtype=f32)
    cos_view_sun = dot(view, sun.expand(view.shape))
    cos_up_view = view[..., 1]
    sun_e, gamma, blend = sky_sun_terms(sun)

    rayleigh_at_x = torch.as_tensor(RAYLEIGH_AT_X, device=dev)
    mie_at_x = torch.as_tensor(MIE_AT_X, device=dev)

    zenith_angle = torch.acos(torch.clamp(torch.clamp(cos_up_view, min=0.0), -1.0, 1.0))
    inverse = torch.reciprocal(
        torch.cos(zenith_angle)
        + 0.15 * torch.pow(torch.clamp(93.885 - zenith_angle * (180.0 / PI), min=1e-6), -1.253))
    rayleigh_opt = RAYLEIGH_ZENITH_LENGTH * inverse
    mie_opt = MIE_ZENITH_LENGTH * inverse
    fex = torch.exp(-(rayleigh_at_x * rayleigh_opt[..., None] + mie_at_x * mie_opt[..., None]))

    beta_r_theta = rayleigh_at_x * rayleigh_phase(cos_view_sun * 0.5 + 0.5)[..., None]
    beta_m_theta = mie_at_x * hg_phase(cos_view_sun, MIE_DIRECTIONAL_G)[..., None]
    ratio = (beta_r_theta + beta_m_theta) / torch.as_tensor(EXTINCTION_SUM, device=dev)
    lin = torch.pow(torch.clamp(sun_e * ratio * (1.0 - fex), min=0.0), 1.5)
    lin = lin * mix(1.0, torch.sqrt(torch.clamp(sun_e * ratio * fex, min=0.0)), blend)

    l0 = 0.1 * fex
    sundisk = _smoothstep(SUN_ANGULAR_DIAMETER_COS, SUN_ANGULAR_DIAMETER_COS + 0.00002, cos_view_sun)
    l0 = l0 + (sun_e * 19000.0 * fex) * sundisk[..., None]
    tex_color = (lin + l0) * 0.04 + torch.as_tensor(NIGHT, device=dev)
    return torch.pow(torch.clamp(tex_color, min=0.0), gamma)
