# Frozen copy of bpt_tpu_torch/core/sampling.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.
"""Direction samplers and the tent reconstruction filter.

Port of ``bpt_tpu.core.sampling``.  The integrator draws its uniforms at
fixed sites and calls the ``*_from_uniforms`` forms; the ``random_*``
samplers draw their own from an ``RngState``.
"""

from __future__ import annotations

import torch

from benchmark.reference.core.rng import RngState, rng_next
from benchmark.reference.core.vecmath import mix, normalize, orthonormal_basis, safe_sqrt

TWO_PI = 6.28318530717958648


def random_sphere_direction(state: RngState) -> tuple[torch.Tensor, RngState]:
    """Uniform direction on the sphere; two draws."""
    u, state = rng_next(state)
    a, state = rng_next(state)
    up = u * 2.0 - 1.0
    over = safe_sqrt(1.0 - up * up)
    around = a * TWO_PI
    return normalize(torch.stack([torch.cos(around) * over, up, torch.sin(around) * over], dim=-1)), state


def cos_hemisphere_from_uniforms(nl: torch.Tensor, r_: torch.Tensor, p_: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere about nl from two pre-drawn uniforms."""
    r = torch.sqrt(r_)
    phi = p_ * TWO_PI
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = safe_sqrt(1.0 - x * x - y * y)
    u, v = orthonormal_basis(nl)
    return normalize(x[..., None] * u + y[..., None] * v + z[..., None] * nl)


def random_cos_weighted_hemisphere(nl: torch.Tensor, state: RngState) -> tuple[torch.Tensor, RngState]:
    """Cosine-weighted hemisphere about nl; two draws."""
    r_, state = rng_next(state)
    p_, state = rng_next(state)
    return cos_hemisphere_from_uniforms(nl, r_, p_), state


def lobe_exponent(roughness) -> torch.Tensor:
    """1 / (exp(mix(7, 0, sqrt(roughness))) + 1), float32, with the
    roughness clamped to [0, 1]: the power that maps a uniform to the lobe's
    cos(theta).  A host number becomes a 0-d tensor on the CPU.  sqrt(r) is
    a select around sqrt where r > 0 (the same values): at a roughness of 0
    the backward meets no infinite derivative, which 0 * inf would turn into
    a NaN gradient."""
    r = torch.clamp(torch.as_tensor(roughness, dtype=torch.float32), 0.0, 1.0)
    positive = r > 0.0
    root = torch.where(positive, torch.sqrt(torch.where(positive, r, torch.ones_like(r))), torch.zeros_like(r))
    return 1.0 / (torch.exp(mix(7.0, 0.0, root)) + 1.0)


def specular_lobe_from_uniforms(reflection_dir: torch.Tensor, roughness, c_: torch.Tensor,
                                p_: torch.Tensor) -> torch.Tensor:
    """Specular-lobe direction about reflection_dir from two pre-drawn
    uniforms: cos(theta) = c_ ** lobe_exponent(roughness), and the result
    normalize(mix(reflection_dir, lobe, roughness))."""
    dev = reflection_dir.device
    r = torch.clamp(torch.as_tensor(roughness, dtype=torch.float32), 0.0, 1.0).to(dev)
    cos_theta = torch.pow(c_, lobe_exponent(roughness).to(dev))
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = p_ * TWO_PI
    u, v = orthonormal_basis(reflection_dir)
    lobe = (u * (torch.cos(phi) * sin_theta)[..., None] + v * (torch.sin(phi) * sin_theta)[..., None]
            + reflection_dir * cos_theta[..., None])
    rough = r.expand(lobe.shape[:-1])[..., None]
    return normalize(mix(reflection_dir, lobe, rough))


def random_direction_in_specular_lobe(reflection_dir: torch.Tensor, roughness,
                                      state: RngState) -> tuple[torch.Tensor, RngState]:
    """The roughness lobe about reflection_dir; two draws."""
    c_, state = rng_next(state)
    p_, state = rng_next(state)
    return specular_lobe_from_uniforms(reflection_dir, roughness, c_, p_), state


def tent_filter(x: torch.Tensor) -> torch.Tensor:
    """Peter Shirley's tent filter in [-1, 1]."""
    lo = torch.sqrt(torch.clamp(2.0 * x, min=0.0)) - 1.0
    hi = 1.0 - torch.sqrt(torch.clamp(2.0 - 2.0 * x, min=0.0))
    return torch.where(x < 0.5, lo, hi)
