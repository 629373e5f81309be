# Frozen copy of bpt_tpu_torch/core/fresnel.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.
"""Exact dielectric Fresnel reflectance (port of ``bpt_tpu.core.fresnel``)."""

from __future__ import annotations

import torch

from benchmark.reference.core.vecmath import dot, safe_sqrt


def calc_fresnel_reflectance(ray_dir, n, etai: float, etat: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(Re, ratioIoR) with the inside/outside swap per lane and TIR -> Re = 1."""
    cosi = torch.clamp(dot(ray_dir, n), -1.0, 1.0)
    inside = cosi > 0.0
    ei = torch.where(inside, torch.full_like(cosi, etat), torch.full_like(cosi, etai))
    et = torch.where(inside, torch.full_like(cosi, etai), torch.full_like(cosi, etat))
    ratio_ior = ei / et
    sint = ratio_ior * safe_sqrt(1.0 - cosi * cosi)
    tir = sint >= 1.0
    cost = safe_sqrt(1.0 - sint * sint)
    cosi_a = torch.abs(cosi)
    rs = ((et * cosi_a) - (ei * cost)) / torch.clamp((et * cosi_a) + (ei * cost), min=1e-20)
    rp = ((ei * cosi_a) - (et * cost)) / torch.clamp((ei * cosi_a) + (et * cost), min=1e-20)
    re = torch.clamp((rs * rs + rp * rp) * 0.5, 0.0, 1.0)
    return torch.where(tir, torch.ones_like(re), re), ratio_ior
