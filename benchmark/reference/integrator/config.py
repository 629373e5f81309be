# Frozen copy of bpt_tpu_torch/integrator/config.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.
"""Static integrator configuration.

A copy of ``bpt_tpu.integrator.config.IntegratorConfig``: the original is
pure Python, but importing it runs ``bpt_tpu/__init__.py``, which loads jax.
Field names, defaults and meanings are the reference's.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    #: Max path length; the reference uses 6 everywhere.
    bounces: int = 6
    #: Surface-offset epsilon, scene-size dependent (uEPS_intersect).
    eps_intersect: float = 0.01
    #: Environment on ray miss: "none" (Cornell/quadrics), "sky", "hdri".
    env: str = "none"
    #: Next-event-estimation target: "quad", "sun" or "env".
    nee: str = "quad"
    #: Which quad in scene.quads is the light; -1 = last.
    light_index: int = -1
    #: METAL bounce uses the roughness specular lobe instead of a mirror.
    metal_roughness_lobe: bool = False
    #: TRANSPARENT transmission tints by hitColor instead of Beer-Lambert.
    transparent_tint: bool = False
    #: Sun NEE lobe roughness: 0.1 (sky demo) or 0.03 (HDRI demo).
    sun_lobe_roughness: float = 0.1
    #: Sun NEE weight: "sky" = cos * 0.05; "hdri" = cos * sunPower^2 * 1e-7.
    sun_weight_mode: str = "sky"
    #: Diffuse 50/50 indirect-bounce gate: allow the cosine bounce while
    #: diffuseCount <= this.
    diffuse_indirect_max: int = 1
    #: Mirrors uCameraIsMoving inside TRANSPARENT's sharpness logic.
    camera_is_moving: bool = False
