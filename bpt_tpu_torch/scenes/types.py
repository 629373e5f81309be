"""Material ids and scene containers (port of ``bpt_tpu.scenes.types``).

Containers are NamedTuples of tensors with the reference's field names.
Quads, unit spheres, the transformed-quadric set and the sun/sky
environment are ported; ``mesh`` stays ``None`` until its family is, and so
do the HDRI fields of ``Environment``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Material type ids (the reference's enum values).  Only the ids the Cornell
# family dispatches on are ported; the others arrive with their families.
LIGHT = 0
DIFFUSE = 1
TRANSPARENT = 2
METAL = 3
CLEARCOAT_DIFFUSE = 4


class Quads(NamedTuple):
    """Quad list; the light is one of these (``IntegratorConfig.light_index``)."""

    normal: torch.Tensor  # (N, 3)
    v0: torch.Tensor  # (N, 3)
    v1: torch.Tensor  # (N, 3)
    v2: torch.Tensor  # (N, 3)
    v3: torch.Tensor  # (N, 3)
    color: torch.Tensor  # (N, 3) — emission radiance for LIGHT-typed quads
    mat_type: torch.Tensor  # (N,) int32


class UnitSpheres(NamedTuple):
    """Unit spheres instanced by inverse object matrices."""

    inv_matrix: torch.Tensor  # (N, 4, 4)
    color: torch.Tensor  # (N, 3)
    mat_type: torch.Tensor  # (N,) int32


class Quadrics(NamedTuple):
    """The transformed-quadric-geometry shape set: one entry per shape in the
    fixed order of ``geometry.quadrics.UNIT_INTERSECTORS``; ``shape_k`` is
    the shared shape parameter (uShapeK)."""

    inv_matrix: torch.Tensor  # (12, 4, 4)
    shape_k: torch.Tensor  # 0-d
    color: torch.Tensor  # (12, 3)
    mat_type: torch.Tensor  # (12,) int32


class Environment(NamedTuple):
    """Sun / sky light parameters.  Which pieces are used is decided by the
    static IntegratorConfig.  The HDRI fields stay None until the HDRI
    family is ported."""

    sun_direction: torch.Tensor  # (3,) unit, pointing toward the sun
    sun_power: torch.Tensor  # 0-d (uSunPower)
    hdr_image: Optional[torch.Tensor] = None
    hdr_exposure: Optional[torch.Tensor] = None
    env_cdf: Optional[tuple] = None


class Scene(NamedTuple):
    """Everything the integrator needs."""

    quads: Optional[Quads] = None
    spheres: Optional[UnitSpheres] = None
    quadrics: Optional[Quadrics] = None
    mesh: None = None
    env: Optional[Environment] = None

    def to(self, device) -> "Scene":
        """Every family that is set, on ``device``; a host number in a
        0-d field (``shape_k``, ``sun_power``) becomes a float32 tensor."""
        if self.mesh is not None:
            raise NotImplementedError("scene.mesh is not ported yet")

        def field(t):
            if t is None:
                return t
            if isinstance(t, torch.Tensor):
                return t.to(device)
            return torch.tensor(t, dtype=torch.float32, device=device)

        def move(group):
            return None if group is None else type(group)(*(field(t) for t in group))

        return Scene(quads=move(self.quads), spheres=move(self.spheres), quadrics=move(self.quadrics),
                     env=move(self.env))


def make_quad(normal, v0, v1, v2, v3, color, mat_type):
    """Row constructor for numpy-side scene assembly."""
    return (
        np.asarray(normal, np.float32),
        np.asarray(v0, np.float32),
        np.asarray(v1, np.float32),
        np.asarray(v2, np.float32),
        np.asarray(v3, np.float32),
        np.asarray(color, np.float32),
        np.int32(mat_type),
    )


def quads_from_rows(rows, device=None) -> Quads:
    cols = list(zip(*rows))
    return Quads(*(torch.as_tensor(np.stack(c), device=device) for c in cols))
