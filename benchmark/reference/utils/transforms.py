# Frozen copy of bpt_tpu_torch/utils/transforms.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.
"""TRS transform composition (port of ``bpt_tpu.utils.transforms``).

Babylon composes world = S * R * T in row-vector convention; in column-vector
convention that is M = T @ R @ S with rotation order YXZ.  Matrices are
built in float32 like the reference's.
"""

from __future__ import annotations

import torch


def _rot_x(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([o, z, z]), torch.stack([z, c, -s]), torch.stack([z, s, c])])


def _rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]), torch.stack([-s, z, c])])


def _rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([c, -s, z]), torch.stack([s, c, z]), torch.stack([z, z, o])])


def trs_matrix(translation=(0.0, 0.0, 0.0), rotation=(0.0, 0.0, 0.0), scale=(1.0, 1.0, 1.0),
               device=None) -> torch.Tensor:
    """World matrix for Babylon-style (position, rotation-YXZ, scaling)."""
    f32 = dict(dtype=torch.float32, device=device)
    t = torch.as_tensor(translation, **f32)
    rx, ry, rz = (torch.as_tensor(r, **f32) for r in rotation)
    s = torch.as_tensor(scale, **f32)
    r3 = _rot_y(ry) @ _rot_x(rx) @ _rot_z(rz)
    m = torch.eye(4, **f32)
    m[:3, :3] = r3 * s[None, :]
    m[:3, 3] = t
    return m


def invert_rigid(m: torch.Tensor) -> torch.Tensor:
    """General 4x4 inverse (named for its typical use on TRS matrices)."""
    return torch.linalg.inv(m)


def compose(*ms: torch.Tensor) -> torch.Tensor:
    """ms[0] @ ms[1] @ ... in order."""
    out = ms[0]
    for m in ms[1:]:
        out = out @ m
    return out
