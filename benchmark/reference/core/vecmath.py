# Frozen copy of bpt_tpu_torch/core/vecmath.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.
"""Vector / matrix helpers over trailing-dim-3 tensors.

Port of ``bpt_tpu.core.vecmath``.  Dot products are written out component by
component so that the summation order is fixed ((x + y) + z) on every device
and matches the CUDA kernel; normalisation is ``v * (1 / sqrt(max(|v|², eps)))``
for the same reason.
"""

from __future__ import annotations

import torch

# Sentinel miss distance, the reference's `#define INFINITY 1000000.0`.
INFINITY = 1.0e6


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis: (..., 3) -> (...)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def safe_sqrt(x: torch.Tensor, floor: float = 1e-20) -> torch.Tensor:
    """sqrt with the input clamped to ``floor`` by a select (not a max)."""
    return torch.sqrt(torch.where(x > floor, x, torch.full_like(x, floor)))


def safe_inv(x: torch.Tensor, floor: float = 1e-12) -> torch.Tensor:
    """1/x with |x| clamped away from 0, sign preserved (0 counts as +)."""
    ax = torch.abs(x)
    sign = torch.sign(torch.where(x == 0.0, torch.ones_like(x), x))
    return sign / torch.where(ax > floor, ax, torch.full_like(ax, floor))


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """v / |v|, finite for |v| = 0 (masked lanes feed zero vectors)."""
    return v * (1.0 / torch.sqrt(torch.clamp(dot(v, v), min=eps)))[..., None]


def reflect(incident: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """GLSL reflect: I - 2*dot(N,I)*N."""
    return incident - (2.0 * dot(n, incident))[..., None] * n


def refract(incident: torch.Tensor, n: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """GLSL refract; 0 on total internal reflection.  eta: (...,) per lane.

    sqrt(max(k, 0)) is taken as a select around sqrt(k) where k > 0: the
    same values, but a lane at k = 0 (or a discarded one) sends no infinite
    derivative into the backward, where 0 * inf would make the whole
    gradient NaN."""
    eta = eta[..., None]
    cosi = dot(n, incident)[..., None]
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    positive = k > 0.0
    root = torch.where(positive, torch.sqrt(torch.where(positive, k, torch.ones_like(k))), torch.zeros_like(k))
    refr = eta * incident - (eta * cosi + root) * n
    return torch.where(k < 0.0, torch.zeros_like(refr), refr)


def _rows_times(m3: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(m3 @ p) for a (3, 3) matrix and (..., 3) vectors, sums in order."""
    return torch.stack(
        [m3[i, 0] * p[..., 0] + m3[i, 1] * p[..., 1] + m3[i, 2] * p[..., 2] for i in range(3)],
        dim=-1,
    )


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(m @ [p, 1]).xyz for one (4, 4) matrix."""
    return _rows_times(m[:3, :3], p) + m[:3, 3]


def transform_dir(m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(m @ [d, 0]).xyz for one (4, 4) matrix."""
    return _rows_times(m[:3, :3], d)


def normal_to_world(inv_m: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Object-space normal -> world via the transpose of the inverse matrix."""
    return normalize(_rows_times(inv_m[:3, :3].T, n))


def orthonormal_basis(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's cross-trick ONB:
    U = normalize(cross(|w.y| < 0.9 ? (0,1,0) : (1,0,0), w)); V = cross(w, U)."""
    up_y = (torch.abs(w[..., 1]) < 0.9)[..., None]
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
    helper = torch.where(up_y, ey, ex)
    u = normalize(cross(helper, w))
    v = cross(w, u)
    return u, v


def face_forward(n: torch.Tensor, ray_dir: torch.Tensor) -> torch.Tensor:
    """nl = dot(n, rayDirection) < 0 ? n : -n."""
    return torch.where((dot(n, ray_dir) < 0.0)[..., None], n, -n)


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def mix(a, b, t):
    """GLSL mix / lerp."""
    return a + (b - a) * t
