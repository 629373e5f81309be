"""Triangle, quad and box intersectors (port of
``bpt_tpu.geometry.triangles``): Möller–Trumbore with the inverse
determinant first and the backface cull by the determinant's sign, the
AABB slab test; and the parallelogram test of the TPU kernel's
``fast_quads`` path (``bpt_tpu.kernels.megakernel``), one plane
intersection and a dual-basis inside test, with its per-quad algebra made
once per quad geometry (``parallelogram_constants``)."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from bpt_tpu_torch.core.vecmath import INFINITY, cross, dot, safe_inv


def _mt_core(v0, v1, v2, ro, rd, double_sided):
    edge1 = v1 - v0
    edge2 = v2 - v0
    pvec = cross(rd, edge2)
    raw_det = dot(edge1, pvec)
    det = safe_inv(raw_det)
    tvec = ro - v0
    u = dot(tvec, pvec) * det
    qvec = cross(tvec, edge1)
    v = dot(rd, qvec) * det
    t = dot(edge2, qvec) * det
    miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0) | (t <= 0.0)
    if not double_sided:
        miss = miss | (raw_det < 0.0)
    miss = miss | torch.isnan(t)
    return torch.where(miss, torch.full_like(t, INFINITY), t), u, v


def triangle_intersect(v0, v1, v2, ro, rd, double_sided: bool = False):
    """Möller–Trumbore; returns t (INFINITY on miss)."""
    t, _, _ = _mt_core(v0, v1, v2, ro, rd, double_sided)
    return t


def bvh_triangle_intersect(v0, v1, v2, ro, rd, double_sided: bool = False):
    """Möller–Trumbore with the barycentric (u, v) for attribute lerps:
    (t, u, v); single-sided culls det < 0."""
    return _mt_core(v0, v1, v2, ro, rd, double_sided)


def bounding_box_intersect(min_corner, max_corner, ro, inv_dir):
    """AABB slab test: the entry t0, or INFINITY where the box is missed or
    lies behind the ray (max(t0, 0) > t1).  t0 is negative for an origin
    inside the box, which must still open it."""
    near = (min_corner - ro) * inv_dir
    far = (max_corner - ro) * inv_dir
    t0 = torch.minimum(near, far).amax(-1)
    t1 = torch.maximum(near, far).amin(-1)
    return torch.where(torch.clamp(t0, min=0.0) > t1, torch.full_like(t0, INFINITY), t0)


def quad_intersect(v0, v1, v2, v3, ro, rd, double_sided: bool = False):
    """min of the two triangle fans (v0,v1,v2) and (v0,v2,v3)."""
    t_a = triangle_intersect(v0, v1, v2, ro, rd, double_sided)
    t_b = triangle_intersect(v0, v2, v3, ro, rd, double_sided)
    return torch.minimum(t_a, t_b)


# ---------------------------------------------------------------------------
# the parallelogram test
# ---------------------------------------------------------------------------

#: Columns of a ``parallelogram_constants`` row: the plane normal e1 x e3
#: and c0 = v0 . ng, the dual basis vectors d1 = e3 x ng and d3 = ng x e1
#: with their guarded inverse lengths k1 = 1 / (e1 . d1), k3 = 1 / (e3 . d3),
#: and v0.  The kernel's quad row starts with the same 15 floats
#: (``kernels/launch_args.py`` pack_scene, ``csrc/path.cuh``).
PARALLELOGRAM_COLUMNS = {"ng": 0, "c0": 3, "d1": 4, "k1": 7, "d3": 8, "k3": 11, "v0": 12}

#: Entries of ``cached_on``'s cache, the least recently used dropped first.
#: A scene takes up to 5 (the decision, the test's rows, the kernel's quad
#: rows and two material columns), so a caller that cycles through more
#: than 12 scenes misses on every launch.
_CACHE: OrderedDict = OrderedDict()
_CACHE_SIZE = 64


def _version(t: torch.Tensor) -> int | None:
    """``t``'s in-place version, the one key of the port's table caches
    (this module's, ``scenes.types.resident_tables``,
    ``kernels.launch_args.texel_table_of``); None for a tensor that keeps
    no version counter, one made under ``torch.inference_mode``.  Such a
    tensor can still be edited in place inside inference mode, unseen, so
    a result made from it must never be served again."""
    try:
        return t._version
    except RuntimeError:
        return None


def cached_on(tensors: tuple, tag: str, make):
    """``make()``, made once per set of tensor objects (and their in-place
    edits) and ``tag``, kept while it is among the ``_CACHE_SIZE`` most
    recently used.  The cache holds the tensors themselves: an ``id``
    alone can be reused by another object once the first is freed.  Made
    anew on every call, and not kept, where a tensor has no version
    (``_version``).  A result made under ``torch.inference_mode`` is an
    inference tensor, which autograd cannot save: it is served only inside
    inference mode."""
    versions = tuple(_version(t) for t in tensors)
    if None in versions:
        return make()
    key = (tag, torch.is_inference_mode_enabled()) + tuple(zip(map(id, tensors), versions))
    hit = _CACHE.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], tensors)):
        _CACHE.move_to_end(key)
        return hit[1]
    value = make()
    _CACHE[key] = (tensors, value)
    if len(_CACHE) > _CACHE_SIZE:
        _CACHE.popitem(last=False)
    return value


def _requires_grad(quads) -> bool:
    return any(t.requires_grad for t in (quads.v0, quads.v1, quads.v2, quads.v3))


def all_parallelograms(quads) -> bool:
    """Whether every quad is a parallelogram, v2 - v1 == v3 - v0 within
    ``np.allclose(..., atol=1e-5)``: the port's copy of the TPU kernel's
    ``_all_parallelograms``, which gates the parallelogram test.  False
    without quads and, as JAX's check is for traced vertices, for vertices
    that require a gradient.  Made once per quad geometry (one copy to the
    host for a CUDA scene, not one per launch)."""
    if quads is None or _requires_grad(quads):
        return False

    def decide():
        v0, v1, v2, v3 = (t.detach().cpu().numpy() for t in (quads.v0, quads.v1, quads.v2, quads.v3))
        return bool(np.allclose(v2 - v1, v3 - v0, atol=1e-5))

    return cached_on((quads.v0, quads.v1, quads.v2, quads.v3), "parallelograms", decide)


def resolve_fast_quads(quads, fast_quads: bool | None) -> bool:
    """The parallelogram test's switch for ``quads``, as the TPU kernel's
    entry points decide it: None turns it on exactly when every quad is a
    parallelogram; True on quads that are not raises ValueError (the test
    would return wrong hits); False keeps the two triangle fans."""
    if fast_quads is None:
        return all_parallelograms(quads)
    if fast_quads and not all_parallelograms(quads):
        raise ValueError("fast_quads=True needs every quad to be a parallelogram (v2 - v1 == v3 - v0), with "
                         "vertices that do not require a gradient; these are not: pass fast_quads=None or False")
    return bool(fast_quads)


def _parallelogram_rows(v0, v1, v3) -> torch.Tensor:
    """(Nq, 15) float32, the expressions of the TPU kernel's fast path in
    its order (``bpt_tpu/kernels/megakernel.py`` ``fast_quads``)."""
    e1 = v1 - v0
    e3 = v3 - v0
    ng = cross(e1, e3)
    d1 = cross(e3, ng)
    d3 = cross(ng, e1)
    den1, den3 = dot(e1, d1), dot(e3, d3)
    k1 = 1.0 / torch.where(torch.abs(den1) > 1e-20, den1, torch.ones_like(den1))
    k3 = 1.0 / torch.where(torch.abs(den3) > 1e-20, den3, torch.ones_like(den3))
    c0 = dot(v0, ng)
    return torch.cat([ng, c0[:, None], d1, k1[:, None], d3, k3[:, None], v0], dim=1).to(torch.float32)


def parallelogram_constants(quads) -> torch.Tensor:
    """The per-quad algebra of the parallelogram test, (Nq, 15) float32 on
    the quads' device (``PARALLELOGRAM_COLUMNS``): made once per quad
    geometry and read both by the plain test and, through the kernel's
    quad rows, by the CUDA kernels.  Vertices that require a gradient get
    rows made on every call, inside the autograd graph."""
    if _requires_grad(quads):
        return _parallelogram_rows(quads.v0, quads.v1, quads.v3)

    def make():
        with torch.no_grad():
            return _parallelogram_rows(quads.v0, quads.v1, quads.v3).contiguous()

    return cached_on((quads.v0, quads.v1, quads.v3), "parallelogram rows", make)


def parallelogram_intersect(rows: torch.Tensor, ro: torch.Tensor, rd: torch.Tensor) -> torch.Tensor:
    """The parallelogram test of rays ro, rd (..., 3) against the quads of
    ``rows`` (``parallelogram_constants``; rows broadcast against the rays'
    batch axes): t, INFINITY on a miss.  One plane intersection, then the
    hit point's coordinates along e1 and e3 from the dual basis, inside
    [0, 1] each; the backface cull is the fans' (denom = rd . ng > 0 misses).
    The TPU kernel's expressions in its order; a NaN distance counts as a
    miss, as it never wins the kernel's strict < either."""
    col = PARALLELOGRAM_COLUMNS
    ng, d1, d3, v0 = (rows[..., col[k]:col[k] + 3] for k in ("ng", "d1", "d3", "v0"))
    c0, k1, k3 = (rows[..., col[k]] for k in ("c0", "k1", "k3"))
    denom = dot(rd, ng)
    ron = dot(ro, ng)
    tt = (c0 - ron) * safe_inv(denom)
    h = ro + rd * tt[..., None] - v0
    aa = dot(h, d1) * k1
    bb = dot(h, d3) * k3
    miss = (tt <= 0.0) | (aa < 0.0) | (aa > 1.0) | (bb < 0.0) | (bb > 1.0) | (denom > 0.0) | torch.isnan(tt)
    return torch.where(miss, torch.full_like(tt, INFINITY), tt)
