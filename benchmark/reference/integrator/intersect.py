# Frozen copy of bpt_tpu_torch/integrator/intersect.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.
"""Closest hit over the whole scene (port of ``bpt_tpu.integrator.intersect``
for unit spheres, the transformed-quadric set, quads and the BVH mesh).

Object ids follow the reference's order: spheres first (0, 1, ...), then the
quadrics, then the quads, then the mesh (one id).  Every group is merged
with a strict ``<``, so on a tie the earlier object keeps the hit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.core.vecmath import INFINITY, normal_to_world, normalize, transform_dir, transform_point
from benchmark.reference.geometry.quadrics import UNIT_INTERSECTORS, unit_sphere_intersect, unit_torus_intersect
from benchmark.reference.geometry.triangles import parallelogram_constants, parallelogram_intersect, quad_intersect
from benchmark.reference.scenes.types import Scene


class Hit(NamedTuple):
    t: torch.Tensor  # (...,) distance, INFINITY on miss
    normal: torch.Tensor  # (..., 3) unit world-space normal
    color: torch.Tensor  # (..., 3)
    mat_type: torch.Tensor  # (...,) int32
    object_id: torch.Tensor  # (...,) float32 (edge-detector id; -INF on miss)
    uv: torch.Tensor  # (..., 2) texture coordinates (mesh hits only)


def _empty_hit(shape, device, dtype=torch.float32) -> Hit:
    return Hit(
        t=torch.full(shape, INFINITY, dtype=dtype, device=device),
        normal=torch.zeros(shape + (3,), dtype=dtype, device=device),
        color=torch.zeros(shape + (3,), dtype=dtype, device=device),
        mat_type=torch.full(shape, -100, dtype=torch.int32, device=device),
        object_id=torch.full(shape, -INFINITY, dtype=dtype, device=device),
        uv=torch.zeros(shape + (2,), dtype=dtype, device=device),
    )


def _merge(best: Hit, t, normal, color, mat_type, object_id, uv=None) -> Hit:
    closer = t < best.t
    c3 = closer[..., None]
    return Hit(
        t=torch.where(closer, t, best.t),
        normal=torch.where(c3, normal, best.normal),
        color=torch.where(c3, color, best.color),
        mat_type=torch.where(closer, mat_type, best.mat_type),
        object_id=torch.where(closer, object_id, best.object_id),
        uv=best.uv if uv is None else torch.where(c3, uv, best.uv),
    )


def _intersect_unit_spheres(spheres, ro, rd, best: Hit, id_base: int) -> Hit:
    for i in range(spheres.inv_matrix.shape[0]):
        inv = spheres.inv_matrix[i]
        t, n_obj = unit_sphere_intersect(transform_point(inv, ro), transform_dir(inv, rd))
        n_world = normal_to_world(inv, normalize(n_obj))
        best = _merge(
            best, t, n_world, spheres.color[i].expand_as(ro), spheres.mat_type[i].expand_as(t),
            torch.full_like(t, float(id_base + i)),
        )
    return best


def _intersect_quadrics(quadrics, ro, rd, best: Hit, id_base: int, torus_steps: list | None = None) -> Hit:
    """The 12-shape set, entry i of ``quadrics`` being UNIT_INTERSECTORS[i]."""
    for i, (name, fn) in enumerate(UNIT_INTERSECTORS):
        inv = quadrics.inv_matrix[i]
        ro_o, rd_o = transform_point(inv, ro), transform_dir(inv, rd)
        if name == "torus" and torus_steps is not None:
            t, n_obj = unit_torus_intersect(ro_o, rd_o, quadrics.shape_k, steps_out=torus_steps)
        else:
            t, n_obj = fn(ro_o, rd_o, quadrics.shape_k)
        best = _merge(
            best, t, normal_to_world(inv, normalize(n_obj)), quadrics.color[i].expand_as(ro),
            quadrics.mat_type[i].expand_as(t), torch.full_like(t, float(id_base + i)),
        )
    return best


def _intersect_quads(quads, ro, rd, best: Hit, id_base: int, fast_quads: bool = False,
                     quad_tests: list | None = None) -> Hit:
    """All quads at once: rays (..., 1, 3) against quads (Nq, 3); the first
    minimum wins, as ``argmin`` does in the reference.  ``fast_quads``: the
    parallelogram test (the caller has checked that every quad is one),
    else the two triangle fans; ``quad_tests`` receives which ran
    ("parallelogram" or "fans")."""
    if fast_quads:
        t = parallelogram_intersect(parallelogram_constants(quads), ro[..., None, :], rd[..., None, :])
    else:
        t = quad_intersect(quads.v0, quads.v1, quads.v2, quads.v3, ro[..., None, :], rd[..., None, :])
    if quad_tests is not None:
        quad_tests.append("parallelogram" if fast_quads else "fans")
    t_min = torch.amin(t, dim=-1)
    first = torch.argmax((t == t_min[..., None]).to(torch.int8), dim=-1)
    normal = normalize(quads.normal[first])
    return _merge(best, t_min, normal, quads.color[first], quads.mat_type[first],
                  first.to(torch.float32) + float(id_base))


def scene_intersect(scene: Scene, ro: torch.Tensor, rd: torch.Tensor, torus_steps: list | None = None,
                    active: torch.Tensor | None = None, mesh_steps: list | None = None,
                    plain_walk: bool = False, fast_quads: bool = False, quad_tests: list | None = None) -> Hit:
    """Nearest hit over spheres, quadrics, quads and the mesh for (..., 3)
    rays of any batch shape.

    ``active`` (bool, optional): the lanes still alive.  The elementwise
    intersectors ignore it (the caller masks dead lanes); the mesh walk
    skips the other lanes, which then miss the mesh.  For measurement,
    ``torus_steps`` receives the torus march's per-lane step counts
    (``unit_torus_intersect``'s ``steps_out``) and ``mesh_steps`` the walk's
    per-lane inner-node visits and triangle tests and the masks of the mesh
    records read (``intersect_mesh_bvh``'s), and ``quad_tests`` which
    quad test ran.  The mesh walk is the closest-hit kernel on CUDA tensors
    unless ``plain_walk`` (or ``mesh_steps``) asks for the plain one.
    ``fast_quads=True`` tests the quads with the parallelogram test (every
    quad must be a parallelogram: ``geometry.triangles.resolve_fast_quads``
    decides), the default with the two triangle fans of the wavefront."""
    best = _empty_hit(ro.shape[:-1], ro.device, ro.dtype)
    id_base = 0
    if scene.spheres is not None:
        best = _intersect_unit_spheres(scene.spheres, ro, rd, best, id_base)
        id_base += scene.spheres.inv_matrix.shape[0]
    if scene.quadrics is not None:
        best = _intersect_quadrics(scene.quadrics, ro, rd, best, id_base, torus_steps)
        id_base += scene.quadrics.inv_matrix.shape[0]
    if scene.quads is not None:
        best = _intersect_quads(scene.quads, ro, rd, best, id_base, fast_quads, quad_tests)
        id_base += scene.quads.v0.shape[0]
    if scene.mesh is not None:
        from benchmark.reference.accel.traverse import intersect_mesh_bvh  # accel.traverse imports this module

        best = intersect_mesh_bvh(scene.mesh, ro, rd, best, id_base, active=active, steps_out=mesh_steps,
                                  plain_walk=plain_walk)
    return best
