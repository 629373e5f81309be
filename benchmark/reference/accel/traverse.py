# Frozen copy of bpt_tpu_torch/accel/traverse.py at commit 930457f (the benchmark's plain reference),
# with its walk made independent of the tree: padded slab tests, entries at the best hit visited, exact
# ties to the lower triangle index.  Imports point into benchmark.reference; nothing of bpt_tpu_torch
# is imported.  The walk is always the plain traverse_bvh (the kernel branch of intersect_mesh_bvh is
# cut; plain_walk is ignored).
"""Per-lane BVH walk (port of ``bpt_tpu.accel.traverse``, its per-lane route).

The reference walks the binary BVH per pixel with a 28-entry stack of
(node, entry t) pairs, popping the nearest entry, skipping one whose entry t
is beyond the best hit, and pushing the far child before the near one.
``traverse_bvh`` is the plain PyTorch version of that walk, with two
changes that make its answer the closest hit whatever the tree: a box is
tested grown by ``BOX_PAD`` of each coordinate's magnitude (plus an
absolute ``BOX_PAD``), so that no rounding in the slab test prunes a
triangle that the triangle test accepts; and a hit at exactly the best
distance goes to the lower triangle index, so that the order of the visits
does not pick among ties.  Its answer is the least (t, triangle index)
over every triangle the triangle test accepts.  Lanes advance together one
step per loop iteration; a lane whose stack empties retires, and the live
lanes are compacted, so the tail of long walks costs little.

The ray enters model space through the inverse model matrix with an
unnormalized direction, so the returned t is comparable with the world-space
t of the other primitive groups.
"""

from __future__ import annotations

import torch

from benchmark.reference.core.vecmath import (INFINITY, cross, dot, normal_to_world, normalize, safe_inv, transform_dir,
                                        transform_point)
from benchmark.reference.integrator.intersect import Hit, _merge
from benchmark.reference.scenes.types import PBR_MATERIAL, TRANSPARENT, TriangleMesh
from benchmark.reference.textures import perturb_normal

MAX_STACK_DEPTH = 28  # the reference's stack size
BOX_PAD = 1e-5  # a box is tested grown by this share of each coordinate's magnitude, plus this much


def _aabb_t(node_min, node_max, ro, inv_dir, t_best):
    """Slab test of the box grown by BOX_PAD: the entry t, or INFINITY when
    the box is missed, lies behind the ray or starts beyond ``t_best``."""
    near = (node_min - BOX_PAD * (1.0 + torch.abs(node_min)) - ro) * inv_dir
    far = (node_max + BOX_PAD * (1.0 + torch.abs(node_max)) - ro) * inv_dir
    tmin = torch.minimum(near, far)
    tmax = torch.maximum(near, far)
    t0 = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]), tmin[..., 2])
    t1 = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]), tmax[..., 2])
    hit = (torch.clamp(t0, min=0.0) <= t1) & (t0 <= t_best)
    return torch.where(hit, t0, torch.full_like(t0, INFINITY))


def tri_t_uv(p0, p1, p2, ro, rd):
    """Möller–Trumbore without the miss test: (t, u, v, det), the walk's
    expressions in its order (the closest-hit VJP recomputes the winner's t,
    u, v with them)."""
    edge1 = p1 - p0
    edge2 = p2 - p0
    pvec = cross(rd, edge2)
    raw_det = dot(edge1, pvec)
    inv_det = safe_inv(raw_det)
    tvec = ro - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, edge1)
    v = dot(rd, qvec) * inv_det
    t = dot(edge2, qvec) * inv_det
    return t, u, v, raw_det


def _tri_t_uv(p0, p1, p2, ro, rd, cull_backface: bool):
    """Möller–Trumbore with a backface-cull flag: (t or INFINITY, u, v)."""
    t, u, v, raw_det = tri_t_uv(p0, p1, p2, ro, rd)
    miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0) | (t <= 0.0)
    if cull_backface:
        miss = miss | (raw_det < 0.0)
    miss = miss | torch.isnan(t)
    return torch.where(miss, torch.full_like(t, INFINITY), t), u, v


def traverse_bvh(node_tri, node_right, node_min, node_max, p0, p1, p2, ro, rd, cull_backface: bool,
                 stack_depth: int = MAX_STACK_DEPTH, active=None, steps_out: list | None = None):
    """Closest triangle hit of (..., 3) object-space rays: (t, tri, u, v),
    t = INFINITY and tri = -1 on a miss.

    ``active`` (bool, the rays' shape) limits the walk to those lanes; the
    others report a miss.  ``steps_out``, for measurement, receives two
    int32 tensors of the rays' shape, the inner nodes each lane visited
    (each a pair of child slab tests) and its triangle tests, then two bool
    masks, (M,) and (T,), of the node and triangle records the walk read:
    the root, the children of every visited inner node, the tested
    triangles.
    """
    shape = ro.shape[:-1]
    dev = ro.device
    ro = ro.reshape(-1, 3)
    rd = rd.reshape(-1, 3)
    n = ro.shape[0]
    inv_dir = safe_inv(rd)
    inf = torch.full((n,), INFINITY, dtype=ro.dtype, device=dev)
    t_out, u_out, v_out = inf.clone(), torch.zeros_like(inf), torch.zeros_like(inf)
    tri_out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    visits_out = torch.zeros((n,), dtype=torch.int32, device=dev)
    tests_out = torch.zeros_like(visits_out)
    node_tri, node_right = node_tri.to(torch.int64), node_right.to(torch.int64)
    measure = steps_out is not None
    if measure:
        node_read = torch.zeros(node_tri.shape[0], dtype=torch.bool, device=dev)
        tri_read = torch.zeros(p0.shape[0], dtype=torch.bool, device=dev)
        node_read[0] = bool(active.any()) if active is not None else n > 0

    root_t = _aabb_t(node_min[0], node_max[0], ro, inv_dir, inf)
    start = root_t < INFINITY
    if active is not None:
        start = start & active.reshape(-1)
    lanes = torch.nonzero(start).squeeze(1)
    c_ro, c_rd, c_inv = ro[lanes], rd[lanes], inv_dir[lanes]
    m = lanes.shape[0]
    stack_node = torch.zeros((m, stack_depth), dtype=torch.int64, device=dev)
    stack_t = torch.full((m, stack_depth), INFINITY, dtype=ro.dtype, device=dev)
    stack_t[:, 0] = root_t[lanes]
    ptr = torch.ones((m,), dtype=torch.int64, device=dev)
    t_best, u_best, v_best = inf[:m].clone(), torch.zeros_like(inf[:m]), torch.zeros_like(inf[:m])
    tri_best = torch.full((m,), -1, dtype=torch.int64, device=dev)
    visits, tests = torch.zeros((m,), dtype=torch.int32, device=dev), torch.zeros((m,), dtype=torch.int32, device=dev)

    def push(ptr, where, node, t):
        idx = torch.clamp(ptr, max=stack_depth - 1)[:, None]
        stack_node.scatter_(1, idx, torch.where(where[:, None], node[:, None], stack_node.gather(1, idx)))
        stack_t.scatter_(1, idx, torch.where(where[:, None], t[:, None], stack_t.gather(1, idx)))
        return torch.where(where, torch.clamp(ptr + 1, max=stack_depth), ptr)

    while m > 0:
        top = (ptr - 1)[:, None]
        node = stack_node.gather(1, top)[:, 0]
        box_t = stack_t.gather(1, top)[:, 0]
        ptr = ptr - 1
        visit = box_t <= t_best  # an entry beyond the best hit is skipped
        tri = node_tri[node]
        leaf = visit & (tri >= 0)
        inner = visit & (tri < 0)

        # leaf: one triangle test
        tid = torch.clamp(tri, min=0)
        t, u, v = _tri_t_uv(p0[tid], p1[tid], p2[tid], c_ro, c_rd, cull_backface)
        closer = leaf & ((t < t_best) | ((t == t_best) & (t < INFINITY) & (tri < tri_best)))
        t_best = torch.where(closer, t, t_best)
        tri_best = torch.where(closer, tri, tri_best)
        u_best = torch.where(closer, u, u_best)
        v_best = torch.where(closer, v, v_best)

        # inner: both children against the best hit; push far, then near
        left = torch.where(inner, node + 1, torch.zeros_like(node))
        right = torch.where(inner, node_right[node], torch.zeros_like(node))
        t_l = _aabb_t(node_min[left], node_max[left], c_ro, c_inv, t_best)
        t_r = _aabb_t(node_min[right], node_max[right], c_ro, c_inv, t_best)
        near_is_left = t_l <= t_r
        near_node = torch.where(near_is_left, left, right)
        far_node = torch.where(near_is_left, right, left)
        near_t = torch.minimum(t_l, t_r)
        far_t = torch.maximum(t_l, t_r)
        ptr = push(ptr, inner & (far_t < INFINITY), far_node, far_t)
        ptr = push(ptr, inner & (near_t < INFINITY), near_node, near_t)
        visits += inner.to(torch.int32)
        tests += leaf.to(torch.int32)
        if measure:
            node_read[left[inner]] = True
            node_read[right[inner]] = True
            tri_read[tid[leaf]] = True

        # retire the lanes whose stack is empty, compact the rest
        going = ptr > 0
        n_going = int(going.sum())
        if n_going < m:
            done = ~going
            out = lanes[done]
            t_out[out], tri_out[out], u_out[out], v_out[out] = t_best[done], tri_best[done], u_best[done], v_best[done]
            visits_out[out], tests_out[out] = visits[done], tests[done]
            keep = torch.nonzero(going).squeeze(1)
            lanes, c_ro, c_rd, c_inv = lanes[keep], c_ro[keep], c_rd[keep], c_inv[keep]
            stack_node, stack_t, ptr = stack_node[keep], stack_t[keep], ptr[keep]
            t_best, tri_best, u_best, v_best = t_best[keep], tri_best[keep], u_best[keep], v_best[keep]
            visits, tests = visits[keep], tests[keep]
            m = n_going

    if measure:
        steps_out += [visits_out.reshape(shape), tests_out.reshape(shape), node_read, tri_read]
    return t_out.reshape(shape), tri_out.reshape(shape), u_out.reshape(shape), v_out.reshape(shape)


def intersect_mesh_bvh(mesh: TriangleMesh, ro: torch.Tensor, rd: torch.Tensor, best: Hit, id_base: int,
                       active=None, steps_out: list | None = None, plain_walk: bool = False) -> Hit:
    """The model section of the closest hit: the ray to object space, the
    walk, then one barycentric normal (w·n0 + u·n1 + v·n2, normalized) and
    uv for the winning triangle, merged into ``best`` with a strict ``<``.
    The walk is ``traverse_bvh`` (``plain_walk`` is ignored).  The normal
    and uv gathers are differentiable through u and v.
    With a normal map the object-space normal is perturbed per texel before
    the world transform.  The hit colour is 1; the material is PBR_MATERIAL
    when the mesh has an albedo, else the mesh's own; the object id is
    ``id_base`` (after spheres, quadrics and quads).  Back faces are culled
    unless the mesh is an untextured TRANSPARENT one, as in the reference.
    ``steps_out`` receives ``traverse_bvh``'s, then the (T,) bool mask of
    the vertex-normal records read: the winners that beat ``best``."""
    ro_o = transform_point(mesh.inv_matrix, ro)
    rd_o = transform_dir(mesh.inv_matrix, rd)  # not normalized: t stays a world-space distance
    pbr = mesh.albedo is not None
    cull = pbr or int(mesh.mat_type) != TRANSPARENT
    t, tri, u, v = traverse_bvh(mesh.node_tri, mesh.node_right, mesh.node_min, mesh.node_max, mesh.p0, mesh.p1,
                                mesh.p2, ro_o, rd_o, cull, MAX_STACK_DEPTH, active=active, steps_out=steps_out)
    hit_ok = tri >= 0
    tid = torch.clamp(tri, min=0)
    w = 1.0 - u - v
    n = mesh.n0[tid] * w[..., None] + mesh.n1[tid] * u[..., None] + mesh.n2[tid] * v[..., None]
    uv = mesh.uv0[tid] * w[..., None] + mesh.uv1[tid] * u[..., None] + mesh.uv2[tid] * v[..., None]
    n = normalize(n)
    if mesh.normal_map is not None:
        n = perturb_normal(n, mesh.normal_map, uv)
    n_world = normal_to_world(mesh.inv_matrix, n)
    t = torch.where(hit_ok, t, torch.full_like(t, INFINITY))
    mat = torch.full_like(t, PBR_MATERIAL, dtype=torch.int32) if pbr else mesh.mat_type.to(torch.int32).expand_as(t)
    if steps_out is not None:
        normal_read = torch.zeros(mesh.p0.shape[0], dtype=torch.bool, device=ro.device)
        normal_read[tid[t < best.t]] = True
        steps_out.append(normal_read)
    return _merge(best, t, n_world, torch.ones_like(ro), mat, torch.full_like(t, float(id_base)), uv=uv)
