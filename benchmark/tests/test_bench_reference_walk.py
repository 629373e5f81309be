"""The reference's BVH and walk: the tree holds every triangle once inside
boxes that hold their children, and the walk's answer is the least (t,
triangle index) over every triangle the triangle test accepts, whatever
the tree, on rays aimed at the mesh's shared edges and vertices."""

import pytest
import torch

from benchmark.configs.gltf_textured import heightfield
from benchmark.reference.accel.traverse import _tri_t_uv, traverse_bvh
from benchmark.reference.bvh import build_bvh
from benchmark.reference.core.vecmath import INFINITY


def mesh(side: int = 16):
    soup = heightfield(side)
    return [torch.as_tensor(soup[k]) for k in ("p0", "p1", "p2")]


def edge_rays(p0, p1, p2, n: int, seed: int):
    """Rays from around the demo camera to points on the triangles' edges
    and at their vertices, where adjacent triangles tie or nearly tie."""
    gen = torch.Generator().manual_seed(seed)
    tri = torch.randint(0, p0.shape[0], (n,), generator=gen)
    which = torch.randint(0, 4, (n, 1), generator=gen)
    w = torch.rand(n, 1, generator=gen)
    a, b, c = p0[tri], p1[tri], p2[tri]
    target = torch.where(which == 0, a * w + b * (1 - w), torch.where(
        which == 1, b * w + c * (1 - w), torch.where(which == 2, c * w + a * (1 - w), a)))
    ro = torch.tensor([0.0, -20.0, -120.0]) + torch.randn(n, 3, generator=gen) * torch.tensor([30.0, 6.0, 30.0])
    return ro, torch.nn.functional.normalize(target - ro, dim=-1)


def brute_force(p0, p1, p2, ro, rd):
    """(t, triangle) of the least (t, index) over every triangle."""
    t, _, _ = _tri_t_uv(p0[None], p1[None], p2[None], ro[:, None], rd[:, None], True)
    best, tri = t.min(1)  # the first (lowest) index on ties
    return best, torch.where(best < INFINITY, tri, torch.full_like(tri, -1))


def test_tree_holds_every_triangle_once_in_nested_boxes():
    p0, p1, p2 = mesh()
    bvh = build_bvh(p0, p1, p2)
    n = p0.shape[0]
    leaves = bvh.node_tri[bvh.node_tri >= 0].to(torch.int64)
    assert bvh.node_tri.shape[0] == 2 * n - 1 and torch.equal(torch.sort(leaves).values, torch.arange(n))
    inner = torch.nonzero(bvh.node_tri < 0).squeeze(1)
    for child in (inner + 1, bvh.node_right[inner].to(torch.int64)):
        assert bool((bvh.node_min[inner] <= bvh.node_min[child]).all())
        assert bool((bvh.node_max[inner] >= bvh.node_max[child]).all())
    lo = torch.minimum(torch.minimum(p0, p1), p2)
    assert torch.equal(bvh.node_min[bvh.node_tri >= 0], lo[leaves])


@pytest.mark.parametrize("order", ["as_given", "shuffled"])
def test_walk_is_the_closest_hit_whatever_the_tree(order):
    p0, p1, p2 = mesh()
    perm = torch.arange(p0.shape[0]) if order == "as_given" else torch.randperm(
        p0.shape[0], generator=torch.Generator().manual_seed(5))
    bvh = build_bvh(p0[perm], p1[perm], p2[perm])  # another order of the triangles gives another tree
    node_tri = torch.where(bvh.node_tri >= 0, perm[bvh.node_tri.clamp(min=0).to(torch.int64)].to(torch.int32),
                           bvh.node_tri)
    ro, rd = edge_rays(p0, p1, p2, 3000, seed=3)
    t, tri, _, _ = traverse_bvh(node_tri, bvh.node_right, bvh.node_min, bvh.node_max, p0, p1, p2, ro, rd, True)
    t_bf, tri_bf = brute_force(p0, p1, p2, ro, rd)
    assert int((tri_bf >= 0).sum()) > 2500
    assert torch.equal(t, t_bf) and torch.equal(tri, tri_bf)
