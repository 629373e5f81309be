"""The reference's BVH: a binned-SAH tree built on the device, one level of
nodes at a time, in a few tensor ops a level.

The closest hit along a ray does not depend on the tree that finds it: the
reference's walk (``accel.traverse``) tests padded boxes and breaks exact
ties by triangle index, so any tree over the triangles gives the same
answer.  The tree's quality decides only how many node and triangle
records a walk reads, which the traced run's roofline bounds count; so it
is a surface-area-heuristic tree, as a renderer would build for these
inputs: each node splits its triangles at the cheapest of ``BINS`` - 1
planes on each axis (cost n_L A_L + n_R A_R, the boxes' half surface areas;
the lowest axis, then the lowest plane, on ties), or, where every
centroid coincides, in two halves of its order.  The layout is the flat
pre-order one that ``traverse_bvh`` walks: node i's left child is i + 1,
``node_right`` names the right child, ``node_tri`` >= 0 marks a leaf, one
triangle a leaf.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BINS = 16


class BVH(NamedTuple):
    node_tri: torch.Tensor  # (2T - 1,) int32
    node_right: torch.Tensor  # (2T - 1,) int32
    node_min: torch.Tensor  # (2T - 1, 3) float32
    node_max: torch.Tensor  # (2T - 1, 3) float32


def _half_area(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    d = torch.clamp(hi - lo, min=0.0).to(torch.float64)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def _split(tri, seg, rank, size, lo, hi, cen):
    """The side (True: left) of each of the triangles ``tri`` of the nodes
    of ``size`` triangles: ``seg`` is each one's node, ``rank`` its place
    in the node's order."""
    n_seg, dev = size.shape[0], tri.device
    c, b_lo, b_hi = cen[tri], lo[tri], hi[tri]
    big = torch.finfo(torch.float32).max
    c_lo = torch.full((n_seg, 3), big, device=dev).scatter_reduce(0, seg[:, None].expand(-1, 3), c, "amin")
    c_hi = torch.full((n_seg, 3), -big, device=dev).scatter_reduce(0, seg[:, None].expand(-1, 3), c, "amax")
    ext = c_hi - c_lo
    scale = BINS * (1.0 - 1e-6) / torch.where(ext > 0, ext, torch.ones_like(ext))
    bins = torch.clamp(((c - c_lo[seg]) * scale[seg]).to(torch.int64), 0, BINS - 1)  # (N, 3)
    best_cost = torch.full((n_seg,), float("inf"), dtype=torch.float64, device=dev)
    best_axis = torch.zeros(n_seg, dtype=torch.int64, device=dev)
    best_plane = torch.zeros(n_seg, dtype=torch.int64, device=dev)
    for axis in range(3):
        key = seg * BINS + bins[:, axis]
        count = torch.zeros(n_seg * BINS, dtype=torch.int64, device=dev).index_add_(0, key, torch.ones_like(key))
        k3 = key[:, None].expand(-1, 3)
        bin_lo = torch.full((n_seg * BINS, 3), big, device=dev).scatter_reduce(0, k3, b_lo, "amin")
        bin_hi = torch.full((n_seg * BINS, 3), -big, device=dev).scatter_reduce(0, k3, b_hi, "amax")
        count, bin_lo, bin_hi = count.view(n_seg, BINS), bin_lo.view(n_seg, BINS, 3), bin_hi.view(n_seg, BINS, 3)
        left_lo, left_hi = torch.cummin(bin_lo, 1).values, torch.cummax(bin_hi, 1).values
        right_lo = torch.cummin(bin_lo.flip(1), 1).values.flip(1)
        right_hi = torch.cummax(bin_hi.flip(1), 1).values.flip(1)
        n_left = torch.cumsum(count, 1)[:, :-1].to(torch.float64)
        n_right = size[:, None].to(torch.float64) - n_left
        cost = n_left * _half_area(left_lo[:, :-1], left_hi[:, :-1]) + n_right * _half_area(right_lo[:, 1:],
                                                                                             right_hi[:, 1:])
        ok = (n_left > 0) & (n_right > 0) & (ext[:, axis] > 0)[:, None]
        cost = torch.where(ok, cost, torch.full_like(cost, float("inf")))
        plane_cost, plane = cost.min(1)  # the first (lowest) plane on ties
        better = plane_cost < best_cost  # strict: the lowest axis on ties
        best_cost = torch.where(better, plane_cost, best_cost)
        best_axis = torch.where(better, torch.full_like(best_axis, axis), best_axis)
        best_plane = torch.where(better, plane, best_plane)
    by_plane = bins.gather(1, best_axis[seg][:, None])[:, 0] <= best_plane[seg]
    by_half = rank < size[seg] - size[seg] // 2  # every centroid alike: two halves of the order
    return torch.where(torch.isinf(best_cost)[seg], by_half, by_plane)


def build_bvh(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> BVH:
    """The tree over the (T, 3) triangles, on their device."""
    lo = torch.minimum(torch.minimum(p0, p1), p2).to(torch.float32)
    hi = torch.maximum(torch.maximum(p0, p1), p2).to(torch.float32)
    cen = (lo + hi) * 0.5
    n = lo.shape[0]
    dev = lo.device
    m = 2 * n - 1
    order = torch.arange(n, dtype=torch.int64, device=dev)  # the triangles, grouped by node, nodes by first
    node_tri = torch.full((m,), -1, dtype=torch.int64, device=dev)
    node_right = torch.full((m,), -1, dtype=torch.int64, device=dev)
    levels = []  # per level: the node ids of its inner nodes
    ids = torch.zeros(1, dtype=torch.int64, device=dev)
    first = torch.zeros(1, dtype=torch.int64, device=dev)
    size = torch.full((1,), n, dtype=torch.int64, device=dev)
    leaf_ids, leaf_first = [], []
    while ids.numel():
        leaf = size == 1
        leaf_ids.append(ids[leaf])
        leaf_first.append(first[leaf])
        ids, first, size = ids[~leaf], first[~leaf], size[~leaf]
        if not ids.numel():
            break
        # the entries of the inner nodes' ranges, each with its node's index
        seg = torch.repeat_interleave(torch.arange(ids.shape[0], device=dev), size)
        rank = torch.arange(seg.shape[0], device=dev) - (torch.cumsum(size, 0) - size)[seg]
        pos = first[seg] + rank
        left = _split(order[pos], seg, rank, size, lo, hi, cen)
        # a stable partition inside each range: left entries first
        key = seg * 2 + (~left).to(torch.int64)
        perm = torch.sort(key, stable=True).indices
        order[pos] = order[pos][perm]
        left_size = torch.zeros_like(size).index_add_(0, seg, left.to(torch.int64))
        right_id = ids + 2 * left_size  # the left subtree holds 2 * left_size - 1 nodes
        node_right[ids] = right_id
        levels.append(ids)
        ids = torch.cat([ids + 1, right_id])
        first = torch.cat([first, first + left_size])
        size = torch.cat([left_size, size - left_size])
    leaf_ids, leaf_first = torch.cat(leaf_ids), torch.cat(leaf_first)
    tri = order[leaf_first]
    node_tri[leaf_ids] = tri
    node_min = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    node_max = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    node_min[leaf_ids], node_max[leaf_ids] = lo[tri], hi[tri]
    for inner in reversed(levels):  # children lie on deeper levels: fill the boxes bottom up
        left, right = inner + 1, node_right[inner]
        node_min[inner] = torch.minimum(node_min[left], node_min[right])
        node_max[inner] = torch.maximum(node_max[left], node_max[right])
    return BVH(node_tri.to(torch.int32), node_right.to(torch.int32), node_min, node_max)
