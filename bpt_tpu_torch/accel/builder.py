"""Host-side binary BVH builders (numpy, with a native C++ twin).

A copy of ``bpt_tpu.accel.builder`` (importing it would load jax): the
spatial-median ``build_bvh`` and the binned-SAH ``build_bvh_sah``, both
emitting the flat layout the walk expects -- pre-order, node i's left child
is node i + 1, the right child id stored in the node, one triangle per leaf
(``node_tri`` >= 0), -1 for inner nodes.  ``use_native`` picks the C++
builder of ``accel/native`` ("auto": when it compiles and loads, "require":
or raise, "never"); the two emit bit-identical trees.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BuiltBVH(NamedTuple):
    node_tri: np.ndarray  # (M,) int32; triangle id for leaves, -1 inner
    node_right: np.ndarray  # (M,) int32; right-child node id (inner only)
    node_min: np.ndarray  # (M, 3) float32
    node_max: np.ndarray  # (M, 3) float32
    max_depth: int  # deepest node (root = 0); must fit the traversal stack


def triangle_aabbs(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray, pad: float = 0.0):
    """Per-triangle AABBs + centroids from vertex arrays (T, 3)."""
    mn = np.minimum(np.minimum(p0, p1), p2) - pad
    mx = np.maximum(np.maximum(p0, p1), p2) + pad
    centroid = (mn + mx) * 0.5
    return mn.astype(np.float32), mx.astype(np.float32), centroid.astype(np.float32)


def build_bvh(aabb_min: np.ndarray, aabb_max: np.ndarray, use_native: str = "auto") -> BuiltBVH:
    """Build the flat BVH over T triangle AABBs; returns 2T-1 nodes.

    use_native: "auto" (native C++ builder when it loads, else numpy),
    "never", or "require".  Both builders emit bit-identical trees
    (stable partitions, same axis ranking) — tested in tests/test_torch_mesh.py.
    """
    t_count = aabb_min.shape[0]
    assert t_count >= 1
    if use_native != "never":
        built = _build_bvh_native(aabb_min, aabb_max)
        if built is not None:
            return built
        if use_native == "require":
            raise RuntimeError("native BVH builder unavailable (g++ compile failed?)")
    centroid = (aabb_min + aabb_max) * 0.5
    n_nodes = 2 * t_count - 1
    node_tri = np.full(n_nodes, -1, np.int32)
    node_right = np.full(n_nodes, -1, np.int32)
    node_min = np.zeros((n_nodes, 3), np.float32)
    node_max = np.zeros((n_nodes, 3), np.float32)

    next_id = 0
    max_depth = 0
    # Explicit stack of (triangle-index-array, parent_node_id, depth).
    # Pre-order left-first emission gives the left-child = parent+1 invariant;
    # when the right branch is emitted its id is patched into the parent.
    stack = [(np.arange(t_count, dtype=np.int64), -1, True, 0)]
    while stack:
        ids, parent, is_left, depth = stack.pop()
        my_id = next_id
        next_id += 1
        max_depth = max(max_depth, depth)
        if parent >= 0 and not is_left:
            node_right[parent] = my_id

        mn = aabb_min[ids].min(axis=0)
        mx = aabb_max[ids].max(axis=0)
        node_min[my_id] = mn
        node_max[my_id] = mx

        if ids.shape[0] == 1:
            node_tri[my_id] = ids[0]
            continue

        c = centroid[ids]
        extent = mx - mn
        # Ranked axes, longest first (the reference's best→good→okay ladder,
        # BVH_Fast_Builder.js:95-237).
        order = np.argsort(-extent)
        left_sel = None
        for axis in order:
            split = 0.5 * (mn[axis] + mx[axis])
            sel = c[:, axis] < split
            n_left = int(sel.sum())
            if 0 < n_left < ids.shape[0]:
                left_sel = sel
                break
        if left_sel is None:
            # All centroids coincide on every axis: alternate even/odd
            # assignment (:279-319).
            left_sel = np.zeros(ids.shape[0], bool)
            left_sel[::2] = True

        left_ids = ids[left_sel]
        right_ids = ids[~left_sel]
        # Push right first so the left branch is emitted (DFS) immediately
        # after this node.
        stack.append((right_ids, my_id, False, depth + 1))
        stack.append((left_ids, my_id, True, depth + 1))

    assert next_id == n_nodes
    return BuiltBVH(node_tri, node_right, node_min, node_max, max_depth)


_SAH_BINS = 16


def build_bvh_sah(aabb_min: np.ndarray, aabb_max: np.ndarray, use_native: str = "auto") -> BuiltBVH:
    """Binned surface-area-heuristic build; same flat BuiltBVH layout as
    build_bvh (preorder, left child = i + 1, one triangle per leaf).

    The reference's spatial-median split (BVH_Fast_Builder.js:95-237,
    mirrored by build_bvh) is cheap but produces heavily-overlapping
    siblings on organic meshes; the packet walker's cost is the PACKET'S
    subtree union, so overlap multiplies node visits for every lane.
    Binned SAH (16 bins x 3 axes, min N_L*A_L + N_R*A_R over candidate
    planes) is the standard fix — it typically cuts packet node visits
    2-4x on meshes like DamagedHelmet.  Kept separate from build_bvh so
    the median builder remains the reference-parity twin.

    Determinism contract (shared with the native C++ twin, tested
    bit-identical in tests/test_torch_mesh.py): centroids and bin indices in
    float32, sweep costs in float64, ties broken toward the lower axis
    then lower bin, stable partition."""
    t_count = aabb_min.shape[0]
    assert t_count >= 1
    if use_native != "never":
        built = _build_bvh_native_sah(aabb_min, aabb_max)
        if built is not None:
            return built
        if use_native == "require":
            raise RuntimeError("native SAH builder unavailable")
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    centroid = ((aabb_min + aabb_max) * np.float32(0.5)).astype(np.float32)
    n_nodes = 2 * t_count - 1
    node_tri = np.full(n_nodes, -1, np.int32)
    node_right = np.full(n_nodes, -1, np.int32)
    node_min = np.zeros((n_nodes, 3), np.float32)
    node_max = np.zeros((n_nodes, 3), np.float32)
    K = _SAH_BINS

    next_id = 0
    max_depth = 0
    stack = [(np.arange(t_count, dtype=np.int64), -1, True, 0)]
    while stack:
        ids, parent, is_left, depth = stack.pop()
        my_id = next_id
        next_id += 1
        max_depth = max(max_depth, depth)
        if parent >= 0 and not is_left:
            node_right[parent] = my_id

        bmn = aabb_min[ids]
        bmx = aabb_max[ids]
        node_min[my_id] = bmn.min(axis=0)
        node_max[my_id] = bmx.max(axis=0)

        n = ids.shape[0]
        if n == 1:
            node_tri[my_id] = ids[0]
            continue

        c = centroid[ids]
        cmn = c.min(axis=0)
        cmx = c.max(axis=0)
        best_cost = np.inf
        best_sel = None
        for axis in range(3):
            cext = np.float32(cmx[axis] - cmn[axis])
            if not (cext > 0):
                continue
            # float32 bin index, exactly as the C++ twin computes it
            scale = np.float32(np.float32(K) * np.float32(1.0 - 1e-6) / cext)
            b = np.minimum(
                ((c[:, axis] - cmn[axis]).astype(np.float32) * scale).astype(np.int32),
                K - 1,
            )
            counts = np.bincount(b, minlength=K)
            # per-bin bbox of triangle AABBs
            binmn = np.full((K, 3), np.inf, np.float32)
            binmx = np.full((K, 3), -np.inf, np.float32)
            np.minimum.at(binmn, b, bmn)
            np.maximum.at(binmx, b, bmx)
            # prefix (left) / suffix (right) sweeps in float64
            lmn = np.minimum.accumulate(binmn, axis=0)
            lmx = np.maximum.accumulate(binmx, axis=0)
            rmn = np.minimum.accumulate(binmn[::-1], axis=0)[::-1]
            rmx = np.maximum.accumulate(binmx[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)

            def _area(mn, mx):
                d = np.maximum((mx - mn).astype(np.float64), 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            la = _area(lmn[:-1], lmx[:-1])  # split after bin i (i = 0..K-2)
            ra = _area(rmn[1:], rmx[1:])
            nl = lcnt[:-1].astype(np.float64)
            nr = np.float64(n) - nl
            cost = np.where((nl > 0) & (nr > 0), nl * la + nr * ra, np.inf)
            i = int(np.argmin(cost))  # lowest bin on ties (argmin is first)
            if cost[i] < best_cost:  # strict: lowest axis wins ties
                best_cost = cost[i]
                best_sel = b <= i
        if best_sel is None or not (0 < int(best_sel.sum()) < n):
            # degenerate centroids: alternate even/odd assignment
            best_sel = np.zeros(n, bool)
            best_sel[::2] = True

        left_ids = ids[best_sel]
        right_ids = ids[~best_sel]
        stack.append((right_ids, my_id, False, depth + 1))
        stack.append((left_ids, my_id, True, depth + 1))

    assert next_id == n_nodes
    return BuiltBVH(node_tri, node_right, node_min, node_max, max_depth)


def _build_bvh_native(aabb_min: np.ndarray, aabb_max: np.ndarray, fn_name: str = "bvh_build"):
    """C++ builder via ctypes; None when the library can't be loaded."""
    import ctypes

    from bpt_tpu_torch.accel.native import load

    lib = load()
    if lib is None:
        return None
    fn = getattr(lib, fn_name, None)
    if fn is None:
        return None
    t_count = aabb_min.shape[0]
    n_nodes = 2 * t_count - 1
    mn = np.ascontiguousarray(aabb_min, np.float32)
    mx = np.ascontiguousarray(aabb_max, np.float32)
    node_tri = np.empty(n_nodes, np.int32)
    node_right = np.empty(n_nodes, np.int32)
    node_min = np.empty((n_nodes, 3), np.float32)
    node_max = np.empty((n_nodes, 3), np.float32)
    max_depth = np.zeros(1, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    rc = fn(
        mn.ctypes.data_as(fp),
        mx.ctypes.data_as(fp),
        ctypes.c_int64(t_count),
        node_tri.ctypes.data_as(ip),
        node_right.ctypes.data_as(ip),
        node_min.ctypes.data_as(fp),
        node_max.ctypes.data_as(fp),
        max_depth.ctypes.data_as(ip),
    )
    if rc != 0:
        return None
    return BuiltBVH(node_tri, node_right, node_min, node_max, int(max_depth[0]))


def _build_bvh_native_sah(aabb_min: np.ndarray, aabb_max: np.ndarray):
    return _build_bvh_native(aabb_min, aabb_max, fn_name="bvh_build_sah")
