"""The node table of the CUDA walk (csrc/bvh.cuh): child-pair records.

``mesh_tables`` packs a mesh's flat binary BVH into one 64-byte record per
inner node holding both children's boxes and references, after a header
with the root's; a leaf is referenced by its triangle.  These tests decode
the records back into the builder's BVH bit for bit, and walk them as the
kernel does, lane by lane in plain torch (``packed_walk``, which reads
nothing but the packed tables), against ``traverse_bvh``, the kernel's
plain version: (t, tri, u, v) bit-equal and the same inner-node visits and
triangle tests per lane.  The soup in which every triangle appears twice
makes every hit a tie that only the visit order decides; there the port's
walk also picks the JAX package's triangle ids.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.accel.traverse import traverse_bvh as j_traverse_bvh
from bpt_tpu.io.gltf import GLTFModel as JGLTFModel
from bpt_tpu_torch.accel.traverse import MAX_STACK_DEPTH, _aabb_t, _tri_t_uv, traverse_bvh
from bpt_tpu_torch.core.vecmath import INFINITY, safe_inv
from bpt_tpu_torch.scenes.gltf_scene import mesh_from_model
from bpt_tpu_torch.scenes.types import check_walk_tables, mesh_tables
from chip_smoke import doubled_model, one_triangle_model
from test_torch_kernels import blob_model

torch.set_num_threads(2)
# bpt_tpu.scenes exports a function named gltf_scene, which hides the module
j_mesh_from_model = importlib.import_module("bpt_tpu.scenes.gltf_scene").mesh_from_model


MODELS = {"blob": lambda: blob_model(128), "two": lambda: blob_model(2, seed=3), "one": one_triangle_model,
          "doubled": lambda: doubled_model(blob_model(64))}


def rays(mesh, n=2048, seed=5, away=0.25):
    """Object-space rays from 60 to 120 units in front of the mesh's box at
    points inside it; a share ``away`` of them turned round, most of which
    miss the root box."""
    rng = np.random.default_rng(seed)
    lo, hi = mesh.node_min[0].numpy(), mesh.node_max[0].numpy()
    tgt = (lo + rng.uniform(0, 1, (n, 3)) * (hi - lo)).astype(np.float32)
    ro = (tgt + rng.uniform(-40, 40, (n, 3)) - np.array([0.0, 0.0, 90.0])).astype(np.float32)
    rd = (tgt - ro).astype(np.float32)
    rd[: int(n * away)] *= -1.0
    return torch.as_tensor(ro), torch.as_tensor(rd)


def decode(nodes):
    """The child-pair records back into a flat pre-order BVH: (node_tri,
    node_right, node_min, node_max), the boxes as int32 bits."""
    bits = nodes.view(torch.int32)
    node_tri, node_right, node_min, node_max = [], [], [], []
    todo = [(int(bits[0, 0, 3]), bits[0, 0, :3], bits[0, 1, :3], None)]  # (ref, min, max, parent awaiting right)
    while todo:
        ref, lo, hi, parent = todo.pop()
        if parent is not None:
            node_right[parent] = len(node_tri)
        node_min.append(lo)
        node_max.append(hi)
        node_right.append(-1)
        if ref < 0:
            node_tri.append(-1 - ref)
            continue
        me = len(node_tri)
        node_tri.append(-1)
        r = bits[ref]
        todo.append((int(r[1, 3]), r[2, :3], r[3, :3], me))  # the right child, after the left subtree
        todo.append((int(r[0, 3]), r[0, :3], r[1, :3], None))
    return (torch.tensor(node_tri, dtype=torch.int32), torch.tensor(node_right, dtype=torch.int32),
            torch.stack(node_min), torch.stack(node_max))


def packed_walk(nodes, tris, ro, rd, cull, depth=MAX_STACK_DEPTH):
    """csrc/bvh.cuh ``bvh_closest`` for every lane at once, reading only the
    packed tables: ((t, tri, u, v), inner-node visits, triangle tests, ties
    per lane).  As in the kernel, the near child is carried to the next step
    and only the far one is pushed, while the stack has room.  A tie is a
    tested triangle whose t equals the best hit's."""
    n = ro.shape[0]
    refs = nodes.view(torch.int32)[:, :2, 3].long()  # (R, 2): left, right
    boxes = nodes[:, :, :3]  # (R, 4, 3): left min, left max, right min, right max (the header: root min, max)
    verts = tris[:, :, :3]
    inv = safe_inv(rd)
    inf = torch.full((n,), INFINITY)
    root_t = _aabb_t(boxes[0, 0], boxes[0, 1], ro, inv, inf)
    stack_ref = torch.zeros((n, depth), dtype=torch.long)
    stack_t = torch.full((n, depth), INFINITY)
    ptr = torch.zeros(n, dtype=torch.long)
    carried, have = refs[0, 0].expand(n).clone(), root_t < INFINITY
    t_best, u_best, v_best = inf.clone(), torch.zeros(n), torch.zeros(n)
    tri_best = torch.full((n,), -1, dtype=torch.long)
    visits, tests, ties = (torch.zeros(n, dtype=torch.int32) for _ in range(3))

    while bool((have | (ptr > 0)).any()):
        live = have | (ptr > 0)
        pop = live & ~have
        top = (ptr - 1).clamp(min=0)[:, None]
        ref = torch.where(have, carried, stack_ref.gather(1, top)[:, 0])
        go = have | (pop & (stack_t.gather(1, top)[:, 0] < t_best))
        ptr = torch.where(pop, ptr - 1, ptr)
        leaf, inner = go & (ref < 0), go & (ref >= 0)
        tid = torch.where(leaf, -1 - ref, 0)
        t, u, v = _tri_t_uv(verts[tid, 0], verts[tid, 1], verts[tid, 2], ro, rd, cull)
        ties += (leaf & (t == t_best) & (t < INFINITY)).int()
        closer = leaf & (t < t_best)
        t_best, u_best, v_best = (torch.where(closer, a, b) for a, b in ((t, t_best), (u, u_best), (v, v_best)))
        tri_best = torch.where(closer, tid, tri_best)
        rec = torch.where(inner, ref, 0)
        t_l = _aabb_t(boxes[rec, 0], boxes[rec, 1], ro, inv, t_best)
        t_r = _aabb_t(boxes[rec, 2], boxes[rec, 3], ro, inv, t_best)
        near_is_left = t_l <= t_r
        left, right = refs[rec, 0], refs[rec, 1]
        have = inner & (torch.minimum(t_l, t_r) < INFINITY)
        far = have & (torch.maximum(t_l, t_r) < INFINITY) & (ptr < depth - 1)
        i = ptr.clamp(max=depth - 1)[:, None]
        stack_ref.scatter_(1, i, torch.where(far[:, None], torch.where(near_is_left, right, left)[:, None],
                                             stack_ref.gather(1, i)))
        stack_t.scatter_(1, i, torch.where(far[:, None], torch.maximum(t_l, t_r)[:, None], stack_t.gather(1, i)))
        ptr = ptr + far.long()
        carried = torch.where(have, torch.where(near_is_left, left, right), carried)
        visits += inner.int()
        tests += leaf.int()
    return (t_best, tri_best, u_best, v_best), visits, tests, ties


@pytest.mark.parametrize("name", ["blob", "two", "one"])
def test_records_decode_to_the_builders_bvh(name):
    """Decoding the records in pre-order gives back node_tri, node_right and
    the boxes of the mesh's BVH bit for bit; one record per triangle (the
    header and T - 1 inner nodes); a 1-triangle mesh is its header alone,
    whose root reference is the leaf -1 - 0."""
    mesh = mesh_from_model(MODELS[name]())
    tables = mesh_tables(mesh)
    check_walk_tables(tables)
    assert tables.nodes.shape == (mesh.p0.shape[0], 4, 4)
    node_tri, node_right, node_min, node_max = decode(tables.nodes)
    torch.testing.assert_close(node_tri, mesh.node_tri, rtol=0, atol=0)
    torch.testing.assert_close(node_right, mesh.node_right, rtol=0, atol=0)
    torch.testing.assert_close(node_min, mesh.node_min.view(torch.int32), rtol=0, atol=0)
    torch.testing.assert_close(node_max, mesh.node_max.view(torch.int32), rtol=0, atol=0)
    if name == "one":
        assert tables.nodes.shape[0] == 1 and int(tables.nodes.view(torch.int32)[0, 0, 3]) == -1


@pytest.mark.parametrize("name,cull,depth", [("blob", True, 28), ("blob", False, 28), ("blob", True, 4),
                                             ("two", True, 28), ("one", True, 28), ("one", False, 28),
                                             ("doubled", True, 28), ("doubled", False, 28)])
def test_packed_walk_is_the_plain_walk(name, cull, depth):
    """The kernel's walk over the packed records against traverse_bvh: t,
    tri, u, v bit for bit and, per lane, the same inner-node visits and
    triangle tests; some rays miss the root box, others hit.  At depth 4
    the stack overflows, and both drop the same entries (the plain walk's
    clamped pushes, the kernel's far child left out)."""
    mesh = mesh_from_model(MODELS[name]())
    tables = mesh_tables(mesh)
    ro, rd = rays(mesh)
    got, visits, tests, ties = packed_walk(tables.nodes, tables.tris, ro, rd, cull, depth)
    steps = []
    ref = traverse_bvh(mesh.node_tri, mesh.node_right, mesh.node_min, mesh.node_max, mesh.p0, mesh.p1, mesh.p2, ro,
                       rd, cull, depth, steps_out=steps)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(visits, steps[0], rtol=0, atol=0)
    torch.testing.assert_close(tests, steps[1], rtol=0, atol=0)
    if depth < MAX_STACK_DEPTH:  # the overflow really drops entries: some lanes lose their hit
        full = packed_walk(tables.nodes, tables.tris, ro, rd, cull)[0][1]
        assert bool((full != got[1]).any())
    root_t = _aabb_t(mesh.node_min[0], mesh.node_max[0], ro, safe_inv(rd), torch.full((ro.shape[0],), INFINITY))
    missed_root = root_t == INFINITY
    assert 0 < int(missed_root.sum()) < ro.shape[0] and int((got[1] >= 0).sum()) > 20
    assert bool((got[1][missed_root] == -1).all()) and int(tests[missed_root].sum()) == 0
    if name == "doubled":  # nearly every hit is a tie: the strict < keeps the copy visited first
        hit = got[1] >= 0
        assert int((ties[hit] > 0).sum()) > 0.9 * int(hit.sum())
    else:
        assert int(ties.sum()) == 0


@pytest.mark.parametrize("cull", [True, False])
def test_ties_go_where_jax_sends_them(cull):
    """On the doubled soup nearly every hit is a tie between two copies, and
    the port's walk (the kernel's plain version) picks the same triangle ids as
    the JAX package's per-lane walk: the same visit order decides."""
    model = blob_model(64)
    jmesh = j_mesh_from_model(doubled_model(JGLTFModel(*model)))
    mesh = mesh_from_model(doubled_model(model))
    ro, rd = rays(mesh)
    ref = j_traverse_bvh(jmesh.node_tri, jmesh.node_right, jmesh.node_min, jmesh.node_max, jmesh.p0, jmesh.p1,
                         jmesh.p2, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()), jnp.asarray(cull), 28)
    got = traverse_bvh(mesh.node_tri, mesh.node_right, mesh.node_min, mesh.node_max, mesh.p0, mesh.p1, mesh.p2, ro,
                       rd, cull)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int((got[1] >= 0).sum()) > 200


def test_walk_tables_are_checked():
    """The kernels' wrappers refuse node tables in another layout: the old
    (M, 2, 4) node records, a record count that is not one per triangle,
    non-contiguous records."""
    mesh = mesh_from_model(blob_model(8))
    tables = mesh_tables(mesh)
    check_walk_tables(tables)
    old = torch.zeros(2 * 8 - 1, 2, 4)
    for bad in (tables._replace(nodes=old), tables._replace(nodes=tables.nodes[:-1]),
                tables._replace(tris=tables.tris.transpose(0, 1).contiguous().transpose(0, 1))):
        with pytest.raises(ValueError):
            check_walk_tables(bad)
