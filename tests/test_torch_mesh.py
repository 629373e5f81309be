"""The mesh family of the port against the JAX package: the BVH builders
(numpy and native), the per-lane walk, the model section of the closest hit,
the glTF scene and loader, scene conversion, and the glTF demo's render.

The blob is the random triangle soup of the JAX kernel tests
(tests/test_kernels.py ``_synthetic_mesh``) with 128 triangles, scaled by
1.5, turned and placed in front of the demo camera so that it takes 18.8%
(DIFFUSE) and 38.9% (TRANSPARENT, double-sided) of the first hits at 32x128
(the demo's own placement: 0-1 of 4,096 lanes).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.accel import builder as jbuilder
from bpt_tpu.accel.traverse import intersect_mesh_bvh as j_intersect_mesh_bvh
from bpt_tpu.accel.traverse import traverse_bvh as j_traverse_bvh
from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.core.vecmath import transform_dir as j_transform_dir
from bpt_tpu.core.vecmath import transform_point as j_transform_point
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.integrator.frame import trace_image as j_trace_image
from bpt_tpu.integrator.intersect import _empty_hit as j_empty_hit
from bpt_tpu.io.gltf import GLTFModel as JGLTFModel
from bpt_tpu.io.gltf import load_gltf as j_load_gltf
from bpt_tpu.scenes.types import Quads as JQuads
from bpt_tpu.scenes.types import Scene as JScene
from bpt_tpu.scenes.types import TriangleMesh as JTriangleMesh
from bpt_tpu.scenes.types import UnitSpheres as JUnitSpheres
from bpt_tpu_torch import convert
from bpt_tpu_torch.accel import builder
from bpt_tpu_torch.accel.native import load as load_native
from bpt_tpu_torch.accel.traverse import _tri_t_uv, intersect_mesh_bvh, traverse_bvh
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.integrator.frame import trace_image
from bpt_tpu_torch.integrator.intersect import _empty_hit
from bpt_tpu_torch.io.gltf import GLTFModel, load_gltf
from bpt_tpu_torch.kernels import megakernel
from bpt_tpu_torch.scenes import gltf_scene
from bpt_tpu_torch.scenes.types import DIFFUSE, TRANSPARENT, mesh_tables
from test_torch_apps import write_glb
from test_torch_kernels import blob_model, textured_model

torch.set_num_threads(2)
jgltf = importlib.import_module("bpt_tpu.scenes.gltf_scene")  # bpt_tpu.scenes exports a function of that name

BN = blue_noise_table()
RV = np.array([0.3, 0.7], np.float32)
PLACE = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5), translation=(0.0, -20.0, -85.0))
MESH_ID = 8.0  # 2 spheres + 6 quads precede the mesh


def _np(x):
    return jax.tree.map(np.asarray, x)


def blob(T=128, seed=0, cls=GLTFModel):
    """tests/test_kernels.py's random triangle blob, T triangles, as the
    port's GLTFModel or (cls) the JAX package's."""
    return cls(*blob_model(T, seed))


# ---- the BVH builders ---------------------------------------------------------

def _aabbs(case):
    if case == "heightfield":  # bench.py's capacity mesh at n_side 64: 8,192 triangles
        m = gltf_scene.heightfield_model(n_side=64)
        return builder.triangle_aabbs(m.p0, m.p1, m.p2)[:2]
    return np.zeros((33, 3), np.float32), np.ones((33, 3), np.float32)  # coincident centroids


@pytest.mark.parametrize("case", ["heightfield", "coincident"])
@pytest.mark.parametrize("build", ["build_bvh", "build_bvh_sah"])
@pytest.mark.parametrize("native", ["never", "require"])
def test_builders_match_jax_bitwise(case, build, native):
    """The port's numpy and native (C++, compiled into _build/) builds equal
    JAX's numpy build array for array, on bench.py's heightfield and on the
    coincident-centroid case of tests/test_native.py (the even/odd fallback)."""
    mn, mx = _aabbs(case)
    got = getattr(builder, build)(mn, mx, use_native=native)
    ref = getattr(jbuilder, build)(mn, mx, use_native="never")
    for name in ("node_tri", "node_right", "node_min", "node_max"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.max_depth == ref.max_depth
    if native == "require":
        assert load_native() is not None and "_build" in str(load_native()._name)


# ---- the walk -------------------------------------------------------------------

@pytest.mark.parametrize("cull", [False, True])
def test_traversal_matches_brute_force(cull):
    """tests/test_mesh.py's brute-force check on the port's walk: the random
    soup (128 triangles, seed 3), 64 random rays aimed near triangle
    centres, t within rtol 1e-5 of the nearest of all triangles and equal to
    its winner's own test."""
    rng = np.random.default_rng(3)
    centers = rng.uniform(-10, 10, (128, 3))
    offsets = rng.normal(0, 0.5, (128, 2, 3))
    p0, p1, p2 = (x.astype(np.float32) for x in (centers, centers + offsets[:, 0], centers + offsets[:, 1]))
    bvh = builder.build_bvh(*builder.triangle_aabbs(p0, p1, p2)[:2])
    rng = np.random.default_rng(7)
    ro = torch.as_tensor(rng.uniform(-20, 20, (64, 3)), dtype=torch.float32)
    aim = ((p0 + p1 + p2) / 3.0)[rng.integers(0, 128, 64)] + rng.normal(0, 0.05, (64, 3))
    rd = torch.as_tensor(aim, dtype=torch.float32) - ro
    rd = rd / torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
    tp = [torch.as_tensor(p) for p in (p0, p1, p2)]
    t, tri, u, v = traverse_bvh(*(torch.as_tensor(a) for a in bvh[:4]), *tp, ro, rd, cull)
    tb, _, _ = _tri_t_uv(*(p[None] for p in tp), ro[:, None], rd[:, None], cull)
    np.testing.assert_allclose(t.numpy(), tb.amin(dim=1).numpy(), rtol=1e-5)
    hit = tri >= 0
    assert int(hit.sum()) > 16
    np.testing.assert_array_equal(tb[hit, tri[hit]].numpy(), t[hit].numpy())


def test_walk_reports_the_records_it_reads():
    """For measurement the walk reports the node and triangle records it
    read: per ray, the root and the two children of each visited inner node
    (1 + 2 visits, each node the child of one parent) and each tested
    triangle once; over many rays, the union of the rays' own masks."""
    m = gltf_scene.heightfield_model(n_side=8)
    bvh = builder.build_bvh_sah(*builder.triangle_aabbs(m.p0, m.p1, m.p2)[:2])
    tables = [torch.as_tensor(a) for a in (*bvh[:4], m.p0, m.p1, m.p2)]
    rng = np.random.default_rng(4)
    ro = torch.as_tensor(rng.uniform(-40, 40, (32, 3)) + np.array([0.0, 30.0, 0.0]), dtype=torch.float32)
    rd = torch.as_tensor(rng.normal(0, 0.3, (32, 3)) + np.array([0.0, -1.0, 0.0]), dtype=torch.float32)
    union = [torch.zeros(bvh.node_tri.shape[0], dtype=torch.bool), torch.zeros(m.p0.shape[0], dtype=torch.bool)]
    for i in range(32):
        out = []
        traverse_bvh(*tables, ro[i:i + 1], rd[i:i + 1], True, steps_out=out)
        visits, tests, node_read, tri_read = out
        assert int(node_read.sum()) == 1 + 2 * int(visits.sum()) and int(tri_read.sum()) == int(tests.sum())
        union = [union[0] | node_read, union[1] | tri_read]
    out = []
    _, tri, _, _ = traverse_bvh(*tables, ro, rd, True, steps_out=out)
    assert int((tri >= 0).sum()) > 8 and int(out[1].sum()) > 32
    assert torch.equal(out[2], union[0]) and torch.equal(out[3], union[1])
    assert bool(out[3][tri[tri >= 0]].all())  # every winner was tested


def test_mesh_tables_are_the_kernels_layout():
    """mesh_tables packs the BVH into child-pair records of 64 bytes (a
    header with the root's box and reference, then per inner node, in
    pre-order, both children's boxes and references: an inner child's
    record, or -1 - the triangle of a leaf, int32 bits in the w lanes) and
    the soup into 16-byte vertex records; Scene.to drops them off the
    card."""
    mesh = gltf_scene.mesh_from_model(blob(16))
    tables = mesh_tables(mesh)
    node_tri, node_right = mesh.node_tri.long(), mesh.node_right.long()
    inner = torch.nonzero(node_tri < 0).squeeze(1)
    assert tables.nodes.shape == (1 + inner.numel(), 4, 4) == (16, 4, 4) and tables.nodes.dtype == torch.float32
    ref = torch.where(node_tri < 0, torch.cumsum((node_tri < 0).long(), 0), -1 - node_tri)
    bits = tables.nodes.view(torch.int32)
    box_bits = mesh.node_min.view(torch.int32), mesh.node_max.view(torch.int32)
    left, right = inner + 1, node_right[inner]
    assert bits[0, 0, 3] == ref[0] and ref[0] == 1
    torch.testing.assert_close(bits[0, 0, :3], box_bits[0][0], rtol=0, atol=0)
    torch.testing.assert_close(bits[0, 1, :3], box_bits[1][0], rtol=0, atol=0)
    torch.testing.assert_close(bits[0, 1:, 3], torch.zeros(3, dtype=torch.int32), rtol=0, atol=0)
    torch.testing.assert_close(bits[0, 2:], torch.zeros(2, 4, dtype=torch.int32), rtol=0, atol=0)
    for k, (child, box) in enumerate(((left, 0), (left, 1), (right, 0), (right, 1))):
        torch.testing.assert_close(bits[1:, k, :3], box_bits[box][child], rtol=0, atol=0)
    torch.testing.assert_close(bits[1:, 0, 3].long(), ref[left], rtol=0, atol=0)
    torch.testing.assert_close(bits[1:, 1, 3].long(), ref[right], rtol=0, atol=0)
    assert not bits[1:, 2:, 3].any()
    for k, (p, n) in enumerate(zip((mesh.p0, mesh.p1, mesh.p2), (mesh.n0, mesh.n1, mesh.n2))):
        torch.testing.assert_close(tables.tris[:, k, :3], p, rtol=0, atol=0)
        torch.testing.assert_close(tables.normals[:, k, :3], n, rtol=0, atol=0)
    scene = gltf_scene.gltf_scene(mesh._replace(kernel_tables=tables))
    assert scene.to("cpu").mesh.kernel_tables is None and scene.to("meta").mesh.kernel_tables is None


def _blob_rays(n=4096, seed=5):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    ro[:, 2] -= 120.0
    tgt = rng.normal(0, 12, (n, 3)).astype(np.float32) + np.array(PLACE["translation"], np.float32)
    rd = tgt - ro
    return ro, (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def blob_meshes():
    jmesh = jgltf.mesh_from_model(blob(cls=JGLTFModel), mat_type=DIFFUSE, **PLACE)
    return jmesh, convert.scene_from_numpy(_np(JScene(mesh=jmesh))).mesh


@pytest.mark.parametrize("cull", [True, False])
def test_walk_matches_jax(blob_meshes, cull):
    """The port's walk against JAX's per-lane walk on the same object-space
    rays into the turned, scaled blob: triangle ids exact, every miss equal;
    t within rtol 1e-5 and u, v within 2e-5.  Not bit-equal: XLA sums JAX's
    dot products (jnp.sum) and crosses in another order than the port and
    its CUDA kernel, which write them out (x + y) + z; measured 2.5e-6 (t)
    and 8.6e-6 (u, v) at most, up to 38 ulp on t."""
    jmesh, mesh = blob_meshes
    ro, rd = _blob_rays()
    ro_o = np.array(j_transform_point(jmesh.inv_matrix, jnp.asarray(ro)))
    rd_o = np.array(j_transform_dir(jmesh.inv_matrix, jnp.asarray(rd)))
    ref = [np.asarray(x) for x in j_traverse_bvh(jmesh.node_tri, jmesh.node_right, jmesh.node_min, jmesh.node_max,
                                                  jmesh.p0, jmesh.p1, jmesh.p2, jnp.asarray(ro_o),
                                                  jnp.asarray(rd_o), jnp.asarray(cull), 28)]
    steps = []
    got = [x.numpy() for x in traverse_bvh(mesh.node_tri, mesh.node_right, mesh.node_min, mesh.node_max, mesh.p0,
                                           mesh.p1, mesh.p2, torch.as_tensor(ro_o), torch.as_tensor(rd_o), cull,
                                           steps_out=steps)]
    hit = ref[1] >= 0
    assert 0.3 < hit.mean() < 0.7
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0][~hit], ref[0][~hit])
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-5)
    np.testing.assert_allclose(got[2][hit], ref[2][hit], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got[3][hit], ref[3][hit], rtol=0, atol=2e-5)
    visits, tests = (s.numpy() for s in steps[:2])
    assert (tests[hit] >= 1).all() and visits.max() > 1 and visits.sum() > 0


def test_intersect_mesh_bvh_matches_jax(blob_meshes):
    """The model section of the closest hit on world-space rays: ids and
    materials exact; t, normals and uv within 2e-5 (the transforms and the
    walk's arithmetic differ in summation order, as above); the walk skips
    the inactive lanes, which miss."""
    jmesh, mesh = blob_meshes
    ro, rd = _blob_rays()
    ref = j_intersect_mesh_bvh(jmesh, jnp.asarray(ro), jnp.asarray(rd), j_empty_hit((4096,)), 8)
    got = intersect_mesh_bvh(mesh, torch.as_tensor(ro), torch.as_tensor(rd), _empty_hit((4096,), "cpu"), 8)
    np.testing.assert_array_equal(got.object_id.numpy(), np.asarray(ref.object_id))
    np.testing.assert_array_equal(got.mat_type.numpy(), np.asarray(ref.mat_type))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=2e-5)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(ref.normal), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(ref.uv), rtol=0, atol=2e-5)
    active = torch.as_tensor(np.arange(4096) % 2 == 0)
    half = intersect_mesh_bvh(mesh, torch.as_tensor(ro), torch.as_tensor(rd), _empty_hit((4096,), "cpu"), 8,
                              active=active)
    torch.testing.assert_close(half.t[active], got.t[active], rtol=0, atol=0)
    assert bool((half.object_id[~active] < 0).all())


# ---- scenes, conversion, the loader ------------------------------------------

def test_mesh_from_model_and_gltf_scene_match_jax():
    """The port's mesh_from_model (binned SAH, native builder) and gltf_scene
    equal the converted JAX scene field by field: the soup and the BVH
    exactly, the inverse matrices within 1e-6 (both invert in float32)."""
    ref = convert.scene_from_numpy(_np(jgltf.gltf_scene(jgltf.mesh_from_model(blob(cls=JGLTFModel), **PLACE))))
    got = gltf_scene.gltf_scene(gltf_scene.mesh_from_model(blob(), **PLACE))
    for group in ("quads", "spheres", "mesh"):
        for name, a, b in zip(getattr(got, group)._fields, getattr(got, group), getattr(ref, group)):
            assert (a is None) == (b is None), (group, name)
            if a is None:
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, (group, name)
            atol = 1e-6 if name == "inv_matrix" else 0.0
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol, err_msg=f"{group}.{name}")


def test_convert_carries_the_mesh():
    """JAX gltf_scene -> port -> numpy -> a JAX scene again: every carried
    field (the soup, the BVH, the transform, the material) exact, the four
    maps None on both sides for this untextured mesh
    (tests/test_torch_textures.py carries a textured one); the TPU packs
    stay behind."""
    src = _np(jgltf.gltf_scene(jgltf.mesh_from_model(blob(cls=JGLTFModel), mat_type=TRANSPARENT, **PLACE)))
    port = convert.scene_from_numpy(src)
    assert set(port.mesh._fields) >= set(convert.MESH_FIELDS) and port.mesh.albedo is None
    back = convert.to_numpy(port)
    rebuilt = JScene(quads=JQuads(**back.quads._asdict()), spheres=JUnitSpheres(**back.spheres._asdict()),
                     mesh=JTriangleMesh(**{f: getattr(back.mesh, f) for f in convert.MESH_FIELDS}))
    for group in ("quads", "spheres", "mesh"):
        fields = convert.MESH_FIELDS if group == "mesh" else getattr(src, group)._fields
        for name in fields:
            a, b = getattr(getattr(rebuilt, group), name), getattr(getattr(src, group), name)
            if b is None:  # a map this mesh does not have
                assert a is None, (group, name)
                continue
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"{group}.{name}")
            assert np.asarray(a).dtype == b.dtype, (group, name)


def test_load_gltf_matches_jax(tmp_path):
    """The port's loader reads a GLB (node transform, RH -> LH flip, initial
    scale, winding repair) exactly as JAX's does."""
    m = blob(16, seed=2)
    path = tmp_path / "soup.glb"
    write_glb(path, m.p0, m.p1, m.p2)
    got = load_gltf(str(path), initial_scale=2.0)
    ref = j_load_gltf(str(path), initial_scale=2.0)
    assert got.triangle_count == 16 and got.albedo is None
    for name, a, b in zip(got._fields, got, ref):
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_textured_models_and_meshes_are_refused():
    """Textured models were refused until textured PBR was ported; now
    mesh_from_model carries the albedo (the mesh is PBR_MATERIAL to the
    walk) and the conversion carries a JAX mesh's albedo, so neither
    raises.  (tests/test_torch_textures.py holds the textured family to JAX.)"""
    textured = blob(8)._replace(albedo=np.ones((4, 4, 3), np.float32))
    mesh = gltf_scene.mesh_from_model(textured)
    assert mesh.albedo.shape == (4, 4, 3) and mesh.albedo.dtype == torch.float32
    jmesh = jgltf.mesh_from_model(blob(8, cls=JGLTFModel))._replace(albedo=jnp.ones((4, 4, 3)))
    port = convert.scene_from_numpy(_np(JScene(mesh=jmesh))).mesh
    np.testing.assert_array_equal(port.albedo.numpy(), np.ones((4, 4, 3), np.float32))


# ---- the glTF demo's render ------------------------------------------------------

@pytest.fixture(scope="module")
def gltf_renders():
    """JAX's wavefront render of the blob scene per material, computed once
    (the first JAX walk compiles for ~14 s on this CPU)."""
    out = {}
    for mat in (DIFFUSE, TRANSPARENT):
        jscene = jgltf.gltf_scene(jgltf.mesh_from_model(blob(cls=JGLTFModel), mat_type=mat, **PLACE))
        ref = j_trace_image(jscene, jgltf.gltf_camera(), JConfig(bounces=2), 128, 32, 2.0, jnp.asarray(RV),
                            jnp.asarray(BN))
        out[mat] = (jscene, _np(ref))
    return out


@pytest.mark.parametrize("mat", [DIFFUSE, TRANSPARENT])
def test_gltf_trace_image_matches_jax(gltf_renders, mat):
    """The glTF demo's configuration (quad NEE, 2 bounces, 32x128, frame 2)
    with the blob DIFFUSE and TRANSPARENT, by the Cornell bar: >= 99.5% of
    lanes with color within rtol 1e-4 / atol 1e-5 (measured 100%), first-hit
    normals within rtol 1e-3 / atol 1e-4, object colors, ids and >= 99% of
    sharpness flags equal; the mesh takes >= 10% of the first hits."""
    jscene, ref = gltf_renders[mat]
    tscene = convert.scene_from_numpy(_np(jscene))
    tcam = convert.camera_from_numpy(_np(jgltf.gltf_camera()))
    got = trace_image(tscene, tcam, IntegratorConfig(bounces=2), 128, 32, 2.0, RV, torch.as_tensor(BN))
    share = float((got.object_id.numpy() == MESH_ID).mean())
    assert share >= 0.10, share
    close = np.isclose(got.color.numpy(), ref.color, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() > 0.995, f"color parity {close.mean():.4f}"
    np.testing.assert_allclose(got.object_normal.numpy(), ref.object_normal, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.object_color.numpy(), ref.object_color, rtol=1e-6)
    np.testing.assert_array_equal(got.object_id.numpy(), ref.object_id)
    assert (got.pixel_sharpness.numpy() == ref.pixel_sharpness).mean() > 0.99
    assert got.color.numpy().max() > 0.0


def test_normal_map_only_trace_image_matches_jax():
    """A normal map without an albedo on the TRANSPARENT blob (with random
    UVs, test_torch_kernels.textured_model): the kernel's textured
    configuration with the mesh's own material (double-sided) and no PBR
    decode.  The glTF demo's configuration against JAX's wavefront by the
    textured renders' bars (tests/test_torch_textures.py): fewer than 2% of
    lanes off by more than 1e-3 and the 95th percentile below 1e-3
    (measured 0% and 0), first-hit ids equal, fewer than 1% of first-hit
    normals off by more than 2e-3 (the bump map amplifies the walk's uv
    difference; measured 0%, the largest 5.2e-4); the lane counts show
    normal-map samples only and no PBR hit."""
    model = textured_model(normal=True, albedo=False)
    jscene = jgltf.gltf_scene(jgltf.mesh_from_model(JGLTFModel(*model), mat_type=TRANSPARENT, **PLACE))
    ref = _np(j_trace_image(jscene, jgltf.gltf_camera(), JConfig(bounces=2), 128, 32, 2.0, jnp.asarray(RV),
                            jnp.asarray(BN)))
    scene, cfg = convert.scene_from_numpy(_np(jscene)), IntegratorConfig(bounces=2)
    assert scene.mesh.albedo is None and scene.mesh.normal_map is not None
    assert megakernel.configuration(scene, cfg) == "textured"
    counts = []
    got = trace_image(scene, convert.camera_from_numpy(_np(jgltf.gltf_camera())), cfg, 128, 32, 2.0, RV,
                      torch.as_tensor(BN), lane_counts=counts)
    d = np.abs(got.color.numpy() - ref.color).max(-1)
    assert (d > 1e-3).mean() < 0.02 and np.quantile(d, 0.95) < 1e-3, (float((d > 1e-3).mean()), np.quantile(d, 0.95))
    np.testing.assert_array_equal(got.object_id.numpy(), ref.object_id)
    assert (got.object_id.numpy() == MESH_ID).mean() >= 0.10
    dn = np.abs(got.object_normal.numpy() - ref.object_normal).max(-1)
    assert (dn > 2e-3).mean() < 0.01, float((dn > 2e-3).mean())
    samples = sum(c.texel_samples for c in counts).tolist()
    assert samples[1] > 0 and sum(samples) == samples[1], samples
    assert sum(sum(c.pbr_classes for c in counts).tolist()) == 0


def test_lane_counts_report_the_walk():
    """The measurement hook counts the walk's inner-node visits and triangle
    tests on live lanes and reports the mesh records read, and the
    renderer's first bounce hits the mesh."""
    from bpt_tpu_torch.core.rng import blue_noise_table as t_blue_noise_table
    from bpt_tpu_torch.integrator.radiance import LaneCounts

    scene = gltf_scene.gltf_scene(gltf_scene.mesh_from_model(blob(), **PLACE))
    counts: list[LaneCounts] = []
    trace_image(scene, gltf_scene.gltf_camera(), IntegratorConfig(bounces=3), 32, 16, 2.0, RV,
                torch.as_tensor(t_blue_noise_table()), lane_counts=counts)
    assert len(counts) == 3 and all(int(c.tri_tests) > 0 and int(c.node_visits) > 0 for c in counts)
    assert int(counts[0].node_visits) >= int(counts[0].hits) > 0
    for c in counts:  # the records read: a winner's normals only where it was tested
        nodes, tris, normals = c.mesh_reads
        assert int(nodes.sum()) > 0 and bool(tris[normals].all()) and int(normals.sum()) <= int(c.hits)
