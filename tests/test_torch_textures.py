"""Textured PBR meshes in the port against the JAX package: the texture
samplers and the normal map, the textured mesh's construction, conversion
and kernel tables, the model section of the closest hit, the textured
renders of the glTF and HDRI demos (constant and per-texel varying
decision maps, an emissive map, the metal roughness lobe, sun and env NEE),
the lobe's draw order under quad NEE, the glTF loader and its description
on a textured two-material file, and the three glTF demo CLIs on it.

The blob is tests/test_kernels.py's random triangle soup (128 triangles),
scaled by 1.5, turned and placed in front of each demo camera, with random
per-vertex UVs in [-1.5, 2.5] so that every map wraps both ways and each
triangle spans several periods of it (test_torch_kernels.textured_model).  JAX's wavefront walks are compiled
once per process: its renders are made once, in one module fixture.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu import textures as jtextures
from bpt_tpu.camera import generate_rays as j_generate_rays
from bpt_tpu.core.rng import blue_noise_fetch as j_blue_noise_fetch
from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.core.rng import rng_seed as j_rng_seed
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.integrator.frame import pixel_grid as j_pixel_grid
from bpt_tpu.integrator.frame import trace_image as j_trace_image
from bpt_tpu.integrator.intersect import scene_intersect as j_scene_intersect
from bpt_tpu.integrator.radiance import calculate_radiance as j_calculate_radiance
from bpt_tpu.io.gltf import GLTFModel as JGLTFModel
from bpt_tpu.io.gltf import describe_gltf as j_describe_gltf
from bpt_tpu.io.gltf import load_gltf as j_load_gltf
from bpt_tpu.scenes.cornell import cornell_camera as j_cornell_camera
from bpt_tpu.scenes.cornell import cornell_scene as j_cornell_scene
from bpt_tpu.scenes.types import Scene as JScene
from bpt_tpu_torch import convert, textures
from bpt_tpu_torch.apps.hdri_environment import synthetic_hdr
from bpt_tpu_torch.camera import generate_rays
from bpt_tpu_torch.core.rng import blue_noise_fetch, rng_seed
from bpt_tpu_torch.core.vecmath import normalize
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.integrator.frame import pixel_grid, trace_image
from bpt_tpu_torch.integrator.intersect import scene_intersect
from bpt_tpu_torch.integrator.radiance import calculate_radiance
from bpt_tpu_torch.io import describe_gltf, load_gltf
from bpt_tpu_torch.io.gltf import GLTFModel
from bpt_tpu_torch.kernels import megakernel
from bpt_tpu_torch.scenes import gltf_scene
from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
from bpt_tpu_torch.scenes.types import DIFFUSE, PBR_MATERIAL, TRANSPARENT, Scene, mesh_tables
from test_torch_kernels import blob_model, textured_model

torch.set_num_threads(2)
jgltf = importlib.import_module("bpt_tpu.scenes.gltf_scene")  # bpt_tpu.scenes exports a function of that name

BN = blue_noise_table()
RV = np.array([0.3, 0.7], np.float32)
BOX = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5), translation=(0.0, -20.0, -85.0))
SKY = dict(BOX, translation=(0.0, 0.0, -165.0))
H, W = 32, 128


def _np(x):
    return jax.tree.map(np.asarray, x)


def textured_blob(cls=GLTFModel, **maps):
    """test_torch_kernels.textured_model as the port's GLTFModel or (cls)
    the JAX package's."""
    return cls(*textured_model(**maps))


# ---- the samplers and the normal map ------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 7, 3), (16, 16, 3), (8, 4, 1)])
def test_samplers_match_jax(shape):
    """sample_bilinear and sample_nearest against bpt_tpu.textures on UVs in
    [-2, 3] (REPEAT wrap both ways, the floored modulo): nearest exactly,
    bilinear within 2e-7 absolute (measured 6e-8; one rounding of the
    combine, which XLA may contract into FMAs)."""
    rng = np.random.default_rng(sum(shape))
    tex = rng.uniform(0, 1, shape).astype(np.float32)
    uv = rng.uniform(-2, 3, (4096, 2)).astype(np.float32)
    uv[:8] = [[-1.0, -1.0], [0.0, 0.0], [1.0, 1.0], [2.0, -2.0], [-0.5, 2.5], [3.0, 0.999], [-1e-4, 1e-4],
              [0.5, -0.5]]
    ref_b = np.asarray(jtextures.sample_bilinear(jnp.asarray(tex), jnp.asarray(uv)))
    ref_n = np.asarray(jtextures.sample_nearest(jnp.asarray(tex), jnp.asarray(uv)))
    t_tex, t_uv = torch.as_tensor(tex), torch.as_tensor(uv)
    np.testing.assert_allclose(textures.sample_bilinear(t_tex, t_uv).numpy(), ref_b, rtol=0, atol=2e-7)
    np.testing.assert_array_equal(textures.sample_nearest(t_tex, t_uv).numpy(), ref_n)
    read = textures.texels_read(t_tex, t_uv[:1])
    assert int(read.sum()) == 4 and bool(read[0, 0]) and bool(read[-1, -1])  # uv (-1, -1) wraps to the corners


def test_perturb_normal_matches_jax():
    """perturb_normal against bpt_tpu.textures on random normals (both
    branches of the |n.y| < 0.9 frame) and a random map: within 1e-6."""
    rng = np.random.default_rng(11)
    n = rng.normal(0, 1, (2048, 3)).astype(np.float32)
    n[:512, 1] *= 20.0  # |n.y| >= 0.9 after normalisation
    nmap = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    uv = rng.uniform(-2, 3, (2048, 2)).astype(np.float32)
    ref = np.asarray(jtextures.perturb_normal(jnp.asarray(n), jnp.asarray(nmap), jnp.asarray(uv)))
    got = textures.perturb_normal(torch.as_tensor(n), torch.as_tensor(nmap), torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_perturb_normal_identity_and_tilt():
    """tests/test_mesh.py's check on the port: a flat (0.5, 0.5, 1) map is
    the identity; tilting its x channel turns the normal toward the
    cross-trick tangent S = cross(up, n)."""
    n = normalize(torch.tensor([[0.3, 0.1, 0.9], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]))
    uv = torch.full((3, 2), 0.5)
    flat = torch.full((4, 4, 3), 0.5)
    flat[..., 2] = 1.0
    torch.testing.assert_close(textures.perturb_normal(n, flat, uv), n, rtol=1e-5, atol=1e-6)
    tilted = flat.clone()
    tilted[..., 0] = 1.0
    out = textures.perturb_normal(n, tilted, uv).numpy()
    nn = n.numpy()
    for i in range(3):
        up = np.array([0.0, 1.0, 0.0]) if abs(nn[i, 1]) < 0.9 else np.array([1.0, 0.0, 0.0])
        s = np.cross(up, nn[i])
        s /= np.linalg.norm(s)
        mapn = np.array([0.5, 0.0, 0.5]) / np.linalg.norm([0.5, 0.0, 0.5])
        expect = s * mapn[0] + nn[i] * mapn[2]
        np.testing.assert_allclose(out[i], expect / np.linalg.norm(expect), rtol=1e-5, atol=1e-6)


def test_normal_map_changes_mesh_shading_normal():
    """tests/test_mesh.py's floor quad on the port: a flat map leaves the
    first-hit normals at +y, a bump map turns most of them away."""
    p = np.array([[[-50, -20, -50], [50, -20, 50], [50, -20, -50]],
                  [[-50, -20, -50], [-50, -20, 50], [50, -20, 50]]], np.float32)
    uvs = np.array([[[0, 0], [1, 1], [1, 0]], [[0, 0], [0, 1], [1, 1]]], np.float32)
    ny = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (2, 3, 1))
    rng = np.random.default_rng(3)
    bump = 0.5 + 0.3 * rng.standard_normal((16, 16, 3)).astype(np.float32)
    bump[..., 2] = 1.0
    flat = np.full((16, 16, 3), 0.5, np.float32)
    flat[..., 2] = 1.0

    def mk(nm):
        model = GLTFModel(p0=p[:, 0], p1=p[:, 1], p2=p[:, 2], n0=ny[:, 0], n1=ny[:, 1], n2=ny[:, 2],
                          uv0=uvs[:, 0], uv1=uvs[:, 1], uv2=uvs[:, 2], albedo=np.full((4, 4, 3), 0.8, np.float32),
                          normal_map=nm, metallic_roughness=None, emissive=None)
        return Scene(mesh=gltf_scene.mesh_from_model(model, mat_type=DIFFUSE))

    ro = torch.zeros(8, 8, 3)
    ro[..., 1] = 20.0
    py, px = np.mgrid[0:8, 0:8].astype(np.float32)
    rd = normalize(torch.as_tensor(np.stack([(px - 3.7) / 8, -np.ones_like(px), (py - 4.2) / 9], -1)))
    h_flat = scene_intersect(mk(flat), ro, rd)
    h_bump = scene_intersect(mk(bump), ro, rd)
    assert bool((h_flat.t < 1e6).all()) and bool((h_flat.mat_type == PBR_MATERIAL).all())
    torch.testing.assert_close(h_flat.normal, torch.tensor([0.0, 1.0, 0.0]).expand(8, 8, 3), rtol=0, atol=1e-5)
    assert ((1.0 - h_bump.normal[..., 1]) > 1e-3).float().mean().item() > 0.8


# ---- the textured mesh: construction, conversion, tables ---------------------------

def test_textured_mesh_carries_its_maps():
    """mesh_from_model carries the four maps as (H, W, 3) float32 tensors;
    a JAX textured mesh converts with its four maps (its quad-packed twins
    stay behind) and back; Scene.to moves them; the kernel's tables add the
    UV records (uv0, uv1, uv2) and no copy of the maps, which the kernel
    reads from the mesh."""
    model = textured_blob(mr=(0.0, 0.3, 0.8), emissive=(0.4, 0.2, 0.1), normal=True)
    mesh = gltf_scene.mesh_from_model(model, **BOX)
    for name in ("albedo", "normal_map", "metallic_roughness", "emissive"):
        got = getattr(mesh, name)
        assert got.dtype == torch.float32 and got.shape[-1] == 3, name
        np.testing.assert_array_equal(got.numpy(), getattr(model, name), err_msg=name)
    jmesh = jgltf.mesh_from_model(textured_blob(mr=(0.0, 0.3, 0.8), emissive=(0.4, 0.2, 0.1), normal=True,
                                                cls=JGLTFModel), **BOX)
    assert jmesh.albedo_q is not None
    port = convert.scene_from_numpy(_np(JScene(mesh=jmesh))).mesh
    for name in ("albedo", "normal_map", "metallic_roughness", "emissive", "uv0", "node_tri"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(jmesh, name)), err_msg=name)
    back = convert.to_numpy(port)
    np.testing.assert_array_equal(back.emissive, np.asarray(jmesh.emissive))
    assert gltf_scene.gltf_scene(port).to("meta").mesh.albedo.device.type == "meta"
    tables = mesh_tables(mesh)
    assert tables.uvs.shape == (128, 3, 2) and tables.uvs.is_contiguous()
    for i, uv in enumerate((mesh.uv0, mesh.uv1, mesh.uv2)):
        torch.testing.assert_close(tables.uvs[:, i], uv, rtol=0, atol=0)
    assert tables._fields == ("nodes", "tris", "normals", "uvs", "source")
    for name in ("albedo", "normal_map", "metallic_roughness", "emissive"):
        assert getattr(mesh, name).is_contiguous(), name  # as the kernel reads it
    assert mesh_tables(mesh._replace(albedo=None)).uvs is not None  # a normal map alone is textured
    plain = mesh_tables(gltf_scene.mesh_from_model(blob_model(8)))
    assert plain.uvs is None


@pytest.fixture(scope="module")
def intersect_cases():
    """The textured blob (normal map on) as JAX's and the port's mesh, and
    world-space rays into it."""
    jmesh = jgltf.mesh_from_model(textured_blob(mr=(0.0, 0.3, 0.0), normal=True, cls=JGLTFModel), mat_type=TRANSPARENT,
                                  **BOX)
    rng = np.random.default_rng(5)  # (H, W) rays: JAX's walk compiled for the renders' shape serves them
    ro = rng.uniform(-40, 40, (H, W, 3)).astype(np.float32)
    ro[..., 2] -= 120.0
    rd = rng.normal(0, 12, (H, W, 3)).astype(np.float32) + np.array(BOX["translation"], np.float32) - ro
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return jmesh, convert.scene_from_numpy(_np(JScene(mesh=jmesh))).mesh, ro, rd


def test_scene_intersect_textured_matches_jax(jax_renders, intersect_cases):
    """The model section of the closest hit on a textured mesh: hit / miss
    and the material (PBR_MATERIAL) exact; t within rtol 2e-5; uv within
    5e-5 (measured 2.7e-5: the walk's u, v differ from JAX's by up to 8.6e-6
    through summation order, and the UVs reach 2.5); the normal-mapped
    normal within 2e-3 (measured 6.4e-4: that uv difference times the slope
    of a random 16x16 bump map; with the same uv the two perturb_normal
    agree within 1.2e-7, test_perturb_normal_matches_jax); back faces culled
    although the mesh's own material is TRANSPARENT (an albedo always
    culls), where the untextured TRANSPARENT mesh is double-sided."""
    jmesh, mesh, ro, rd = intersect_cases
    ref = j_scene_intersect(JScene(mesh=jmesh), jnp.asarray(ro), jnp.asarray(rd))
    got = scene_intersect(Scene(mesh=mesh), torch.as_tensor(ro), torch.as_tensor(rd))
    hit = np.asarray(ref.t) < 1e6
    assert 0.2 < hit.mean() < 0.8
    np.testing.assert_array_equal(got.t.numpy() < 1e6, hit)
    np.testing.assert_array_equal(got.mat_type.numpy(), np.asarray(ref.mat_type))
    assert bool((got.mat_type[torch.as_tensor(hit)] == PBR_MATERIAL).all())
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=2e-5)
    np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(ref.normal)[hit], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got.uv.numpy()[hit], np.asarray(ref.uv)[hit], rtol=0, atol=5e-5)
    double = scene_intersect(Scene(mesh=mesh._replace(albedo=None, normal_map=None)), torch.as_tensor(ro),
                             torch.as_tensor(rd))
    assert int((double.t < 1e6).sum()) > int(hit.sum())  # untextured TRANSPARENT: double-sided


# ---- the textured renders -----------------------------------------------------------------

SUN = dict(env="hdri", nee="sun", sun_weight_mode="hdri", sun_lobe_roughness=0.03, diffuse_indirect_max=2)
ENV = dict(env="hdri", nee="env", diffuse_indirect_max=2)
RENDER_CASES = {
    # name: (maps of textured_blob, config, family)
    "clearcoat": (dict(mr=(0.0, 0.25, 0.0)), dict(bounces=2), "gltf"),
    "metal-lobe": (dict(mr=(0.0, 0.3, 0.8)), dict(bounces=2, metal_roughness_lobe=True), "gltf"),
    "emissive": (dict(mr=(0.0, 0.25, 0.0), emissive=(0.4, 0.2, 0.1)), dict(bounces=2), "gltf"),
    "varying": (dict(varying=True, normal=True), dict(bounces=2, metal_roughness_lobe=True), "gltf"),
    "hdri-sun": (dict(varying=True, normal=True), dict(bounces=2, metal_roughness_lobe=True, **SUN), "hdri"),
    "hdri-env": (dict(varying=True, normal=True), dict(bounces=2, metal_roughness_lobe=True, **ENV), "hdri"),
}


def _jax_scene(maps, family):
    if family == "gltf":
        return jgltf.gltf_scene(jgltf.mesh_from_model(textured_blob(cls=JGLTFModel, **maps), mat_type=DIFFUSE, **BOX))
    mesh = jgltf.mesh_from_model(textured_blob(cls=JGLTFModel, **maps), mat_type=DIFFUSE, **SKY)
    return jgltf.hdri_scene(mesh, synthetic_hdr(32, 64, sun_uv=(0.7, 0.7)))


@pytest.fixture(scope="module")
def jax_renders():
    """JAX's wavefront render of every case, 32x128, frame 2 (the first
    compiles JAX's walk, about 18 s on this CPU; the others take about 3 s
    each)."""
    out = {}
    for name, (maps, cfg, family) in RENDER_CASES.items():
        jscene = _jax_scene(maps, family)
        cam = jgltf.gltf_camera() if family == "gltf" else jgltf.hdri_camera()
        ref = j_trace_image(jscene, cam, JConfig(**cfg), W, H, 2.0, jnp.asarray(RV), jnp.asarray(BN))
        out[name] = (jscene, cam, _np(ref))
    return out


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_textured_trace_image_matches_jax(jax_renders, case):
    """The port's wavefront against JAX's, texel for texel (not against
    trace_image_pallas, whose per-triangle bake differs by design), by the
    JAX kernel tests' bars: fewer than 2% of lanes off by more than 1e-3 and
    the 95th percentile below 1e-3 (measured 0% and 6e-8), first-hit ids
    equal, first-hit normals within rtol 1e-3 / atol 1e-4, or with the bump
    map fewer than 1% of lanes off by more than 2e-3 (measured 0.33%: the
    map turns the walk's uv difference of up to 2.7e-5 into normals up to
    0.04 apart where the tangent frame's |n.y| < 0.9 test goes the other
    way); the mesh takes >= 5% of the first hits.  The port's lane counts
    show the branches the case drives: the decided class of a constant map;
    emissive terminations; with the varying maps every class, emissive
    terminations, lobe draws with a roughness above 0 and texel samples of
    all four maps (a normal map alone: tests/test_torch_mesh.py)."""
    jscene, jcam, ref = jax_renders[case]
    maps, cfg, family = RENDER_CASES[case]
    scene, cam = convert.scene_from_numpy(_np(jscene)), convert.camera_from_numpy(_np(jcam))
    counts = []
    got = trace_image(scene, cam, IntegratorConfig(**cfg), W, H, 2.0, RV, torch.as_tensor(BN), lane_counts=counts)
    d = np.abs(got.color.numpy() - ref.color).max(-1)
    assert (d > 1e-3).mean() < 0.02 and np.quantile(d, 0.95) < 1e-3, (float((d > 1e-3).mean()), np.quantile(d, 0.95))
    np.testing.assert_array_equal(got.object_id.numpy(), ref.object_id)
    dn = np.abs(got.object_normal.numpy() - ref.object_normal).max(-1)
    if maps.get("normal"):  # the bump map amplifies the walk's uv difference; its frame switches at |n.y| = 0.9
        assert (dn > 2e-3).mean() < 0.01, float((dn > 2e-3).mean())
    else:
        np.testing.assert_allclose(got.object_normal.numpy(), ref.object_normal, rtol=1e-3, atol=1e-4)
    mesh_id = 8.0 if family == "gltf" else 6.0
    assert (got.object_id.numpy() == mesh_id).mean() >= 0.05
    classes = sum(c.pbr_classes for c in counts).tolist()
    emissive = sum(int(c.emissive_hits) for c in counts)
    lobe = sum(int(c.lobe_draws) for c in counts)
    if case in ("clearcoat", "emissive"):
        assert classes[1] > 0 and classes[0] == classes[2] == 0
    if case == "metal-lobe":
        assert classes[2] > 0 and lobe == classes[2]
    if case == "emissive":
        assert emissive > 0 and got.color.numpy().max() > 0.0
    if maps.get("varying"):
        assert min(classes) > 0 and emissive > 0 and lobe > 0, (classes, emissive, lobe)
        assert all(sum(int(r.sum()) for r in reads) > 0 for reads in zip(*(c.texel_reads for c in counts)))
        assert bool((sum(c.texel_samples for c in counts) > 0).all())


def test_trace_image_fused_runs_textured_scenes_on_the_cpu(jax_renders):
    """On CPU tensors trace_image_fused is the plain version for a textured
    scene too: the same result as trace_image with the kernel's quad test
    (``fast_quads=None``), and no launch counted."""
    jscene, jcam, _ = jax_renders["varying"]
    scene, cam = convert.scene_from_numpy(_np(jscene)), convert.camera_from_numpy(_np(jcam))
    cfg = IntegratorConfig(**RENDER_CASES["varying"][1])
    assert megakernel.configuration(scene, cfg) == "textured"
    before = dict(megakernel.LAUNCHES)
    got = megakernel.trace_image_fused(scene, cam, cfg, 16, 8, 2.0, RV, torch.as_tensor(BN))
    ref = trace_image(scene, cam, cfg, 16, 8, 2.0, RV, torch.as_tensor(BN), fast_quads=None)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert megakernel.LAUNCHES == before


@pytest.mark.parametrize("bounces", [1, 2, 3])
def test_lobe_draw_order_under_quad_nee(bounces):
    """With the metal roughness lobe on under quad NEE a bounce draws
    hem.r, hem.phi, quad.x, quad.y, quad.z, lobe.cos, lobe.phi: the RNG
    state calculate_radiance returns equals JAX's exactly after 1, 2 and 3
    bounces (4 + 7 per bounce draws), and the Cornell render with the METAL
    sphere's lobe (roughness 0 off the mesh) is within the Cornell bar."""
    px, py = pixel_grid(H, W)  # JAX's eager ops are compiled per shape: the renders' shape reuses them
    jpx, jpy = j_pixel_grid(H, W)
    tcfg, jcfg = IntegratorConfig(bounces=bounces, metal_roughness_lobe=True), JConfig(bounces=bounces,
                                                                                     metal_roughness_lobe=True)
    ro, rd, rng = generate_rays(cornell_camera(), px, py, W, H, rng_seed(2.0, px, py))
    bn = blue_noise_fetch(torch.as_tensor(BN), px, py, RV)
    res, rng_out, _ = calculate_radiance(cornell_scene(), tcfg, ro, rd, rng, bn, 2.0)
    jro, jrd, jrng = j_generate_rays(j_cornell_camera(), jpx, jpy, W, H, j_rng_seed(2.0, jpx, jpy))
    jbn = j_blue_noise_fetch(jnp.asarray(BN), jpx, jpy, jnp.asarray(RV))
    jres, jrng_out, _ = j_calculate_radiance(j_cornell_scene(), jcfg, jro, jrd, jrng, jbn, 2.0)
    for a, b in zip(rng_out, jrng_out):
        np.testing.assert_array_equal(a.numpy() & 0xFFFFFFFF, np.asarray(b).astype(np.int64) & 0xFFFFFFFF)
    close = np.isclose(res.color.numpy(), np.asarray(jres.color), rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() > 0.995, close.mean()
    np.testing.assert_array_equal(res.object_id.numpy(), np.asarray(jres.object_id))


# ---- the loader, its description, the demo CLIs ---------------------------------------

def write_textured_gltf(path):
    """A .gltf with two primitives of two materials (the first textured with
    all four maps as PNG files beside it, the second untextured), node
    transforms, UVs outside [0, 1]."""
    from PIL import Image

    m = blob_model(16, seed=2)
    rng = np.random.default_rng(8)
    base = path.parent
    images = []
    for name, arr in (("albedo", rng.uniform(0.2, 1.0, (8, 8, 3))), ("normal", np.dstack([
            0.5 + 0.2 * rng.standard_normal((8, 8, 2)), np.ones((8, 8))])),
            ("mr", np.dstack([np.zeros((8, 8)), rng.uniform(0, 1, (8, 8)), (rng.uniform(0, 1, (8, 8)) > 0.5)])),
            ("emissive", (rng.uniform(0, 1, (8, 8, 3)) > 0.8) * 0.8)):
        Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8), "RGB").save(base / f"{name}.png")
        images.append({"uri": f"{name}.png"})
    prims, blob, views, accessors = [], b"", [], []

    def add(arr, kind):
        nonlocal blob
        arr = np.ascontiguousarray(arr)
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": arr.nbytes})
        blob += arr.tobytes()
        comp = 5125 if arr.dtype == np.uint32 else 5126
        accessors.append({"bufferView": len(views) - 1, "componentType": comp, "count": arr.shape[0], "type": kind})
        return len(accessors) - 1

    for k, sl in enumerate((slice(0, 10), slice(10, 16))):
        pos = np.stack([m.p0[sl], m.p1[sl], m.p2[sl]], 1).reshape(-1, 3).astype(np.float32) / 10.0
        nrm = np.repeat(m.n0[sl], 3, axis=0).astype(np.float32)
        uv = rng.uniform(-1.0, 2.0, (pos.shape[0], 2)).astype(np.float32)
        idx = np.arange(pos.shape[0], dtype=np.uint32)
        prims.append({"attributes": {"POSITION": add(pos, "VEC3"), "NORMAL": add(nrm, "VEC3"),
                                     "TEXCOORD_0": add(uv, "VEC2")}, "indices": add(idx, "SCALAR"), "material": k})
    (base / "blob.bin").write_bytes(blob)
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0.0, 0.5, 0.0], "scale": [1.0, 1.0, 1.0]}],
        "meshes": [{"name": "blob", "primitives": prims}],
        "materials": [{"name": "textured", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}, "metallicRoughnessTexture": {"index": 2}, "metallicFactor": 1.0},
            "normalTexture": {"index": 1}, "emissiveTexture": {"index": 3}},
            {"name": "plain", "pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.2, 0.2, 1.0]},
             "doubleSided": True}],
        "textures": [{"source": i} for i in range(4)], "images": images,
        "buffers": [{"uri": "blob.bin", "byteLength": len(blob)}], "bufferViews": views, "accessors": accessors,
    }
    path.write_text(json.dumps(gltf))
    return path


def test_describe_and_load_textured_gltf_match_jax(tmp_path):
    """describe_gltf equals JAX's; load_gltf of the two-material file (its
    four PNG maps decoded, UVs, node transform) equals JAX's field by field,
    and so does material_index=1 (the untextured material: no maps)."""
    path = write_textured_gltf(tmp_path / "Duck.gltf")
    assert describe_gltf(str(path)) == j_describe_gltf(str(path))
    for index in (None, 1):
        got = load_gltf(str(path), initial_scale=10.0, flip_z=False, material_index=index)
        ref = j_load_gltf(str(path), initial_scale=10.0, flip_z=False, material_index=index)
        assert (got.albedo is None) == (index == 1)
        for name, a, b in zip(got._fields, got, ref):
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.triangle_count == 16 and load_gltf(str(path)).emissive.shape == (8, 8, 3)


@pytest.mark.parametrize("app,extra", [("gltf_model", []), ("hdri_environment", ["--nee", "env"]),
                                       ("hdri_environment", []), ("debug_gltf_loading", ["--material-index", "0"])])
def test_textured_demo_clis_write_their_image(app, extra, tmp_path, capsys):
    """The glTF, HDRI and loading-debug demos on the CPU at 16x16 with the
    textured file written as Duck.gltf into a temporary models directory:
    a finite image, the textured model reported."""
    models = tmp_path / "models"
    models.mkdir()
    write_textured_gltf(models / "Duck.gltf")
    out = tmp_path / f"{app}.png"
    main = importlib.import_module(f"bpt_tpu_torch.apps.{app}").main
    img = main(["--size", "16", "--spp", "2", "--bounces", "2", "--device", "cpu", "--model", "duck",
                "--models-dir", str(models), "--out", str(out)] + extra)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.max() > 0.0
    printed = capsys.readouterr().out
    assert "wrote" in printed and (app == "hdri_environment" or "textured=True" in printed)
    if app == "debug_gltf_loading":
        assert "material[0] textured" in printed and "material[1] plain" in printed
