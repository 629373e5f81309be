"""The texel tables the textured kernels read (``textures.texel_quads``:
the reference's ``quad_pack`` footprints, made once per map set by
``kernels/launch_args.py`` ``texel_table_of``) and the texel samples an
output reads (``LaneCounts.texel_samples``).

The tables' plain sampler, ``textures.sample_table``, against
``textures.sample_bilinear`` bit for bit and against the JAX package's
``sample_bilinear`` and ``sample_bilinear_packed(quad_pack(.))`` within
test_torch_textures.py's 2e-7, on maps of several shapes (non-square, 1x1,
one row), map sets of mixed sizes and with maps missing, at UVs below 0 and
above 1 (REPEAT wrap); the tables repacked when a map is edited in place or
replaced, the grads mode's tables without the albedo, the size check; the
gated counts against the masks they name (the normal map not on a shadow
ray, the emissive map only on a specular path); and a textured render
against JAX's within the textured tests' bars.
"""

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu import textures as jtextures
from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.integrator.frame import trace_image as j_trace_image
from bpt_tpu.io.gltf import GLTFModel as JGLTFModel
from bpt_tpu_torch import convert, textures
from bpt_tpu_torch.camera import Camera
from bpt_tpu_torch.integrator import IntegratorConfig, radiance
from bpt_tpu_torch.integrator.frame import trace_image
from bpt_tpu_torch.kernels import launch_args
from bpt_tpu_torch.scenes import gltf_scene
from bpt_tpu_torch.scenes.types import DIFFUSE, MAP_FIELDS
from test_torch_kernels import textured_model

torch.set_num_threads(2)
jgltf = importlib.import_module("bpt_tpu.scenes.gltf_scene")
BN = blue_noise_table()
RV = np.array([0.3, 0.7], np.float32)
BOX = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5), translation=(0.0, -20.0, -85.0))


def _uvs(rng, n=4096):
    uv = rng.uniform(-2, 3, (n, 2)).astype(np.float32)
    uv[:8] = [[-1.0, -1.0], [0.0, 0.0], [1.0, 1.0], [2.0, -2.0], [-0.5, 2.5], [3.0, 0.999], [-1e-4, 1e-4],
              [0.5, -0.5]]
    return uv


MAP_SETS = {  # (H, W) per map in MAP_FIELDS order, None for a missing map
    "one size": [(16, 16)] * 4,
    "mixed sizes": [(5, 7), (16, 16), (5, 7), (1, 9)],
    "missing maps": [None, (3, 8), None, (3, 8)],
    "1x1 and one row": [(1, 1), (1, 13), (1, 1), None],
    "non-square alone": [(64, 24), None, None, None],
}


def _mesh(**maps):
    blank = dict.fromkeys(MAP_FIELDS)
    return SimpleNamespace(**(blank | maps))


@pytest.mark.parametrize("name", list(MAP_SETS))
def test_sample_table_matches_sample_bilinear_and_jax(name):
    """Every map of the set sampled from its table equals sample_bilinear on
    the map itself bit for bit, and JAX's sample_bilinear and
    sample_bilinear_packed(quad_pack(map)) within 2e-7; record [y, x] holds
    the footprint (y, x), (y, x + 1), (y + 1, x), (y + 1, x + 1) with REPEAT
    wrap, three channels and a zero each."""
    shapes = MAP_SETS[name]
    rng = np.random.default_rng(len(name))
    maps = [None if s is None else torch.as_tensor(rng.uniform(0, 1, s + (3,)).astype(np.float32)) for s in shapes]
    tables = launch_args.texel_table_of(_mesh(**dict(zip(MAP_FIELDS, maps))))
    uv = _uvs(rng)
    t_uv = torch.as_tensor(uv)
    for tex, quads in zip(maps, tables):
        if tex is None:
            assert quads is None
            continue
        h, w = tex.shape[:2]
        assert tuple(quads.shape) == (h, w, 4, 4) and quads.dtype == torch.float32 and not quads[..., 3].any()
        for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            assert torch.equal(quads[:, :, k, :3], torch.roll(tex, (-dy, -dx), (0, 1)))
        got = textures.sample_table(quads, t_uv)
        assert torch.equal(got, textures.sample_bilinear(tex, t_uv)), name
        j_tex, j_uv = jnp.asarray(tex.numpy()), jnp.asarray(uv)
        for ref in (jtextures.sample_bilinear(j_tex, j_uv),
                    jtextures.sample_bilinear_packed(jtextures.quad_pack(j_tex), j_uv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-7)


def test_texel_table_of_repacks_edited_and_replaced_maps():
    """One set of tables per map set: the same maps give the same tables; a
    map edited in place or replaced gets a new table holding its new texels
    (the stale set is dropped when edited); the grads mode's set leaves the
    albedo out."""
    rng = np.random.default_rng(3)
    albedo, normal = (torch.as_tensor(rng.uniform(0, 1, (8, 6, 3)).astype(np.float32)) for _ in range(2))
    mesh = _mesh(albedo=albedo, normal_map=normal)
    first = launch_args.texel_table_of(mesh)
    assert launch_args.texel_table_of(mesh) is first
    assert first[2:] == (None, None) and torch.equal(first[0][:, :, 0, :3], albedo)
    albedo.mul_(0.5)  # an optimiser's in-place step
    edited = launch_args.texel_table_of(mesh)
    assert edited is not first and torch.equal(edited[0][:, :, 0, :3], albedo)
    assert sum(t is first for _, _, t in launch_args._TEXEL_TABLES.values()) == 0
    replaced = launch_args.texel_table_of(_mesh(albedo=albedo, normal_map=normal.flip(0).contiguous()))
    assert torch.equal(replaced[1][:, :, 0, :3], normal.flip(0)) and torch.equal(replaced[0], edited[0])
    grads = launch_args.texel_table_of(mesh, albedo=False)
    assert grads[0] is None and torch.equal(grads[1][:, :, 0, :3], normal)


def test_trace_args_packs_the_tables_and_no_albedo_in_grads_mode():
    """trace_args points each map of the kernel's argument block at its
    texel table, with the map's (H, W), and the grads mode's block has no
    albedo."""
    scene = gltf_scene.gltf_scene(gltf_scene.mesh_from_model(textured_model(varying=True, normal=True), **BOX))
    cam = gltf_scene.gltf_camera()
    cfg = IntegratorConfig(bounces=2, metal_roughness_lobe=True)
    bn = torch.as_tensor(BN)
    for grads in (False, True):
        outputs = launch_args.empty_outputs(scene, cfg, (8, 8), grads, bn.device)
        args, mesh_arg, (_, tables) = launch_args.trace_args(scene, cam, cfg, 8, 8, bn, outputs)
        assert mesh_arg == 2
        for i, name in enumerate(MAP_FIELDS):
            if grads and name == "albedo":
                assert tables[i] is None and not args.tex[i]
                continue
            assert args.tex[i] == tables[i].data_ptr()
            assert (args.tex_h[i], args.tex_w[i]) == tuple(getattr(scene.mesh, name).shape[:2])


def test_texel_table_of_refuses_what_the_kernel_cannot_address():
    """A map that is not (H, W, 3), or whose table holds 2**31 16-byte
    slots or more (4 H W), raises ValueError before anything is packed
    (meta tensors: nothing is allocated)."""
    with pytest.raises(ValueError, match="must be"):
        launch_args.texel_table_of(_mesh(albedo=torch.empty((4, 4, 4), device="meta")))
    with pytest.raises(ValueError, match="2\\*\\*31"):  # below 2**31 floats, but 2**31 slots
        launch_args.texel_table_of(_mesh(emissive=torch.empty((32768, 16384, 3), device="meta")))


def _counted_render(scene, cfg, width, height, monkeypatch):
    """The plain render with its lane counts and, per bounce, the live lanes
    whose hit is the mesh (a spy on scene_intersect)."""
    mesh_hits = []
    intersect = radiance.scene_intersect

    def spy(scene_, ro, rd, **kw):
        hit = intersect(scene_, ro, rd, **kw)
        mesh_id = float(sum(g.color.shape[0] for g in (scene_.quads, scene_.spheres) if g is not None))
        mesh_hits.append(int((kw["active"] & (hit.t < float("inf")) & (hit.object_id == mesh_id)).sum()))
        return hit

    monkeypatch.setattr(radiance, "scene_intersect", spy)
    counts = []
    trace_image(scene, gltf_scene.gltf_camera(), cfg, width, height, 2.0, RV, torch.as_tensor(BN),
                lane_counts=counts)
    return counts, mesh_hits


def test_no_normal_map_sample_on_a_shadow_ray(monkeypatch):
    """With diffuse_indirect_max = 0 every ray after a diffuse vertex is a
    shadow ray: bounce 0 samples the normal map at every mesh hit, bounce 1
    at none, though its shadow rays end on the mesh."""
    scene = gltf_scene.gltf_scene(gltf_scene.mesh_from_model(textured_model(normal=True), mat_type=DIFFUSE, **BOX))
    counts, mesh_hits = _counted_render(scene, IntegratorConfig(bounces=2, diffuse_indirect_max=0), 48, 32,
                                        monkeypatch)
    normal = [int(c.texel_samples[1]) for c in counts]
    assert normal[0] == mesh_hits[0] > 0 and mesh_hits[1] > 0 and normal[1] == 0, (normal, mesh_hits)
    assert not counts[1].texel_reads[1].any()


def test_no_emissive_sample_on_a_non_specular_hit(monkeypatch):
    """Without a metallic-roughness map every PBR hit is DIFFUSE, so only
    bounce 0 is on a specular path (the box has no glass): the emissive map
    is sampled at every PBR hit of bounce 0 and at none of the PBR hits of
    the later bounces; the albedo at every PBR hit."""
    model = textured_model(emissive=(0.0, 0.0, 0.0))
    scene = gltf_scene.gltf_scene(gltf_scene.mesh_from_model(model, mat_type=DIFFUSE, **BOX))
    counts, mesh_hits = _counted_render(scene, IntegratorConfig(bounces=3, diffuse_indirect_max=2), 48, 32,
                                        monkeypatch)
    albedo = [int(c.texel_samples[0]) for c in counts]
    emissive = [int(c.texel_samples[3]) for c in counts]
    pbr = [int(sum(c.pbr_classes)) + int(c.emissive_hits) for c in counts]
    assert albedo == pbr and emissive[0] == pbr[0] == mesh_hits[0] > 0, (albedo, emissive, pbr, mesh_hits)
    assert pbr[1] > 0 and emissive[1:] == [0, 0], (emissive, pbr)


def test_textured_render_within_the_jax_bars():
    """A textured render with every map (varying classes, lit emissive
    texels, the bump map, the lobe on) against JAX's wavefront by the
    textured tests' bars: fewer than 2% of lanes off by more than 1e-3 and
    the 95th percentile below 1e-3, first-hit ids equal, fewer than 1% of
    first-hit normals off by more than 2e-3; the gated counts read no more
    samples than the lanes that hit the mesh."""
    model = textured_model(varying=True, normal=True)
    jscene = jgltf.gltf_scene(jgltf.mesh_from_model(JGLTFModel(*model), mat_type=DIFFUSE, **BOX))
    jcfg = dict(bounces=3, metal_roughness_lobe=True)
    ref = jax.tree.map(np.asarray, j_trace_image(jscene, jgltf.gltf_camera(), JConfig(**jcfg), 64, 16, 2.0,
                                                 jnp.asarray(RV), jnp.asarray(BN)))
    scene = convert.scene_from_numpy(jax.tree.map(np.asarray, jscene))
    cam = convert.camera_from_numpy(jax.tree.map(np.asarray, jgltf.gltf_camera()))
    assert isinstance(cam, Camera)
    counts = []
    got = trace_image(scene, cam, IntegratorConfig(**jcfg), 64, 16, 2.0, RV, torch.as_tensor(BN), lane_counts=counts)
    d = np.abs(got.color.numpy() - ref.color).max(-1)
    assert (d > 1e-3).mean() < 0.02 and np.quantile(d, 0.95) < 1e-3, (float((d > 1e-3).mean()), np.quantile(d, 0.95))
    np.testing.assert_array_equal(got.object_id.numpy(), ref.object_id)
    dn = np.abs(got.object_normal.numpy() - ref.object_normal).max(-1)
    assert (dn > 2e-3).mean() < 0.01, float((dn > 2e-3).mean())
    samples = sum(c.texel_samples for c in counts)
    pbr = sum(int(sum(c.pbr_classes)) + int(c.emissive_hits) for c in counts)
    assert bool((samples > 0).all()) and int(samples[0]) == pbr and int(samples[3]) <= pbr
