"""Scene, camera and state conversion, the Cornell, quadric and sky scene
constructors, ray generation and closest-hit parity between bpt_tpu_torch
and bpt_tpu; and the scene-level guards of the kernel module."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.camera import Camera as JCamera
from bpt_tpu.camera import generate_rays as j_generate_rays
from bpt_tpu.core.rng import rng_seed as j_rng_seed
from bpt_tpu.integrator.intersect import scene_intersect as j_scene_intersect
from bpt_tpu.kernels import megakernel as jmega
from bpt_tpu.renderer import RenderState as JRenderState
from bpt_tpu.scenes import cornell as jcornell
from bpt_tpu.scenes import quadric_geometry as jquadric
from bpt_tpu.scenes import sky_scene as jsky_scene
from bpt_tpu.scenes.types import Quads as JQuads
from bpt_tpu.scenes.types import Scene as JScene
from bpt_tpu.scenes.types import UnitSpheres as JUnitSpheres
from bpt_tpu_torch import convert
from bpt_tpu_torch.camera import Camera, generate_rays
from bpt_tpu_torch.core.rng import rng_seed
from bpt_tpu_torch.integrator.frame import pixel_grid
from bpt_tpu_torch.integrator.intersect import scene_intersect
from bpt_tpu_torch.kernels import launch_args, megakernel
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.kernels import build
from bpt_tpu_torch.scenes import cornell, gltf_scene, quadric_geometry, sky_scene
from bpt_tpu_torch.scenes.types import CLEARCOAT_DIFFUSE, DIFFUSE, METAL, TRANSPARENT, Environment, Quadrics, Scene

torch.set_num_threads(2)

RES = 64


def _np(x):
    return jax.tree.map(np.asarray, x)


@pytest.mark.parametrize("mat,plane", [(METAL, 6), (TRANSPARENT, 6), (METAL, 1), (TRANSPARENT, 5)])
def test_cornell_scene_matches_jax_scene(mat, plane):
    """The torch ``cornell_scene`` gives the converted JAX scene's tensors."""
    ref = convert.scene_from_numpy(_np(jcornell.cornell_scene(quad_light_plane=plane, right_sphere_mat=mat)))
    got = cornell.cornell_scene(quad_light_plane=plane, right_sphere_mat=mat)
    for group in ("quads", "spheres"):
        for name, a, b in zip(getattr(got, group)._fields, getattr(got, group), getattr(ref, group)):
            assert a.dtype == b.dtype and a.shape == b.shape, (group, name)
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6, err_msg=f"{group}.{name}")


def test_scene_round_trip():
    src = _np(jcornell.cornell_scene(right_sphere_mat=TRANSPARENT))
    back = convert.to_numpy(convert.scene_from_numpy(src))
    rebuilt = JScene(quads=JQuads(**back.quads._asdict()), spheres=JUnitSpheres(**back.spheres._asdict()))
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(src)):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert np.asarray(a).dtype == b.dtype


@pytest.mark.parametrize("kw", [
    dict(position=(0.0, -20.0, -120.0), fov=0.8, focus_distance=113.0),
    dict(position=(3.0, 5.0, -80.0), yaw=0.3, pitch=-0.2, fov=1.1, aperture_size=2.0, focus_distance=60.0),
])
def test_camera_look_and_round_trip(kw):
    ref = JCamera.look(**kw)
    got = Camera.look(**kw)
    for name, a, b in zip(Camera._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=name)
    back = JCamera(**convert.to_numpy(convert.camera_from_numpy(_np(ref)))._asdict())
    for a, b in zip(back, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(got.world_matrix().numpy(), np.asarray(ref.world_matrix()), atol=1e-7)


def test_render_state_round_trip():
    accum = np.random.default_rng(3).random((8, 6, 4)).astype(np.float32)
    src = JRenderState(accum=accum, sample_counter=np.float32(5.0), frame_counter=np.float32(7.0))
    state = convert.render_state_from_numpy(src)
    assert state.sample_counter == 5.0 and state.frame_counter == 7.0
    back = JRenderState(**convert.to_numpy(state)._asdict())
    np.testing.assert_array_equal(back.accum, accum)
    assert back.sample_counter == np.float32(5.0) and back.frame_counter == np.float32(7.0)


def _rays_both(jcam, width, height, frame=2.0):
    tcam = convert.camera_from_numpy(_np(jcam))
    px, py = pixel_grid(height, width)
    ro, rd, _ = generate_rays(tcam, px, py, width, height, rng_seed(frame, px, py))
    jpy, jpx = jnp.mgrid[0:height, 0:width]
    jro, jrd, _ = j_generate_rays(jcam, jpx, jpy, width, height, j_rng_seed(frame, jpx, jpy))
    return (ro, rd), (jro, jrd)


@pytest.mark.parametrize("aperture", [0.0, 2.0])
def test_generate_rays_parity(aperture):
    jcam = JCamera.look((0.0, -20.0, -120.0), fov=0.8, aperture_size=aperture, focus_distance=113.0)
    (ro, rd), (jro, jrd) = _rays_both(jcam, 96, RES)  # non-square: catches a width/height swap
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mat", [METAL, TRANSPARENT])
def test_scene_intersect_parity(mat):
    """Primary rays plus random rays from inside the box: t and normals within
    rtol 1e-5, object ids (spheres 0-1, quads 2-7) exactly equal."""
    jscene = jcornell.cornell_scene(right_sphere_mat=mat)
    tscene = convert.scene_from_numpy(_np(jscene))
    (ro, rd), _ = _rays_both(jcornell.cornell_camera(), RES, RES)
    gen = np.random.default_rng(4)
    o2 = gen.uniform(-45.0, 45.0, (RES, RES, 3)).astype(np.float32)
    d2 = gen.normal(size=(RES, RES, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    ro = np.concatenate([ro.numpy(), o2]).astype(np.float32)
    rd = np.concatenate([rd.numpy(), d2]).astype(np.float32)
    got = scene_intersect(tscene, torch.as_tensor(ro), torch.as_tensor(rd))
    ref = j_scene_intersect(jscene, jnp.asarray(ro), jnp.asarray(rd))
    np.testing.assert_array_equal(got.object_id.numpy(), np.asarray(ref.object_id))
    ids = got.object_id.numpy()
    assert set(np.unique(ids[:RES])) <= set(range(8))  # the camera sees only the box
    assert set(np.unique(ids[RES:])) <= set(range(8)) | {-1.0e6}  # the front is open
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(ref.normal), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.mat_type.numpy(), np.asarray(ref.mat_type))
    np.testing.assert_array_equal(got.color.numpy(), np.asarray(ref.color))


@pytest.mark.parametrize("mat", [METAL, TRANSPARENT, "quadric"])
def test_packs_match_the_tpu_kernel_layout(mat):
    """The kernel's scene and camera packs hold the TPU kernel's values,
    float for float (the quadric pack for the quadric scene): the quad row
    its n, v0..v3, color and material at the columns of
    ``launch_args.QUAD_COLUMNS`` (its first 15 floats are the parallelogram
    test's per-quad algebra, held to JAX's expressions in
    test_torch_fast_quads.py), the sphere row the TPU row's 21 floats and 3
    more pads, the quadric row the TPU row."""
    if mat == "quadric":
        jscene, jcam = jquadric.quadric_geometry_scene(shape_k=0.35), jquadric.quadric_camera()
    else:
        jscene, jcam = jcornell.cornell_scene(right_sphere_mat=mat), jcornell.cornell_camera()
    jq, js, jd = jmega.pack_scene(jscene)
    scene = convert.scene_from_numpy(jax.tree.map(np.asarray, jscene))
    q, s, d = megakernel.pack_scene(scene)
    jq = np.asarray(jq)
    cols = launch_args.QUAD_COLUMNS
    assert q.shape == (jq.shape[0], launch_args.QUAD_FLOATS)
    for col, tpu_col in ((cols["n"], 0), (12, 3), (cols["v1"], 6), (cols["v2"], 9), (cols["v3"], 12),
                         (cols["color"], 15)):
        np.testing.assert_allclose(q[:, col:col + 3].numpy(), jq[:, tpu_col:tpu_col + 3], rtol=1e-7, atol=0)
    np.testing.assert_array_equal(q[:, cols["mat"]].numpy(), jq[:, 18])
    np.testing.assert_array_equal(q[:, cols["n"] + 3].numpy(), 0.0)
    if s is not None:
        np.testing.assert_array_equal(s[:, :21].numpy(), np.asarray(js))
        np.testing.assert_array_equal(s[:, 21:].numpy(), 0.0)
    assert (s is None) == (js is None) and (d is None) == (jd is None)
    if d is not None:
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    cam = megakernel.pack_camera(convert.camera_from_numpy(jax.tree.map(np.asarray, jcam)), 96, 64)
    np.testing.assert_allclose(cam.numpy(), np.asarray(jmega.pack_camera(jcam, 96, 64)), rtol=1e-7)


def _assert_scene_equal(got: Scene, ref: Scene, atol=1e-6):
    for group in Scene._fields:
        a_group, b_group = getattr(got, group), getattr(ref, group)
        assert (a_group is None) == (b_group is None), group
        if a_group is None:
            continue
        for name, a, b in zip(a_group._fields, a_group, b_group):
            assert (a is None) == (b is None), (group, name)
            if a is None:
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, (group, name)
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol, err_msg=f"{group}.{name}")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(shape_k=0.35, all_shapes_mat=TRANSPARENT),
    dict(shape_k=0.9, all_shapes_mat=DIFFUSE, quad_light_plane=1, quad_light_radius=30.0,
         extra_rotation=(0.2, -0.4, 0.1), extra_translation=(1.0, -2.0, 3.0), extra_scale=(1.0, 1.5, 0.8)),
])
def test_quadric_scene_matches_jax_scene(kw):
    """quadric_geometry_scene equals the converted JAX scene field by field
    (the inverse matrices within atol 1e-6: both invert in float32)."""
    ref = convert.scene_from_numpy(_np(jquadric.quadric_geometry_scene(**kw)))
    _assert_scene_equal(quadric_geometry.quadric_geometry_scene(**kw), ref)
    assert ref.quadrics.shape_k.shape == () and ref.quadrics.inv_matrix.shape == (12, 4, 4)


@pytest.mark.parametrize("kw", [dict(), dict(sun_rot_x_deg=330.0, sun_rot_y_deg=45.0, right_sphere_mat=TRANSPARENT)])
def test_sky_scene_matches_jax_scene(kw):
    """physical_sky_scene equals the converted JAX scene field by field; the
    environment carries the sun direction and power, no HDRI field."""
    ref = convert.scene_from_numpy(_np(jsky_scene.physical_sky_scene(**kw)))
    _assert_scene_equal(sky_scene.physical_sky_scene(**kw), ref)
    assert ref.env.hdr_image is None and ref.env.sun_power.shape == ()


def test_quadric_and_sky_scenes_round_trip():
    """JAX -> port -> numpy -> JAX, exact."""
    from bpt_tpu.scenes.types import Environment as JEnvironment
    from bpt_tpu.scenes.types import Quadrics as JQuadrics

    for src in (_np(jquadric.quadric_geometry_scene(shape_k=0.35)), _np(jsky_scene.physical_sky_scene())):
        back = convert.to_numpy(convert.scene_from_numpy(src))
        rebuilt = JScene(quads=JQuads(**back.quads._asdict()),
                         spheres=None if back.spheres is None else JUnitSpheres(**back.spheres._asdict()),
                         quadrics=None if back.quadrics is None else JQuadrics(**back.quadrics._asdict()),
                         env=None if back.env is None else JEnvironment(**back.env._asdict()))
        for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(src)):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_convert_refuses_meshes_and_hdri():
    """Meshes and HDRI fields were refused once; now a textured mesh is
    carried with its albedo (textured PBR is ported) and so are the HDRI
    fields of the environment."""
    src = _np(jsky_scene.physical_sky_scene())
    soup = np.random.default_rng(0).normal(0, 5, (3, 8, 3)).astype(np.float32)
    model = SimpleNamespace(p0=soup[0], p1=soup[1], p2=soup[2], n0=soup[0], n1=soup[0], n2=soup[0],
                            uv0=soup[0, :, :2], uv1=soup[1, :, :2], uv2=soup[2, :, :2], normal_map=None,
                            metallic_roughness=None, emissive=None, albedo=np.ones((4, 4, 3), np.float32))
    textured = convert.to_numpy(gltf_scene.mesh_from_model(model))
    carried = convert.scene_from_numpy(src._replace(mesh=textured)).mesh
    assert carried.albedo.shape == (4, 4, 3) and carried.normal_map is None
    assert megakernel.configuration(Scene(mesh=carried), IntegratorConfig()) == "textured"
    hdri = src._replace(env=src.env._replace(hdr_image=np.zeros((4, 8, 3), np.float32), hdr_exposure=np.float32(2)))
    env = convert.scene_from_numpy(hdri).env
    assert env.hdr_image.shape == (4, 8, 3) and env.hdr_exposure.item() == 2.0 and env.env_cdf is None


def test_quadric_scene_intersect_parity():
    """Primary rays of the quadric demo plus random rays from inside the box:
    ids (quadrics 0-11, quads 12-17) exactly equal, t and normals within
    rtol 1e-5 except where the hit is the torus, whose normal is a float32
    SDF difference (within 1e-3 after normalization)."""
    jscene = jquadric.quadric_geometry_scene(shape_k=0.35)
    tscene = convert.scene_from_numpy(_np(jscene))
    (ro, rd), _ = _rays_both(jquadric.quadric_camera(), RES, RES)
    gen = np.random.default_rng(5)
    o2 = gen.uniform(-45.0, 45.0, (RES, RES, 3)).astype(np.float32)
    d2 = gen.normal(size=(RES, RES, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    ro = np.concatenate([ro.numpy(), o2]).astype(np.float32)
    rd = np.concatenate([rd.numpy(), d2]).astype(np.float32)
    got = scene_intersect(tscene, torch.as_tensor(ro), torch.as_tensor(rd))
    ref = j_scene_intersect(jscene, jnp.asarray(ro), jnp.asarray(rd))
    ids = got.object_id.numpy()
    np.testing.assert_array_equal(ids, np.asarray(ref.object_id))
    assert set(range(12)) <= set(np.unique(ids).tolist())  # every shape is hit by some ray
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5)
    torus = ids == 11
    np.testing.assert_allclose(got.normal.numpy()[~torus], np.asarray(ref.normal)[~torus], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.normal.numpy()[torus], np.asarray(ref.normal)[torus], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.mat_type.numpy(), np.asarray(ref.mat_type))


# ---- repairs: moving scenes, fixed inputs of the path-replay route, the build key

def _full_scene():
    """A scene with all four ported families; shape_k and sun_power as host
    numbers."""
    q = quadric_geometry.quadric_geometry_scene()
    s = sky_scene.physical_sky_scene()
    quadrics = Quadrics(q.quadrics.inv_matrix, 0.35, q.quadrics.color, q.quadrics.mat_type)
    env = Environment(sun_direction=s.env.sun_direction, sun_power=2.0)
    return Scene(quads=q.quads, spheres=s.spheres, quadrics=quadrics, env=env)


def test_scene_to_moves_every_family():
    """Scene.to keeps every family that is set (it used to drop all but quads
    and spheres), and makes 0-d float32 tensors of shape_k and sun_power."""
    scene = _full_scene()
    moved = scene.to("meta")
    for group in ("quads", "spheres", "quadrics", "env"):
        src, dst = getattr(scene, group), getattr(moved, group)
        assert dst is not None, group
        for name, a, b in zip(src._fields, src, dst):
            if a is None:
                assert b is None, (group, name)
                continue
            assert b.device.type == "meta", (group, name)
            assert b.shape == torch.as_tensor(a).shape, (group, name)
    assert moved.quadrics.shape_k.dtype == torch.float32 and moved.quadrics.shape_k.shape == ()
    assert moved.env.sun_power.dtype == torch.float32 and moved.env.sun_power.shape == ()
    back = scene.to("cpu")
    assert back.quadrics.shape_k.item() == pytest.approx(0.35) and back.env.sun_power.item() == 2.0
    torch.testing.assert_close(back.env.sun_direction, scene.env.sun_direction, rtol=0, atol=0)
    mesh = gltf_scene.mesh_from_model(gltf_scene.heightfield_model(n_side=2))
    moved_mesh = scene._replace(mesh=mesh).to("meta").mesh
    assert all(t is None or t.device.type == "meta" for t in moved_mesh)


def _fused_call(scene, camera, cfg):
    bn = torch.as_tensor(np.zeros((256, 256, 4), np.float32))
    return megakernel.trace_image_fused(scene, camera, cfg, 8, 8, 1.0, np.array([0.3, 0.7], np.float32), bn,
                                        differentiable=True)


@pytest.mark.parametrize("where", ["sun_direction", "sun_power", "inv_matrix", "shape_k"])
def test_fused_route_refuses_sun_and_quadric_geometry_gradients(where):
    """The path-replay route differentiates colors only; a sun or quadric
    geometry tensor that requires a gradient raises, naming the field and
    the wavefront route, instead of getting no gradient."""
    if where.startswith("sun"):
        scene, cam, cfg = (sky_scene.physical_sky_scene(), sky_scene.sky_camera(),
                           IntegratorConfig(bounces=1, env="sky", nee="sun"))
        env = scene.env._replace(**{where: getattr(scene.env, where).clone().requires_grad_(True)})
        scene = scene._replace(env=env)
        field = f"Environment.{where}"
    else:
        scene, cam, cfg = (quadric_geometry.quadric_geometry_scene(), quadric_geometry.quadric_camera(),
                           IntegratorConfig(bounces=1, transparent_tint=True))
        quadrics = scene.quadrics._replace(**{where: getattr(scene.quadrics, where).clone().requires_grad_(True)})
        scene = scene._replace(quadrics=quadrics)
        field = f"Quadrics.{where}"
    with pytest.raises(NotImplementedError, match=field) as err:
        _fused_call(scene, cam, cfg)
    assert "fused=False" in str(err.value)
    with torch.no_grad():  # without grad mode it is the plain forward
        _fused_call(scene, cam, cfg)


def test_build_key_covers_included_headers(tmp_path):
    """The build's cache key hashes the kernel, every csrc header it includes
    (through other headers too) and the flags: changing one byte of a header
    changes it."""
    for path in build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    names = {p.name for p in build.sources("megakernel", tmp_path)}
    assert {"megakernel.cu", "vec.cuh", "quadrics.cuh", "sky.cuh"} <= names
    before = build.source_digest("megakernel", tmp_path)
    assert before == build.source_digest("megakernel", tmp_path)
    header = tmp_path / "vec.cuh"  # included only through the other headers and the kernel
    header.write_bytes(header.read_bytes() + b"\n// changed\n")
    assert build.source_digest("megakernel", tmp_path) != before
    assert build.source_digest("megakernel", tmp_path, flags=("-O2",)) != build.source_digest("megakernel", tmp_path)
