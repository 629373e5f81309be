"""Gradients on mesh, HDRI and textured scenes: the fused route (the grads
mode's plain version on the CPU, its path-replay backward and the deferred
composition) and the wavefront route (autograd through ``trace_image``,
whose mesh walk is the closest-hit query's recompute VJP) against the JAX
package's wavefront gradients, autograd through the port's plain forward
and central differences.  (The mesh transform's gradient through the
closest-hit VJP is in tests/test_torch_traverse.py.)

The JAX references are ``jax.grad`` through JAX's wavefront
``trace_image``, which samples per texel as the port does.  JAX's fused
path is not a reference here: it bakes material decisions per triangle and
normals per vertex, the port's kernel decides per texel.  Each JAX
reference is computed once, in a module fixture.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apps.hdri_environment import synthetic_hdr as j_synthetic_hdr
from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.integrator.frame import trace_image as j_trace_image
from bpt_tpu.io.gltf import GLTFModel as JGLTFModel
from bpt_tpu.textures import quad_pack
from bpt_tpu_torch import convert
from bpt_tpu_torch.apps.inverse_rendering import recover_albedo
from bpt_tpu_torch.camera import Camera
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.integrator.frame import trace_image
from bpt_tpu_torch.io.gltf import GLTFModel
from bpt_tpu_torch.kernels import megakernel
from bpt_tpu_torch.scenes import gltf_scene

torch.set_num_threads(2)
jgltf = importlib.import_module("bpt_tpu.scenes.gltf_scene")  # bpt_tpu.scenes exports a function of that name

BN = blue_noise_table()
RV = np.array([0.3, 0.7], np.float32)
RES = 32
WVEC = np.array([1.0, 2.0, 3.0], np.float32)
BOX = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5), translation=(0.0, -20.0, -85.0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def blob_soup(T=21, seed=0):
    """tests/test_kernels.py's random blobs: (p0, p1, p2, face normals) and
    the generator, ready for the draws that follow."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 8, (T, 1, 3)).astype(np.float32)
    tri = (c + rng.normal(0, 3, (T, 3, 3))).astype(np.float32)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-9
    return tri[:, 0], tri[:, 1], tri[:, 2], n.astype(np.float32), rng


def textured_blob(cls):
    """tests/test_kernels.py:222's textured blob (21 triangles, UVs in
    [0, 1], a random 32x32 albedo, a constant CLEARCOAT metallic-roughness
    map) with an 8x8 emissive map of which about 40% of the texels glow, so
    that primary hits both end on emission and take albedo factors."""
    p0, p1, p2, n, rng = blob_soup(seed=7)
    uv = rng.uniform(0, 1, (21, 3, 2)).astype(np.float32)
    albedo = rng.uniform(0.1, 1.0, (32, 32, 3)).astype(np.float32)
    mr = np.tile(np.asarray((0.0, 0.25, 0.0), np.float32), (8, 8, 1))
    glow = np.random.default_rng(11).uniform(0, 1, (8, 8, 1)) < 0.4
    em = np.where(glow, np.array([0.4, 0.2, 0.1], np.float32), 0.0).astype(np.float32)
    return cls(p0=p0, p1=p1, p2=p2, n0=n, n1=n, n2=n, uv0=uv[:, 0], uv1=uv[:, 1], uv2=uv[:, 2], albedo=albedo,
               normal_map=None, metallic_roughness=mr, emissive=em)


def plain_blob(cls):
    p0, p1, p2, n, _ = blob_soup()
    z2 = np.zeros((21, 2), np.float32)
    return cls(p0=p0, p1=p1, p2=p2, n0=n, n1=n, n2=n, uv0=z2, uv1=z2, uv2=z2, albedo=None, normal_map=None,
               metallic_roughness=None, emissive=None)


# ---- the HDRI scene of tests/test_kernels.py:313: wall color and exposure ------------

HDRI_CFG = dict(bounces=2, env="hdri", nee="sun", sun_weight_mode="hdri", sun_lobe_roughness=0.03,
                diffuse_indirect_max=2)


@pytest.fixture(scope="module")
def hdri_jax():
    base = jgltf.hdri_scene(jgltf.mesh_from_model(plain_blob(JGLTFModel), mat_type=1), j_synthetic_hdr(16, 32),
                            sun_power=4.0)
    cfg, cam = JConfig(**HDRI_CFG), jgltf.hdri_camera()

    def loss(wall_c, exposure):
        s = base._replace(quads=base.quads._replace(color=base.quads.color.at[1].set(wall_c)),
                          env=base.env._replace(hdr_exposure=exposure))
        return jnp.mean(j_trace_image(s, cam, cfg, RES, RES, 2.0, jnp.asarray(RV), jnp.asarray(BN)).color
                        * jnp.asarray(WVEC))

    grads = jax.grad(loss, argnums=(0, 1))(base.quads.color[1], jnp.asarray(1.3, jnp.float32))
    return base, cam, [np.asarray(g) for g in grads]


def test_fused_hdri_gradients_match_jax_wavefront(hdri_jax):
    """The fused gradient (the plain grads mode, its path-replay backward
    with the env-terminated term, and the deferred equirect composition) of
    mean(color * [1, 2, 3]) in a wall's color and hdr_exposure against
    ``jax.grad`` through JAX's wavefront, at tests/test_kernels.py:313's
    bars (wall rtol 5e-2, atol 1e-5; exposure rtol 2e-2), and against
    autograd through the port's plain forward (rtol 1e-4).  The composed
    color is the forward's bit for bit."""
    base, cam, (g_wall, g_exp) = hdri_jax
    scene = convert.scene_from_numpy(_np(base))
    cfg = IntegratorConfig(**HDRI_CFG)
    bn = torch.as_tensor(BN)
    grads = {}
    for route in ("fused", "plain"):
        wall = scene.quads.color[1].clone().requires_grad_(True)
        exposure = torch.tensor(1.3, requires_grad=True)
        s = scene._replace(quads=scene.quads._replace(color=torch.cat([scene.quads.color[:1], wall[None],
                                                                       scene.quads.color[2:]])),
                           env=scene.env._replace(hdr_exposure=exposure))
        if route == "fused":
            out = megakernel.trace_image_fused(s, convert.camera_from_numpy(_np(cam)), cfg, RES, RES, 2.0, RV, bn,
                                               differentiable=True)
            forward = trace_image(s, convert.camera_from_numpy(_np(cam)), cfg, RES, RES, 2.0, RV, bn)
            torch.testing.assert_close(out.color, forward.color, rtol=0, atol=0)
        else:
            out = trace_image(s, convert.camera_from_numpy(_np(cam)), cfg, RES, RES, 2.0, RV, bn)
        loss = (out.color * torch.as_tensor(WVEC)).mean()
        grads[route] = [g.numpy() for g in torch.autograd.grad(loss, [wall, exposure])]
    np.testing.assert_allclose(grads["fused"][1], g_exp, rtol=2e-2, err_msg="hdr_exposure")
    np.testing.assert_allclose(grads["fused"][0], g_wall, rtol=5e-2, atol=1e-5, err_msg="wall color")
    for a, b in zip(grads["fused"], grads["plain"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-9)
    assert abs(float(grads["fused"][1])) > 0 and np.abs(grads["fused"][0]).min() > 0


# ---- textured: the albedo and emissive texels --------------------------------------

TEX_CFG = dict(bounces=2)


@pytest.fixture(scope="module")
def textured():
    """The textured blob in front of the glTF camera, the port's scene and
    JAX's gradients of the projected loss in both maps."""
    model = textured_blob(JGLTFModel)
    jmesh = jgltf.mesh_from_model(model, mat_type=1, **BOX)
    cam, cfg = jgltf.gltf_camera(), JConfig(**TEX_CFG)
    planes = np.random.default_rng(1).normal(size=(2, RES, RES, 3)).astype(np.float32)

    def loss(albedo, emissive):
        mesh = jmesh._replace(albedo=albedo, albedo_q=quad_pack(albedo), emissive=emissive,
                              emissive_q=quad_pack(emissive))
        color = j_trace_image(jgltf.gltf_scene(mesh), cam, cfg, RES, RES, 2.0, jnp.asarray(RV), jnp.asarray(BN)).color
        return sum(jnp.mean(jnp.asarray(w) * color) for w in planes)

    j_grads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(model.albedo), jnp.asarray(model.emissive))
    scene = gltf_scene.gltf_scene(gltf_scene.mesh_from_model(textured_blob(GLTFModel), mat_type=1, **BOX))
    return scene, gltf_scene.gltf_camera(), torch.as_tensor(planes), [np.asarray(g) for g in j_grads]


def _texel_color(scene, cam, albedo, emissive, fused):
    s = scene._replace(mesh=scene.mesh._replace(albedo=albedo, emissive=emissive))
    cfg, bn = IntegratorConfig(**TEX_CFG), torch.as_tensor(BN)
    if fused:
        return megakernel.trace_image_fused(s, cam, cfg, RES, RES, 2.0, RV, bn, differentiable=True).color
    return trace_image(s, cam, cfg, RES, RES, 2.0, RV, bn).color


def test_fused_texel_gradients(textured):
    """Albedo and emissive texel gradients of a projected loss through the
    fused route against autograd through the port's plain forward (rtol
    1e-4) and against JAX's wavefront ``jax.grad`` (each map's gradient
    within 1e-3 of JAX's in the L2 norm, relative: the walks' t differ in the
    last bits, which moves the bilinear weights).  The composed color is the
    forward's within float rounding (rtol 1e-5): every path ends at one
    terminal event after all of its albedo factors, so the factors' product
    can be taken last; the render takes emissive terminations, deferred
    albedo factors and both classes' paths."""
    scene, cam, planes, j_grads = textured
    grads, colors = {}, {}
    for fused in (True, False):
        albedo = scene.mesh.albedo.clone().requires_grad_(True)
        emissive = scene.mesh.emissive.clone().requires_grad_(True)
        color = _texel_color(scene, cam, albedo, emissive, fused)
        loss = sum((w * color).mean() for w in planes)
        grads[fused] = [g.numpy() for g in torch.autograd.grad(loss, [albedo, emissive])]
        colors[fused] = color.detach()
    torch.testing.assert_close(colors[True], colors[False], rtol=1e-5, atol=1e-6)
    for name, a, b, j in zip(("albedo", "emissive"), grads[True], grads[False], j_grads):
        scale = np.abs(b).max()
        assert scale > 0, name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * scale, err_msg=name)
        assert np.linalg.norm(a - j) <= 1e-3 * np.linalg.norm(j), name
    _, sg, deferred = megakernel.trace_image_fused_grads(scene, cam, IntegratorConfig(**TEX_CFG), RES, RES, 2.0, RV,
                                                         torch.as_tensor(BN))
    assert (deferred[4:7].amax(0) > 0).any()  # emissive terminations deferred
    assert (deferred[0] > -1e5).any() and (deferred[2] > -1e5).any()  # albedo factors at both bounces


@pytest.mark.parametrize("which", ["albedo", "emissive"])
def test_fused_texel_gradients_match_finite_differences(textured, which):
    """tests/test_fused_gradients.py:89's random-projection form: a global
    tint t of one map; reverse mode through the fused route, projected on
    random planes, against the projection of the central-difference image
    dC/dt of the plain forward (rtol 2e-2)."""
    scene, cam, planes, _ = textured

    def color(t, fused):
        maps = {"albedo": scene.mesh.albedo, "emissive": scene.mesh.emissive}
        maps[which] = maps[which] * t
        return _texel_color(scene, cam, maps["albedo"], maps["emissive"], fused)

    h = 1e-3
    with torch.no_grad():
        fd_img = (color(torch.tensor(1.0 + h), False).double() - color(torch.tensor(1.0 - h), False).double()) / (2 * h)
    assert fd_img.abs().max() > 1e-3
    t = torch.tensor(1.0, requires_grad=True)
    grad = torch.autograd.grad(sum((w * color(t, True)).mean() for w in planes), [t])[0]
    proj_fd = sum((w.double() * fd_img).mean() for w in planes)
    np.testing.assert_allclose(float(grad), float(proj_fd), rtol=2e-2)


@pytest.mark.parametrize("fused", [True, False])
def test_albedo_recovery_lowers_the_loss(fused):
    """apps.inverse_rendering's recovery on the CPU, 3 Adam steps on a 16x16
    albedo at 32², both routes: the loss falls (tests/test_fused_gradients.py:249).
    reorder=True (the staged pool) takes the same steps on the fused route
    and is refused on the wavefront route, which has no pool."""
    cam = Camera.look(position=(0.0, 0.0, -40.0), fov=0.8, focus_distance=40.0)
    out = recover_albedo(textured_blob(GLTFModel), bounces=2, size=RES, steps=3, lr=0.1, tex_size=16, fused=fused,
                         camera=cam, device="cpu", frames=(2.0,))
    assert np.isfinite(out["losses"]).all() and out["losses"][-1] < out["losses"][0], out["losses"]
    assert tuple(out["albedo"].shape) == (16, 16, 3) and float(out["albedo"].min()) >= 0.0
    if fused:
        staged = recover_albedo(textured_blob(GLTFModel), bounces=2, size=RES, steps=3, lr=0.1, tex_size=16,
                                reorder=True, camera=cam, device="cpu", frames=(2.0,))
        np.testing.assert_allclose(staged["losses"], out["losses"], rtol=1e-5)
    else:
        with pytest.raises(ValueError, match="reorder"):
            recover_albedo(textured_blob(GLTFModel), bounces=1, size=8, steps=1, lr=0.1, tex_size=4, fused=fused,
                           reorder=True, camera=cam, device="cpu")


def test_inverse_rendering_cli_names_a_missing_model(tmp_path):
    """The demo CLI fails with the path of a model it cannot find."""
    from bpt_tpu_torch.apps.inverse_rendering import main

    with pytest.raises(FileNotFoundError, match="DamagedHelmet"):
        main(["--models-dir", str(tmp_path), "--device", "cpu", "--size", "8", "--steps", "1"])


# ---- what the fused route holds fixed -----------------------------------------------

@pytest.mark.parametrize("field", ["inv_matrix", "p0", "normal_map", "metallic_roughness", "albedo", "emissive",
                                   "hdr_image", "hdr_exposure"])
def test_fused_route_refuses_what_it_holds_fixed(field):
    """A mesh transform, vertex table, normal map or metallic-roughness map
    that requires a gradient would get none through the path-replay route
    (JAX gives it zeros): the fused call raises, naming the field and the
    wavefront route.  The albedo and emissive maps and the HDR map and its
    exposure pass, and get gradients."""
    from bpt_tpu_torch.apps.hdri_environment import synthetic_hdr

    model = textured_blob(GLTFModel)._replace(normal_map=np.full((4, 4, 3), 0.5, np.float32))
    scene = gltf_scene.hdri_scene(gltf_scene.mesh_from_model(model, mat_type=1), synthetic_hdr(8, 16))
    group = "env" if field.startswith("hdr") else "mesh"
    leaf = getattr(getattr(scene, group), field).clone().requires_grad_(True)
    scene = scene._replace(**{group: getattr(scene, group)._replace(**{field: leaf})})
    cfg = IntegratorConfig(bounces=1, env="hdri", nee="sun", diffuse_indirect_max=2)
    cam = gltf_scene.hdri_camera()

    def call():
        return megakernel.trace_image_fused(scene, cam, cfg, 8, 8, 2.0, RV, torch.as_tensor(BN), differentiable=True)

    if field in megakernel.DIFFERENTIABLE["TriangleMesh"] + megakernel.DIFFERENTIABLE["Environment"]:
        color = call().color
        assert color.requires_grad
        torch.autograd.grad(color.sum(), [leaf])
    else:
        with pytest.raises(NotImplementedError, match=f"TriangleMesh.{field}") as err:
            call()
        assert "fused=False" in str(err.value)


@pytest.mark.parametrize("plain_walk", [False, True])
def test_wavefront_gradient_is_finite_with_the_lobe(plain_walk):
    """The wavefront's mesh-translation gradient with metal_roughness_lobe
    on a PBR map of roughness 0 (and glass spheres in the box): finite, and
    the same through the closest-hit VJP and the plain walk.  sqrt's
    infinite derivative at 0 (the lobe's exponent, refraction at k = 0) met
    the zero cotangent of an unselected branch and made it NaN."""
    model = textured_blob(GLTFModel)._replace(metallic_roughness=np.zeros((8, 8, 3), np.float32))
    mesh = gltf_scene.mesh_from_model(model, mat_type=1, **BOX)
    scene, cam = gltf_scene.gltf_scene(mesh), gltf_scene.gltf_camera()
    t = torch.zeros(3, requires_grad=True)
    eye = torch.eye(4)
    inv = mesh.inv_matrix @ torch.cat([torch.cat([eye[:3, :3], -t.reshape(3, 1)], 1), eye[3:]])
    out = trace_image(scene._replace(mesh=mesh._replace(inv_matrix=inv)), cam,
                      IntegratorConfig(bounces=3, metal_roughness_lobe=True), 16, 16, 2.0, RV, torch.as_tensor(BN),
                      plain_walk=plain_walk)
    g = torch.autograd.grad(out.color.sum(), [t])[0]
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, g
