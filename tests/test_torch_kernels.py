"""The port's kernel module: import hygiene, configuration checks, and (on a
CUDA card only) the CUDA megakernel against its plain version.

The card tests carry the ``cuda`` marker and skip without a GPU; run them
on the card with ``python -m pytest tests/test_torch_kernels.py --noconftest -m cuda``
(this file imports no jax, and ``--noconftest`` skips the JAX platform
setup in tests/conftest.py, so it runs where jax is not installed).
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from bpt_tpu_torch.core.rng import blue_noise_table
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.integrator.frame import trace_image
from bpt_tpu_torch.kernels import megakernel
from bpt_tpu_torch.kernels.integration import attach_cuda_path
from bpt_tpu_torch.renderer import ProgressiveRenderer
from bpt_tpu_torch.apps.hdri_environment import synthetic_hdr
from bpt_tpu_torch.io.gltf import GLTFModel
from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene, hdri_camera, hdri_scene, mesh_from_model
from bpt_tpu_torch.scenes.quadric_geometry import quadric_camera, quadric_geometry_scene
from bpt_tpu_torch.scenes.sky_scene import physical_sky_scene, sky_camera
from bpt_tpu_torch.scenes.types import DIFFUSE, METAL, TRANSPARENT
from chip_smoke import doubled_model, loop_cost_rise_inputs, one_triangle_model, tied_lanes

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RV = np.array([0.3, 0.7], np.float32)

SLICE_MODULES = [
    "bpt_tpu_torch.diff", "bpt_tpu_torch.diff.gradients", "bpt_tpu_torch.diff.inverse",
    "bpt_tpu_torch", "bpt_tpu_torch.integrator.config", "bpt_tpu_torch.core.vecmath", "bpt_tpu_torch.core.rng",
    "bpt_tpu_torch.core.sampling", "bpt_tpu_torch.core.fresnel", "bpt_tpu_torch.utils.transforms",
    "bpt_tpu_torch.camera", "bpt_tpu_torch.scenes.types", "bpt_tpu_torch.scenes.cornell",
    "bpt_tpu_torch.geometry.triangles", "bpt_tpu_torch.geometry.quadrics", "bpt_tpu_torch.lights",
    "bpt_tpu_torch.integrator.intersect", "bpt_tpu_torch.integrator.radiance", "bpt_tpu_torch.integrator.frame",
    "bpt_tpu_torch.postprocess", "bpt_tpu_torch.renderer", "bpt_tpu_torch.kernels.build",
    "bpt_tpu_torch.kernels.megakernel", "bpt_tpu_torch.kernels.integration", "bpt_tpu_torch.convert",
    "bpt_tpu_torch.device", "bpt_tpu_torch.sky", "bpt_tpu_torch.scenes.quadric_geometry",
    "bpt_tpu_torch.scenes.sky_scene", "bpt_tpu_torch.apps.common", "bpt_tpu_torch.apps.cornell_box",
    "bpt_tpu_torch.apps.quadric_geometry", "bpt_tpu_torch.apps.physical_sky", "bpt_tpu_torch.tools.ab_time",
    "bpt_tpu_torch.io", "bpt_tpu_torch.io.gltf", "bpt_tpu_torch.io.hdr", "bpt_tpu_torch.accel",
    "bpt_tpu_torch.accel.builder", "bpt_tpu_torch.accel.native", "bpt_tpu_torch.accel.traverse", "bpt_tpu_torch.env",
    "bpt_tpu_torch.scenes.gltf_scene", "bpt_tpu_torch.apps.gltf_model", "bpt_tpu_torch.apps.hdri_environment",
    "bpt_tpu_torch.textures", "bpt_tpu_torch.apps.debug_gltf_loading", "bpt_tpu_torch.kernels.traverse",
    "bpt_tpu_torch.apps.inverse_rendering", "bpt_tpu_torch.kernels.staged", "bpt_tpu_torch.kernels.launch_args",
    "bpt_tpu_torch.kernels.loop_cost", "bpt_tpu_torch.tools.loop_cost", "bpt_tpu_torch.utils.profiling",
    "bpt_tpu_torch.tools.key_sweep",
]


def test_import_loads_no_jax_and_no_cuda():
    """Importing every slice module loads neither jax nor bpt_tpu, and
    initialises neither CUDA nor a compiler."""
    code = textwrap.dedent(f"""
        import importlib, sys
        preloaded = set(sys.modules)
        for name in {SLICE_MODULES!r}:
            importlib.import_module(name)
        import torch
        bad = sorted(m for m in set(sys.modules) - preloaded if m.split('.')[0] in ('jax', 'jaxlib', 'bpt_tpu', 'triton'))
        assert not bad, bad
        assert not torch.cuda.is_initialized()
        from bpt_tpu_torch.kernels import build
        assert not build._loaded
        print('clean')
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


@pytest.mark.parametrize("change", [
    dict(env="sky", nee="quad"),
    dict(env="hdri", nee="env", metal_roughness_lobe=True),
    dict(nee="sun"),
    dict(metal_roughness_lobe=True),
])
def test_trace_image_fused_rejects_unported_configs(change):
    """(env, nee) pairs the port does not run raise NotImplementedError;
    metal_roughness_lobe without a textured mesh raises ValueError, as JAX's
    kernel entry refuses it (its roughness is per texel)."""
    cfg = dataclasses.replace(IntegratorConfig(bounces=2), **change)
    scene = cornell_scene()
    if cfg.env == "hdri":
        scene = hdri_scene(mesh_from_model(blob_model(8)), synthetic_hdr(8, 16))
    error = ValueError if cfg.metal_roughness_lobe else NotImplementedError
    with pytest.raises(error, match="textured mesh" if error is ValueError else ""):
        megakernel.trace_image_fused(scene, cornell_camera(), cfg, 8, 8, 1.0, RV, torch.as_tensor(blue_noise_table()))


def blob_model(T=128, seed=0) -> GLTFModel:
    """The random triangle blob of the JAX package's kernel tests."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 8, (T, 1, 3)).astype(np.float32)
    tri = (c + rng.normal(0, 3, (T, 3, 3))).astype(np.float32)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-9
    z2 = np.zeros((T, 2), np.float32)
    return GLTFModel(p0=tri[:, 0], p1=tri[:, 1], p2=tri[:, 2], n0=n, n1=n, n2=n, uv0=z2, uv1=z2, uv2=z2,
                     albedo=None, normal_map=None, metallic_roughness=None, emissive=None)


def test_trace_image_fused_rejects_bad_inputs():
    """Bad inputs raise; a textured mesh is no longer one of them: it runs
    (here the plain version) under the "textured" configuration, while
    the lobe on an untextured mesh raises."""
    scene, cam, cfg = cornell_scene(), cornell_camera(), IntegratorConfig(bounces=2)
    bn = torch.as_tensor(blue_noise_table())
    textured = mesh_from_model(blob_model(8))._replace(albedo=torch.ones(4, 4, 3))
    lobe = dataclasses.replace(cfg, metal_roughness_lobe=True)
    assert megakernel.configuration(scene._replace(mesh=textured), lobe) == "textured"
    out = megakernel.trace_image_fused(scene._replace(mesh=textured), cam, lobe, 8, 8, 1.0, RV, bn)
    assert bool(torch.isfinite(out.color).all())
    with pytest.raises(ValueError, match="textured mesh"):
        megakernel.trace_image_fused(scene._replace(mesh=textured._replace(albedo=None)), cam, lobe, 8, 8, 1.0, RV,
                                     bn)
    with pytest.raises(ValueError, match="256, 256, 4"):
        megakernel.trace_image_fused(scene, cam, cfg, 8, 8, 1.0, RV, bn[:128])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        megakernel.trace_image_fused(scene, cam, cfg, 8, 8, 1.0, RV, bn.to("meta"))
    with pytest.raises(ValueError, match="image size"):
        megakernel.trace_image_fused(scene, cam, cfg, 0, 8, 1.0, RV, bn)


def test_attach_cuda_path_needs_a_cuda_renderer():
    r = ProgressiveRenderer(cornell_scene(), IntegratorConfig(bounces=2), 8, 8, blue_noise=blue_noise_table(),
                            device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        attach_cuda_path(r)


def test_renderer_and_optimize_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """No device argument means the card; without one they raise rather
    than run on the CPU.  device="cpu" runs the plain version."""
    from bpt_tpu_torch.diff.inverse import optimize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProgressiveRenderer(cornell_scene(), IntegratorConfig(bounces=2), 8, 8, blue_noise=blue_noise_table())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize(lambda p: (cornell_scene(), cornell_camera()), {"x": 1.0}, torch.zeros(8, 8, 3),
                 IntegratorConfig(bounces=2), 8, steps=1)
    r = ProgressiveRenderer(cornell_scene(), IntegratorConfig(bounces=2), 8, 8, blue_noise=blue_noise_table(),
                            device="cpu")
    before = dict(megakernel.LAUNCHES)
    r.render(cornell_camera(), spp=1)
    assert r.device.type == "cpu" and megakernel.LAUNCHES == before


def test_lane_counts_report_live_and_hit_lanes():
    """The measurement hook behind the kernels' bound: per bounce, the live
    lanes (every lane at bounce 0) and, of those, the lanes that hit and
    the lanes that missed; the Cornell box has no torus to march."""
    counts = []
    trace_image(cornell_scene(), cornell_camera(), IntegratorConfig(bounces=4), 16, 16, 2.0, RV,
                torch.as_tensor(blue_noise_table()), lane_counts=counts)
    live = [int(c.live) for c in counts]
    hits = [int(c.hits) for c in counts]
    assert len(counts) == 4 and live[0] == 256
    assert all(h <= n for h, n in zip(hits, live)) and all(b <= a for a, b in zip(live, live[1:]))
    assert hits[0] > 0 and live[-1] < live[0]
    assert all(int(c.hits) + int(c.misses) == int(c.live) for c in counts)
    assert all(int(c.torus_steps) == 0 for c in counts)


def test_lane_counts_report_torus_steps_and_sky_misses():
    """The quadric scene reports the torus march's SDF evaluations on live
    lanes; the sky scene reports the misses its kernel shades."""
    bn = torch.as_tensor(blue_noise_table())
    counts = []
    trace_image(quadric_geometry_scene(), quadric_camera(), IntegratorConfig(bounces=2, transparent_tint=True),
                32, 32, 2.0, RV, bn, lane_counts=counts)
    assert int(counts[0].torus_steps) > 0 and int(counts[0].hits) > int(counts[0].misses)
    counts = []
    trace_image(physical_sky_scene(), sky_camera(), IntegratorConfig(bounces=2, env="sky", nee="sun"), 32, 32, 2.0,
                RV, bn, lane_counts=counts)
    assert int(counts[0].misses) > 0 and all(int(c.torus_steps) == 0 for c in counts)


def test_configuration_names_and_checks():
    """configuration() names the kernel configuration a call runs; a sky
    config without an environment, or quad NEE without quads, is refused."""
    sky_cfg = IntegratorConfig(bounces=2, env="sky", nee="sun")
    assert megakernel.configuration(cornell_scene(), IntegratorConfig()) == "cornell"
    assert megakernel.configuration(quadric_geometry_scene(), IntegratorConfig()) == "quadric"
    assert megakernel.configuration(physical_sky_scene(), sky_cfg) == "sky"
    mesh = mesh_from_model(blob_model(8))
    assert megakernel.configuration(gltf_scene(mesh), IntegratorConfig()) == "mesh"
    assert megakernel.configuration(hdri_scene(mesh, synthetic_hdr(8, 16)), IntegratorConfig(env="hdri", nee="env")) \
        == "hdri"
    bn = torch.as_tensor(blue_noise_table())
    with pytest.raises(ValueError, match="scene.env"):
        megakernel.trace_image_fused(cornell_scene(), cornell_camera(), sky_cfg, 8, 8, 1.0, RV, bn)
    with pytest.raises(ValueError, match="scene.quads"):
        megakernel.trace_image_fused(physical_sky_scene()._replace(quads=None), sky_camera(), IntegratorConfig(),
                                     8, 8, 1.0, RV, bn)
    sky_only = physical_sky_scene()._replace(quads=None, spheres=None)  # a wavefront case: runs on the CPU
    r = megakernel.trace_image_fused(sky_only, sky_camera(), sky_cfg, 8, 8, 1.0, RV, bn)
    assert bool((r.pixel_sharpness == 1.01).all()) and bool((r.color > 0).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mat", [METAL, TRANSPARENT])
def test_cuda_kernel_matches_plain_version(cuda_device, mat):
    """64x64 (and non-square 96x64), 4 bounces, frame 2: the kernel's outputs
    equal the plain version's on the card (the build disables FMA
    contraction, which makes them bit-equal)."""
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    scene, cam = cornell_scene(right_sphere_mat=mat, device=cuda_device), cornell_camera(device=cuda_device)
    cfg = IntegratorConfig(bounces=4)
    for width, height in ((64, 64), (96, 64)):
        before = megakernel.LAUNCHES["cornell"]
        got = megakernel.trace_image_fused(scene, cam, cfg, width, height, 2.0, RV, bn)
        assert megakernel.LAUNCHES["cornell"] == before + 1
        ref = megakernel.trace_image_fused_reference(scene, cam, cfg, width, height, 2.0, RV, bn)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_renderer_goes_through_the_kernel(cuda_device):
    r = ProgressiveRenderer(cornell_scene(), IntegratorConfig(bounces=4), 64, 64, device=cuda_device)
    attach_cuda_path(r)
    before = megakernel.LAUNCHES["cornell"]
    img = r.render(cornell_camera(), spp=3)
    assert megakernel.LAUNCHES["cornell"] == before + 3
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())


@pytest.mark.cuda
def test_default_renderer_launches_the_kernel(cuda_device):
    """A renderer built with no device argument runs on the card, through
    the kernel, without attach_cuda_path (which is then a no-op)."""
    r = ProgressiveRenderer(cornell_scene(), IntegratorConfig(bounces=4), 64, 64)
    assert r.device.type == "cuda"
    before = megakernel.LAUNCHES["cornell"]
    r.render(cornell_camera(), spp=2)
    assert megakernel.LAUNCHES["cornell"] == before + 2
    attach_cuda_path(r)
    r.render(cornell_camera(), spp=1)
    assert megakernel.LAUNCHES["cornell"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("mat,tint", [(METAL, False), (TRANSPARENT, False), (TRANSPARENT, True)])
def test_cuda_grads_kernel_matches_plain_version(cuda_device, mat, tint):
    """96x64, 4 bounces, frame 2: the grads-mode kernel's 11 planes and sg
    planes equal its plain version's, and its 11 planes equal the forward
    kernel's, bit for bit."""
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    scene, cam = cornell_scene(right_sphere_mat=mat, device=cuda_device), cornell_camera(device=cuda_device)
    cfg = IntegratorConfig(bounces=4, transparent_tint=tint)
    before = megakernel.GRAD_LAUNCHES["cornell"]
    got, sg, _ = megakernel.trace_image_fused_grads(scene, cam, cfg, 96, 64, 2.0, RV, bn)
    assert megakernel.GRAD_LAUNCHES["cornell"] == before + 1
    ref, sg_ref, _ = megakernel.trace_image_fused_grads_reference(scene, cam, cfg, 96, 64, 2.0, RV, bn)
    fwd = megakernel.trace_image_fused(scene, cam, cfg, 96, 64, 2.0, RV, bn)
    torch.cuda.synchronize()
    assert sg.shape == (8 if tint else 16, 64, 96)
    torch.testing.assert_close(sg, sg_ref, rtol=0, atol=0)
    for a, b, c in zip(got, ref, fwd):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("tint", [False, True])
def test_cuda_path_replay_gradient_matches_plain_route(cuda_device, tint):
    """The gradient of mean(color * [1, 2, 3]) with respect to the light,
    wall 2 and the glass sphere through the kernel's path-replay VJP equals
    autograd through the plain trace_image on the card (rtol 1e-4)."""
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    scene = cornell_scene(right_sphere_mat=TRANSPARENT, device=cuda_device)
    cam = cornell_camera(device=cuda_device)
    cfg = IntegratorConfig(bounces=4, transparent_tint=tint)
    w = torch.tensor([1.0, 2.0, 3.0], device=cuda_device)

    def grads(differentiable, trace):
        qc = scene.quads.color.clone().requires_grad_(True)
        sc = scene.spheres.color.clone().requires_grad_(True)
        s = scene._replace(quads=scene.quads._replace(color=qc), spheres=scene.spheres._replace(color=sc))
        kw = dict(differentiable=True) if differentiable else {}
        loss = torch.mean(trace(s, cam, cfg, 96, 64, 2.0, RV, bn, **kw).color * w)
        g_q, g_s = torch.autograd.grad(loss, [qc, sc])
        return torch.stack([g_q[5], g_q[2], g_s[1]])

    before = megakernel.GRAD_LAUNCHES["cornell"]
    got = grads(True, megakernel.trace_image_fused)
    assert megakernel.GRAD_LAUNCHES["cornell"] == before + 1
    want = grads(False, megakernel.trace_image_fused_reference)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-9)


def _quadric_and_sky_cases(device):
    return {
        "quadric": (quadric_geometry_scene(device=device), quadric_camera(device=device),
                    IntegratorConfig(bounces=4, transparent_tint=True)),
        "quadric-glass": (quadric_geometry_scene(shape_k=0.35, all_shapes_mat=TRANSPARENT, device=device),
                          quadric_camera(device=device), IntegratorConfig(bounces=4, transparent_tint=True)),
        "sky": (physical_sky_scene(device=device), sky_camera(device=device),
                IntegratorConfig(bounces=4, env="sky", nee="sun")),
        "sky-glass": (physical_sky_scene(right_sphere_mat=TRANSPARENT, device=device), sky_camera(device=device),
                      IntegratorConfig(bounces=4, env="sky", nee="sun")),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["quadric", "quadric-glass", "sky", "sky-glass"])
def test_cuda_quadric_and_sky_kernels_match_plain_version(cuda_device, case):
    """96x64, 4 bounces, frame 2: the quadric and sky configurations of the
    forward kernel equal their plain versions bit for bit, and launch under
    their own configuration's count."""
    scene, cam, cfg = _quadric_and_sky_cases(cuda_device)[case]
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    name = megakernel.configuration(scene, cfg)
    before = megakernel.LAUNCHES[name]
    got = megakernel.trace_image_fused(scene, cam, cfg, 96, 64, 2.0, RV, bn)
    assert megakernel.LAUNCHES[name] == before + 1
    ref = megakernel.trace_image_fused_reference(scene, cam, cfg, 96, 64, 2.0, RV, bn)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["quadric", "sky"])
def test_cuda_quadric_and_sky_grads_kernels_match_plain_version(cuda_device, case):
    """The grads mode of both configurations: sg planes (n_obj = 12 quadrics
    + 6 quads, or 2 spheres + 4 quads) and 11 planes equal to the plain
    version's, the 11 planes also to the forward kernel's."""
    scene, cam, cfg = _quadric_and_sky_cases(cuda_device)[case]
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    got, sg, _ = megakernel.trace_image_fused_grads(scene, cam, cfg, 96, 64, 2.0, RV, bn)
    ref, sg_ref, _ = megakernel.trace_image_fused_grads_reference(scene, cam, cfg, 96, 64, 2.0, RV, bn)
    fwd = megakernel.trace_image_fused(scene, cam, cfg, 96, 64, 2.0, RV, bn)
    torch.cuda.synchronize()
    assert sg.shape == ((18, 64, 96) if case == "quadric" else (12, 64, 96))
    torch.testing.assert_close(sg, sg_ref, rtol=0, atol=0)
    for a, b, c in zip(got, ref, fwd):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def _no_mesh_cases(device):
    return {"cornell": (cornell_scene(right_sphere_mat=TRANSPARENT, device=device), cornell_camera(device=device),
                        IntegratorConfig(bounces=4)),
            **{k: v for k, v in _quadric_and_sky_cases(device).items() if k in ("quadric", "sky")}}


@pytest.mark.cuda
@pytest.mark.parametrize("grads", [False, True])
@pytest.mark.parametrize("case", ["cornell", "quadric", "sky"])
def test_cuda_no_mesh_kernels_take_the_parallelogram_test(cuda_device, case, grads):
    """96x64, 4 bounces, frame 2: the six instantiations without a mesh
    with fast_quads=True equal their plain versions (which make one
    parallelogram test per live lane and quad) bit for bit, on every plane;
    with fast_quads=False (the two fans) they do too, and the two frames
    differ, so the kernel honours the switch."""
    scene, cam, cfg = _no_mesh_cases(cuda_device)[case]
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    kernel = megakernel.trace_image_fused_grads if grads else megakernel.trace_image_fused
    plain = megakernel.trace_image_fused_grads_reference if grads else megakernel.trace_image_fused_reference
    frames = {}
    for fast in (True, False):
        got = kernel(scene, cam, cfg, 96, 64, 2.0, RV, bn, fast_quads=fast)
        lanes = []
        ref = plain(scene, cam, cfg, 96, 64, 2.0, RV, bn, lane_counts=lanes, fast_quads=fast)
        torch.cuda.synchronize()
        n_q = scene.quads.v0.shape[0]
        assert [int(c.parallelogram_tests) for c in lanes] == [int(c.live) * n_q if fast else 0 for c in lanes]
        got, ref = (got[0], ref[0]) if grads else (got, ref)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        frames[fast] = got.color
    assert not torch.equal(frames[True], frames[False])


@pytest.mark.cuda
def test_cuda_sheared_quad_takes_the_fans(cuda_device):
    """A Cornell box whose first quad is sheared (no parallelogram): the
    forward and grads kernels decide the two fans and equal their plain
    versions bit for bit; fast_quads=True raises before any launch."""
    scene, cam, cfg = _no_mesh_cases(cuda_device)["cornell"]
    v2 = scene.quads.v2.clone()
    v2[0] += torch.tensor([5.0, 0.0, 0.0], device=cuda_device)
    scene = scene._replace(quads=scene.quads._replace(v2=v2))
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    got = megakernel.trace_image_fused(scene, cam, cfg, 96, 64, 2.0, RV, bn)
    ref = megakernel.trace_image_fused_reference(scene, cam, cfg, 96, 64, 2.0, RV, bn)
    g_got, g_sg, _ = megakernel.trace_image_fused_grads(scene, cam, cfg, 96, 64, 2.0, RV, bn)
    g_ref, g_sg_ref, _ = megakernel.trace_image_fused_grads_reference(scene, cam, cfg, 96, 64, 2.0, RV, bn)
    torch.cuda.synchronize()
    for a, b in list(zip(got, ref)) + list(zip(g_got, g_ref)) + [(g_sg, g_sg_ref)]:
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    before = megakernel.LAUNCHES["cornell"]
    with pytest.raises(ValueError, match="parallelogram"):
        megakernel.trace_image_fused(scene, cam, cfg, 96, 64, 2.0, RV, bn, fast_quads=True)
    assert megakernel.LAUNCHES["cornell"] == before


@pytest.mark.cuda
def test_cuda_kernel_under_inference_mode_sees_a_moved_light(cuda_device):
    """Under torch.inference_mode, on a Cornell box of inference tensors on
    the card: a K1 frame, the light quad (quad 5) moved in place by 5 along
    its first edge, another K1 frame.  The second frame is bit-equal to its
    plain version and to the frame of a freshly built moved scene, and
    differs from the first.  A mesh scene moved to the card under inference
    mode (Scene.to) gets no tables, since no cache may serve tables made
    from inference tensors; the launch makes its own, and its K1 frame
    equals its plain version."""
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    cfg = IntegratorConfig(bounces=4)
    with torch.inference_mode():
        scene, cam = cornell_scene(device=cuda_device), cornell_camera(device=cuda_device)
        first = megakernel.trace_image_fused(scene, cam, cfg, 96, 64, 2.0, RV, bn)
        q = scene.quads
        e1 = q.v1[5] - q.v0[5]
        shift = 5.0 * e1 / torch.linalg.norm(e1)
        for v in (q.v0, q.v1, q.v2, q.v3):
            v[5].add_(shift)
        before = megakernel.LAUNCHES["cornell"]
        got = megakernel.trace_image_fused(scene, cam, cfg, 96, 64, 2.0, RV, bn)
        assert megakernel.LAUNCHES["cornell"] == before + 1
        ref = megakernel.trace_image_fused_reference(scene, cam, cfg, 96, 64, 2.0, RV, bn)
        fresh_quads = cornell_scene(device=cuda_device).quads
        fresh_quads = fresh_quads._replace(**{n: getattr(fresh_quads, n).clone() for n in ("v0", "v1", "v2", "v3")})
        for v in (fresh_quads.v0, fresh_quads.v1, fresh_quads.v2, fresh_quads.v3):
            v[5] += shift
        fresh = megakernel.trace_image_fused(scene._replace(quads=fresh_quads), cam, cfg, 96, 64, 2.0, RV, bn)
        mesh_scene = gltf_scene(mesh_from_model(blob_model(), mat_type=DIFFUSE, rotation=(0.3, 0.5, 0.0),
                                                scale=(1.5, 1.5, 1.5), translation=(0.0, -20.0, -85.0)),
                                device=cuda_device)
        assert mesh_scene.mesh.kernel_tables is None
        mesh_got = megakernel.trace_image_fused(mesh_scene, gltf_camera(device=cuda_device), cfg, 64, 64, 2.0, RV, bn)
        mesh_ref = megakernel.trace_image_fused_reference(mesh_scene, gltf_camera(device=cuda_device), cfg, 64, 64,
                                                          2.0, RV, bn)
    torch.cuda.synchronize()
    for a, b, c in zip(got, ref, fresh):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert not torch.equal(first.color, got.color)
    for a, b in zip(mesh_got, mesh_ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_wrapper_limits(cuda_device):
    """No quads, or a quadric count other than 0 or 12, raises in the
    wrapper; nothing falls back to the plain version."""
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    scene, cam, cfg = _quadric_and_sky_cases(cuda_device)["sky"]
    with pytest.raises(ValueError, match="at least one quad"):
        megakernel.trace_image_fused(scene._replace(quads=None), cam, cfg, 8, 8, 1.0, RV, bn)
    q, qcam, qcfg = _quadric_and_sky_cases(cuda_device)["quadric"]
    few = q.quadrics._replace(inv_matrix=q.quadrics.inv_matrix[:5], color=q.quadrics.color[:5],
                              mat_type=q.quadrics.mat_type[:5])
    with pytest.raises(ValueError, match="0 or 12"):
        megakernel.trace_image_fused(q._replace(quadrics=few), qcam, qcfg, 8, 8, 1.0, RV, bn)


def _mesh_and_hdri_cases(device):
    """The blob (128 triangles, the JAX kernel tests' generator) placed in
    front of each demo camera, so that it takes a good share of the first
    hits: DIFFUSE and TRANSPARENT (double-sided) in the glTF box, DIFFUSE
    under the HDRI sky with sun and env NEE, and with sun NEE under a map
    whose sun is above the horizon."""
    place = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5))
    box = dict(translation=(0.0, -20.0, -85.0), **place)
    sky = dict(translation=(0.0, 0.0, -165.0), **place)
    hdri_mesh = mesh_from_model(blob_model(), mat_type=DIFFUSE, **sky)
    hdri = hdri_scene(hdri_mesh, synthetic_hdr(32, 64), device=device)
    hdri_cfg = dict(bounces=4, env="hdri", diffuse_indirect_max=2)
    sun_cfg = IntegratorConfig(nee="sun", sun_weight_mode="hdri", sun_lobe_roughness=0.03, **hdri_cfg)
    return {
        "mesh": (gltf_scene(mesh_from_model(blob_model(), mat_type=DIFFUSE, **box), device=device),
                 gltf_camera(device=device), IntegratorConfig(bounces=4)),
        "mesh-glass": (gltf_scene(mesh_from_model(blob_model(), mat_type=TRANSPARENT, **box), device=device),
                       gltf_camera(device=device), IntegratorConfig(bounces=4)),
        "hdri-sun": (hdri, hdri_camera(device=device), sun_cfg),
        "hdri-env": (hdri, hdri_camera(device=device), IntegratorConfig(nee="env", **hdri_cfg)),
        "hdri-sun-up": (hdri_scene(hdri_mesh, synthetic_hdr(32, 64, sun_uv=(0.7, 0.7)), device=device),
                        hdri_camera(device=device), sun_cfg),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mesh", "mesh-glass", "hdri-sun", "hdri-env", "hdri-sun-up"])
def test_cuda_mesh_and_hdri_kernels_match_plain_version(cuda_device, case):
    """64x64, 4 bounces, frame 2: the mesh walk and the HDRI configurations
    of the forward kernel equal their plain versions bit for bit, launch
    under their own configuration's count, and the mesh takes first hits;
    under the raised sun, shadow rays reach it."""
    scene, cam, cfg = _mesh_and_hdri_cases(cuda_device)[case]
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    name = megakernel.configuration(scene, cfg)
    assert name == case.split("-")[0]
    before = megakernel.LAUNCHES[name]
    got = megakernel.trace_image_fused(scene, cam, cfg, 64, 64, 2.0, RV, bn)
    assert megakernel.LAUNCHES[name] == before + 1
    counts = []
    ref = megakernel.trace_image_fused_reference(scene, cam, cfg, 64, 64, 2.0, RV, bn, lane_counts=counts)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (got.object_id == 8.0 if name == "mesh" else got.object_id == 6.0).float().mean().item() > 0.05
    if case == "hdri-sun-up":
        assert sum(int(c.shadow_misses) for c in counts) > 0


def _grads_case_check(scene, cam, cfg, device, size=64):
    """The grads kernel against its plain version at size², 4 bounces, frame
    2: every plane bit for bit (the 11, sg, the deferred planes), one launch
    of the scene's configuration; the composed color against the forward
    kernel's (bit for bit without a textured mesh; within float rounding of
    the albedo product's order with one).  Returns the plain run's lane
    counts."""
    bn = torch.as_tensor(blue_noise_table()).to(device)
    name = megakernel.configuration(scene, cfg)
    before = megakernel.GRAD_LAUNCHES[name]
    got, sg, deferred = megakernel.trace_image_fused_grads(scene, cam, cfg, size, size, 2.0, RV, bn)
    assert megakernel.GRAD_LAUNCHES[name] == before + 1
    counts = []
    ref, sg_ref, deferred_ref = megakernel.trace_image_fused_grads_reference(scene, cam, cfg, size, size, 2.0, RV, bn,
                                                                             lane_counts=counts)
    fwd = megakernel.trace_image_fused(scene, cam, cfg, size, size, 2.0, RV, bn)
    torch.cuda.synchronize()
    for a, b in zip(tuple(got) + (sg, deferred), tuple(ref) + (sg_ref, deferred_ref)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    composed = megakernel.compose_deferred(got, deferred, scene, cfg)
    textured = name == "textured"
    torch.testing.assert_close(composed.color, fwd.color, rtol=1e-5 if textured else 0, atol=1e-6 if textured else 0)
    for a, b in zip(tuple(got)[1:], tuple(fwd)[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mesh", "mesh-glass", "hdri-sun", "hdri-env", "hdri-sun-up", "sky-mesh"])
def test_cuda_mesh_and_hdri_grads_kernels_match_plain_version(cuda_device, case):
    """The grads mode of the mesh and HDRI configurations (and the sky with
    an untextured mesh): every plane equal to the plain version's, the
    color composed from the deferred planes equal to the forward kernel's,
    bit for bit; env misses are deferred under HDRI."""
    if case == "sky-mesh":
        place = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5), translation=(0.0, 0.0, -165.0))
        scene = physical_sky_scene(device=cuda_device)._replace(
            mesh=gltf_scene(mesh_from_model(blob_model(), mat_type=DIFFUSE, **place), device=cuda_device).mesh)
        cam, cfg = sky_camera(device=cuda_device), IntegratorConfig(bounces=4, env="sky", nee="sun")
    else:
        scene, cam, cfg = _mesh_and_hdri_cases(cuda_device)[case]
    counts = _grads_case_check(scene, cam, cfg, cuda_device)
    assert sum(int(c.hits) for c in counts) > 0
    if cfg.env == "hdri":
        assert sum(int(c.misses) for c in counts) > 0


@pytest.mark.cuda
def test_cuda_scene_to_keeps_resident_tables(cuda_device):
    """Scene.to on the card keeps the kernel tables of a mesh whose soup and
    BVH are already there (an inverse-rendering step moves its scene every
    step) and makes new ones for a mesh whose soup was replaced."""
    scene = gltf_scene(mesh_from_model(blob_model(), mat_type=DIFFUSE), device=cuda_device)
    tables = scene.mesh.kernel_tables
    assert scene.to(cuda_device).mesh.kernel_tables is tables
    coloured = scene._replace(spheres=scene.spheres._replace(color=scene.spheres.color * 0.5))
    assert coloured.to(cuda_device).mesh.kernel_tables is tables
    moved = scene._replace(mesh=scene.mesh._replace(p0=scene.mesh.p0 + 1.0)).to(cuda_device)
    assert moved.mesh.kernel_tables is not tables
    torch.testing.assert_close(moved.mesh.kernel_tables.tris[:, 0, :3], moved.mesh.p0, rtol=0, atol=0)
    assert scene.to("cpu").mesh.kernel_tables is None


def _closest_hit_rays(device, n=4096, seed=5):
    """Rays at the blob (placed as the mesh cases place it), a quarter of
    them outside the lane mask."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    ro[:, 2] += 20.0
    rd = rng.normal(0, 12, (n, 3)).astype(np.float32) - ro
    active = rng.uniform(0, 1, n) < 0.75
    return (torch.as_tensor(ro, device=device), torch.as_tensor(rd, device=device),
            torch.as_tensor(active, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("mat", [DIFFUSE, TRANSPARENT])
def test_cuda_closest_hit_kernel_matches_plain_walk(cuda_device, mat):
    """The closest-hit kernel against the plain walk on the card, bit for bit
    in t, tri, u and v, with back faces culled (DIFFUSE) and not
    (TRANSPARENT), with and without a lane mask; one launch per call."""
    from bpt_tpu_torch.kernels import traverse

    mesh = gltf_scene(mesh_from_model(blob_model(), mat_type=mat), device=cuda_device).mesh
    ro, rd, active = _closest_hit_rays(cuda_device)
    cull = mat != TRANSPARENT
    for act in (None, active):
        before = traverse.LAUNCHES["closest_hit"]
        got = traverse.closest_hit(ro, rd, cull, act, mesh)
        assert traverse.LAUNCHES["closest_hit"] == before + 1
        ref = traverse.closest_hit_reference(ro, rd, cull, act, mesh)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert int((got[1] >= 0).sum()) > 100
        if act is not None:
            assert bool((got[1][~act] == -1).all())


def _tie_cases(device, case, mat, height=64, width=64):
    """The doubled 64-triangle blob (placed as the mesh cases place the blob)
    or the one triangle in the glTF box, and the glTF camera's primary rays
    of frame 2 (64x64 unless told) in the mesh's object space."""
    from bpt_tpu_torch.camera import generate_rays
    from bpt_tpu_torch.core.rng import rng_seed
    from bpt_tpu_torch.core.vecmath import transform_dir, transform_point
    from bpt_tpu_torch.integrator.frame import pixel_grid

    if case == "doubled":
        model, place = doubled_model(blob_model(64)), dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5))
    else:
        model, place = one_triangle_model(), {}
    scene = gltf_scene(mesh_from_model(model, mat_type=mat, translation=(0.0, -20.0, -85.0), **place), device=device)
    px, py = pixel_grid(height, width, device)
    ro, rd, _ = generate_rays(gltf_camera(device=device), px, py, width, height, rng_seed(2.0, px, py))
    return scene, transform_point(scene.mesh.inv_matrix, ro), transform_dir(scene.mesh.inv_matrix, rd)


@pytest.mark.cuda
@pytest.mark.parametrize("mat", [DIFFUSE, TRANSPARENT])
@pytest.mark.parametrize("case", ["doubled", "one-triangle"])
def test_cuda_closest_hit_kernel_on_ties_and_one_triangle(cuda_device, case, mat):
    """The closest-hit kernel against the plain walk bit for bit on the
    doubled soup, where nearly every hit is a tie that only the visit order
    decides (the plain walk's read masks show both copies tested), and on
    a mesh of one triangle, whose root is a leaf; cull on and off."""
    from bpt_tpu_torch.kernels import traverse

    scene, ro, rd = _tie_cases(cuda_device, case, mat)
    cull = mat != TRANSPARENT
    before = traverse.LAUNCHES["closest_hit"]
    got = traverse.closest_hit(ro, rd, cull, None, scene.mesh)
    assert traverse.LAUNCHES["closest_hit"] == before + 1
    ref = traverse.closest_hit_reference(ro, rd, cull, None, scene.mesh)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int((got[1] >= 0).sum()) > 200
    if case == "doubled":
        looked, tied = tied_lanes(scene.mesh, ro, rd, cull)
        assert looked == 48 and tied >= 40
    else:
        assert bool((got[1] <= 0).all())


# (mesh, leading shape of the rays, lane mask): images and flat sets whose
# lane counts are no multiple of the kernel's 128-lane spans, and masks that
# leave whole spans, single lanes or scattered lanes live.
SCHEDULE_CASES = [
    ("doubled", (33, 67), None), ("doubled", (33, 67), "random45"), ("one-triangle", (33, 67), "checker"),
    ("doubled", (33, 67), "tiles"), ("doubled", (1, 1), None), ("doubled", (1, 37), "one"),
    ("one-triangle", (1, 37), None), ("doubled", (70, 9), "tiles"), ("one-triangle", (70, 9), None),
    ("doubled", (70, 9), "dead"), ("doubled", (1,), None), ("doubled", (31,), None),
    ("one-triangle", (33,), "checker"), ("doubled", (4096,), "random45"), ("doubled", (4096,), "tiles"),
    ("one-triangle", (4096,), "one"), ("doubled", (4096,), "dead"), ("doubled", (0,), None),
]


def _schedule_mask(kind, shape, rng):
    """A lane mask of ``shape``: none, all dead, one live lane, a
    checkerboard, 45% live at random, or 16x16 blocks (flat: runs of 256
    lanes) dead next to live ones."""
    if kind is None:
        return None
    n = int(np.prod(shape))
    flat = np.arange(n)
    width = shape[-1] if len(shape) == 2 else n
    row, col = flat // max(width, 1), flat % max(width, 1)
    masks = {"dead": np.zeros(n, bool), "one": flat == rng.integers(max(n, 1)),
             "checker": (row + col) % 2 == 0, "random45": rng.uniform(0, 1, n) < 0.45,
             "tiles": ((row // 16 + col // 16) % 2 == 0) if len(shape) == 2 else (flat // 256) % 2 == 0}
    return torch.as_tensor(masks[kind].reshape(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_case,shape,mask", SCHEDULE_CASES,
                         ids=[f"{m}-{'x'.join(map(str, s))}-{k}" for m, s, k in SCHEDULE_CASES])
def test_cuda_closest_hit_lane_schedule(cuda_device, mesh_case, shape, mask):
    """The closest-hit kernel's lane schedule (spans of 128 lanes in the
    caller's order, the lanes that walk packed into a block's first
    threads) against the plain walk bit for bit in t, tri, u and v, on the
    doubled soup (ties) and the one-triangle mesh: images of 1x1 to 70x9
    and 33x67 rays, flat sets of 1 to 4096 rays (0: no launch), and masks
    that are all dead, one lane, a checkerboard, 45% random, or 16x16
    blocks (runs of 256 lanes) dead beside live ones; lanes off the mask get
    (INFINITY, -1, 0, 0); one launch per call."""
    from bpt_tpu_torch.core.vecmath import INFINITY
    from bpt_tpu_torch.kernels import traverse

    scene, ro, rd = _tie_cases(cuda_device, "doubled" if mesh_case == "doubled" else "one-triangle", DIFFUSE,
                               *(shape if len(shape) == 2 else (64, 64)))
    rng = np.random.default_rng(7)
    if len(shape) == 1:  # lanes picked from the 64x64 image
        pick = torch.as_tensor(rng.permutation(4096)[:shape[0]], device=cuda_device)
        ro, rd = ro.reshape(-1, 3)[pick], rd.reshape(-1, 3)[pick]
    act = _schedule_mask(mask, shape, rng)
    act = None if act is None else act.to(cuda_device)
    before = traverse.LAUNCHES["closest_hit"]
    got = traverse.closest_hit(ro, rd, True, act, scene.mesh)
    assert traverse.LAUNCHES["closest_hit"] == before + (1 if ro.numel() else 0)
    ref = traverse.closest_hit_reference(ro, rd, True, act, scene.mesh)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.shape == tuple(shape)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if act is not None and bool((~act).any()):
        dead = ~act
        assert bool((got[0][dead] == INFINITY).all() and (got[1][dead] == -1).all())
        assert bool((got[2][dead] == 0).all() and (got[3][dead] == 0).all())
    if int(np.prod(shape)) >= 2000 and mask != "dead" and mask != "one":
        assert int((got[1] >= 0).sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["doubled", "one-triangle"])
def test_cuda_mesh_kernel_on_ties_and_one_triangle(cuda_device, case):
    """K1's mesh configuration, forward and grads, against its plain version
    bit for bit at 64x64 on the doubled soup (its first hits tie: the
    plain walk's read masks on the same primary rays show both copies
    tested) and on the one-triangle mesh; the mesh takes first hits."""
    scene, ro, rd = _tie_cases(cuda_device, case, DIFFUSE)
    cam, cfg = gltf_camera(device=cuda_device), IntegratorConfig(bounces=4)
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    before = megakernel.LAUNCHES["mesh"]
    got = megakernel.trace_image_fused(scene, cam, cfg, 64, 64, 2.0, RV, bn)
    assert megakernel.LAUNCHES["mesh"] == before + 1
    ref = megakernel.trace_image_fused_reference(scene, cam, cfg, 64, 64, 2.0, RV, bn)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (got.object_id == 8.0).float().mean().item() > 0.2
    counts = _grads_case_check(scene, cam, cfg, cuda_device)
    assert sum(int(c.tri_tests) for c in counts) > 0
    if case == "doubled":
        looked, tied = tied_lanes(scene.mesh, ro, rd, True)
        assert looked == 48 and tied >= 40


@pytest.mark.cuda
def test_cuda_closest_hit_vjp_matches_cpu(cuda_device):
    """The recompute VJP's (g_ro, g_rd) on the card against the same
    backward on CPU copies (rtol 1e-5), for cotangents on t, u and v."""
    from bpt_tpu_torch.kernels import traverse

    mesh = gltf_scene(mesh_from_model(blob_model(), mat_type=DIFFUSE), device=cuda_device).mesh
    ro, rd, active = _closest_hit_rays(cuda_device)
    w = torch.as_tensor(np.random.default_rng(1).normal(size=(3, ro.shape[0])).astype(np.float32))
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        m = mesh if dev.type == "cuda" else gltf_scene(mesh_from_model(blob_model(), mat_type=DIFFUSE)).mesh
        o, d = ro.to(dev).requires_grad_(True), rd.to(dev).requires_grad_(True)
        t, tri, u, v = traverse.closest_hit(o, d, True, active.to(dev), m)
        hit = tri >= 0
        wd = w.to(dev)
        loss = (torch.where(hit, t, 0.0) * wd[0] + u * wd[1] + v * wd[2]).sum()
        grads[dev.type] = [g.cpu() for g in torch.autograd.grad(loss, [o, d])]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert float(grads["cuda"][0].abs().sum()) > 0


def textured_model(mr=None, emissive=None, varying=False, normal=False, T=128, albedo=True) -> GLTFModel:
    """The blob with random UVs in [-1.5, 2.5] (every map wraps both ways)
    and maps made from seeds: a random 32x32 albedo (None without
    ``albedo``: the mesh keeps its own material); a metallic-roughness
    map, constant ``mr`` or, with ``varying``, a 16x16 map whose class
    (DIFFUSE, CLEARCOAT, METAL with a random roughness) changes from texel
    to texel; an emissive map, constant ``emissive`` or, with ``varying``,
    10% of its texels lit; with ``normal``, a 16x16 bump map."""
    m = blob_model(T)
    rng = np.random.default_rng(7)
    uv = rng.uniform(-1.5, 2.5, (T, 3, 2)).astype(np.float32)
    albedo_map = rng.uniform(0.1, 1.0, (32, 32, 3)).astype(np.float32)  # drawn either way: the same other maps
    albedo_map = albedo_map if albedo else None
    em = None if emissive is None else np.tile(np.asarray(emissive, np.float32), (8, 8, 1))
    mrm = None if mr is None else np.tile(np.asarray(mr, np.float32), (8, 8, 1))
    if varying:
        cls_map = rng.integers(0, 3, (16, 16))
        mrm = np.zeros((16, 16, 3), np.float32)
        mrm[..., 1] = np.where(cls_map >= 1, rng.uniform(0.3, 0.9, (16, 16)), 0.0)
        mrm[..., 2] = np.where(cls_map == 2, rng.uniform(0.5, 1.0, (16, 16)), 0.0)
        em = np.where(rng.uniform(0, 1, (16, 16, 1)) < 0.1, np.array([0.9, 0.6, 0.3], np.float32), 0.0)
        em = em.astype(np.float32)
    nmap = None
    if normal:
        nmap = (0.5 + 0.25 * rng.standard_normal((16, 16, 3))).astype(np.float32)
        nmap[..., 2] = 1.0
    return GLTFModel(p0=m.p0, p1=m.p1, p2=m.p2, n0=m.n0, n1=m.n1, n2=m.n2, uv0=uv[:, 0], uv1=uv[:, 1],
                     uv2=uv[:, 2], albedo=albedo_map, normal_map=nmap, metallic_roughness=mrm, emissive=em)


def mixed_size_model() -> GLTFModel:
    """``textured_model(varying=True, normal=True)`` with maps of three
    sizes: a 24x40 albedo and emissive map (10% of its texels lit), which
    share one record of the texel table, the 16x16 normal map, and the
    metallic-roughness map cut to its first row (1x16)."""
    m = textured_model(varying=True, normal=True)
    rng = np.random.default_rng(11)
    albedo = rng.uniform(0.1, 1.0, (24, 40, 3)).astype(np.float32)
    lit = rng.uniform(0, 1, (24, 40, 1)) < 0.1
    emissive = np.where(lit, np.array([0.9, 0.6, 0.3], np.float32), 0.0).astype(np.float32)
    return m._replace(albedo=albedo, emissive=emissive,
                      metallic_roughness=np.ascontiguousarray(m.metallic_roughness[:1]))


def _textured_cases(device):
    """The textured blob in front of each demo camera: the glTF box with the
    lobe (the demo's configuration) and without it (a constant clearcoat
    map and glow); the HDRI demo with sun NEE (the sun above the horizon)
    and env NEE, the lobe on; the sky scene with the textured blob; then
    the two camera cases of the Cornell box: a thin lens (aperture 1,
    focus 100) and camera_is_moving, with the TRANSPARENT sphere."""
    place = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5))
    box, sky = dict(translation=(0.0, -20.0, -85.0), **place), dict(translation=(0.0, 0.0, -165.0), **place)
    hdri_cfg = dict(bounces=4, env="hdri", diffuse_indirect_max=2, metal_roughness_lobe=True)
    varying = textured_model(varying=True, normal=True)
    hdri = hdri_scene(mesh_from_model(varying, mat_type=DIFFUSE, **sky),
                      synthetic_hdr(32, 64, sun_uv=(0.7, 0.7)), device=device)
    lobe = IntegratorConfig(bounces=4, metal_roughness_lobe=True)
    sky_scene = physical_sky_scene(device=device)._replace(
        mesh=gltf_scene(mesh_from_model(varying, **sky), device=device).mesh)
    return {
        "gltf-lobe": (gltf_scene(mesh_from_model(varying, **box), device=device), gltf_camera(device=device), lobe),
        "mixed-sizes": (gltf_scene(mesh_from_model(mixed_size_model(), **box), device=device),
                        gltf_camera(device=device), lobe),
        "edited-albedo": (gltf_scene(mesh_from_model(varying, **box), device=device), gltf_camera(device=device),
                          lobe),
        "gltf-glow": (gltf_scene(mesh_from_model(textured_model(mr=(0.0, 0.25, 0.0), emissive=(0.4, 0.2, 0.1),
                                                                normal=True), **box), device=device),
                      gltf_camera(device=device), IntegratorConfig(bounces=4)),
        "hdri-sun": (hdri, hdri_camera(device=device),
                     IntegratorConfig(nee="sun", sun_weight_mode="hdri", sun_lobe_roughness=0.03, **hdri_cfg)),
        "hdri-env": (hdri, hdri_camera(device=device), IntegratorConfig(nee="env", **hdri_cfg)),
        "sky": (sky_scene, sky_camera(device=device), IntegratorConfig(bounces=4, env="sky", nee="sun",
                                                                        metal_roughness_lobe=True)),
        **{f"normal-only-{label}": (gltf_scene(mesh_from_model(textured_model(normal=True, albedo=False), mat_type=mat,
                                                               **box), device=device),
                                    gltf_camera(device=device), IntegratorConfig(bounces=4))
           for label, mat in (("transparent", TRANSPARENT), ("diffuse", DIFFUSE))},
        "dof": (cornell_scene(right_sphere_mat=TRANSPARENT, device=device),
                cornell_camera(device=device)._replace(aperture_size=torch.tensor(1.0, device=device),
                                                       focus_distance=torch.tensor(100.0, device=device)),
                IntegratorConfig(bounces=4)),
        "moving": (cornell_scene(right_sphere_mat=TRANSPARENT, device=device), cornell_camera(device=device),
                   IntegratorConfig(bounces=4, camera_is_moving=True)),
    }


def _edit_maps(scene):
    """The textured scene with its albedo halved in place and its normal map
    replaced by a flipped copy: the next launch must repack both."""
    mesh = scene.mesh
    mesh.albedo.mul_(0.5)
    return scene._replace(mesh=mesh._replace(normal_map=torch.flip(mesh.normal_map, dims=(1,)).contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gltf-lobe", "gltf-glow", "hdri-sun", "hdri-env", "sky", "normal-only-transparent",
                                  "normal-only-diffuse", "dof", "moving", "mixed-sizes", "edited-albedo"])
def test_cuda_textured_and_camera_cases_match_plain_version(cuda_device, case):
    """64x64, 4 bounces, frame 2: the textured configuration (under quad,
    sun and env NEE, with and without the metal roughness lobe, and with a
    normal map alone on a TRANSPARENT and a DIFFUSE mesh) and the
    Cornell kernel with a thin lens and with camera_is_moving equal their
    plain versions bit for bit.  The plain run shows each branch the case
    claims: every PBR class, emissive terminations and lobe draws with a
    roughness above 0 (varying maps); with a normal map alone, normal-map
    samples and no PBR hit; the lens is open; the moving flag changes the
    sharpness flags.  With maps of three sizes (two of them sharing the
    texel table's records, one a single row), and after the albedo is
    edited in place and the normal map replaced between two launches (the
    second launch repacks both and differs from the first)."""
    scene, cam, cfg = _textured_cases(cuda_device)[case]
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    name = megakernel.configuration(scene, cfg)
    assert name == ("cornell" if case in ("dof", "moving") else "textured")
    runs = []
    for _ in range(2 if case == "edited-albedo" else 1):
        if runs:
            scene = _edit_maps(scene)
        before = megakernel.LAUNCHES[name]
        got = megakernel.trace_image_fused(scene, cam, cfg, 64, 64, 2.0, RV, bn)
        assert megakernel.LAUNCHES[name] == before + 1
        counts = []
        ref = megakernel.trace_image_fused_reference(scene, cam, cfg, 64, 64, 2.0, RV, bn, lane_counts=counts)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        runs.append(got)
    if len(runs) == 2:
        assert not torch.equal(runs[0].color, runs[1].color)
        assert not torch.equal(runs[0].object_normal, runs[1].object_normal)
    if case.startswith("normal-only"):
        samples = sum(c.texel_samples for c in counts).tolist()
        assert samples[1] > 0 and sum(samples) == samples[1], samples
        assert sum(sum(c.pbr_classes for c in counts).tolist()) == 0
    elif name == "textured":
        classes = sum(c.pbr_classes for c in counts).tolist()
        assert sum(int(c.emissive_hits) for c in counts) > 0
        if case != "gltf-glow":
            assert min(classes) > 0 and sum(int(c.lobe_draws) for c in counts) > 0, classes
    elif case == "dof":
        assert float(cam.aperture_size) > 0.0
    else:
        still = megakernel.trace_image_fused(scene, cam, dataclasses.replace(cfg, camera_is_moving=False), 64, 64,
                                             2.0, RV, bn)
        assert not torch.equal(still.pixel_sharpness, got.pixel_sharpness)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gltf-lobe", "gltf-glow", "hdri-sun", "hdri-env", "sky", "normal-only-transparent",
                                  "normal-only-diffuse", "mixed-sizes", "edited-albedo"])
def test_cuda_textured_grads_kernels_match_plain_version(cuda_device, case):
    """The grads mode of the textured configuration under quad, sun and env
    NEE: every plane equal to the plain version's bit for bit, the composed
    color within float rounding of the forward kernel's; the plain run
    shows albedo factors deferred (and emissive terminations where the maps
    glow).  With maps of three sizes, and after an edit of the albedo (which
    the grads kernel does not read; the composition does) and of the normal
    map between two launches."""
    scene, cam, cfg = _textured_cases(cuda_device)[case]
    counts = _grads_case_check(scene, cam, cfg, cuda_device)
    if case == "edited-albedo":
        counts = _grads_case_check(_edit_maps(scene), cam, cfg, cuda_device)
    if not case.startswith("normal-only"):
        assert sum(int(c.emissive_hits) for c in counts) > 0
        assert sum(sum(c.pbr_classes.tolist()) for c in counts) > 0


def _staged_cases(device):
    """Every configuration of K1 for the staged kernel: Cornell METAL and
    TRANSPARENT, quadric, sky, the blob mesh, HDRI sun and env NEE, the
    textured blob under the glTF demo's and the HDRI demo's sun
    configuration, the lobe on."""
    mesh_cases, textured = _mesh_and_hdri_cases(device), _textured_cases(device)
    return {
        "cornell-metal": (cornell_scene(right_sphere_mat=METAL, device=device), cornell_camera(device=device),
                          IntegratorConfig(bounces=4)),
        "cornell-glass": (cornell_scene(right_sphere_mat=TRANSPARENT, device=device), cornell_camera(device=device),
                          IntegratorConfig(bounces=4)),
        "quadric": (quadric_geometry_scene(device=device), quadric_camera(device=device),
                    IntegratorConfig(bounces=4, transparent_tint=True)),
        "sky": (physical_sky_scene(device=device), sky_camera(device=device),
                IntegratorConfig(bounces=4, env="sky", nee="sun")),
        "mesh": mesh_cases["mesh"], "hdri-sun": mesh_cases["hdri-sun-up"], "hdri-env": mesh_cases["hdri-env"],
        "textured": textured["gltf-lobe"], "textured-hdri-sun": textured["hdri-sun"],
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell-metal", "cornell-glass", "quadric", "sky", "mesh", "hdri-sun", "hdri-env",
                                  "textured", "textured-hdri-sun"])
def test_cuda_staged_pool_matches_k1(cuda_device, case):
    """64x64, 4 bounces: a pool of frames 2 and 3 through the staged kernel
    equals two K1 launches bit for bit, forward (11 planes) and grads mode
    (with the sg and deferred planes), one staged launch per phase."""
    from bpt_tpu_torch.kernels import staged

    scene, cam, cfg = _staged_cases(cuda_device)[case]
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    frames, rvs = (2.0, 3.0), (RV, np.array([0.6, 0.1], np.float32))
    name = megakernel.configuration(scene, cfg)
    for grads in (False, True):
        counts = megakernel.STAGED_GRAD_LAUNCHES if grads else megakernel.STAGED_LAUNCHES
        before = counts[name]
        pool, sg, deferred = staged.trace_staged(scene, cam, cfg, 64, 64, frames, rvs, bn, grads=grads)
        assert counts[name] == before + cfg.bounces
        for i, (frame, rv) in enumerate(zip(frames, rvs)):
            one = (megakernel.trace_image_fused_grads(scene, cam, cfg, 64, 64, frame, rv, bn) if grads
                   else (megakernel.trace_image_fused(scene, cam, cfg, 64, 64, frame, rv, bn), None, None))
            torch.cuda.synchronize()
            for a, b in zip(pool, one[0]):
                torch.testing.assert_close(a[i], b, rtol=0, atol=0)
            if grads:
                torch.testing.assert_close(sg[:, i], one[1], rtol=0, atol=0)
                torch.testing.assert_close(deferred[:, i], one[2], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell-glass", "textured"])
def test_cuda_staged_phase_matches_plain_phase(cuda_device, case):
    """One staged launch from a sorted state against trace_phase_reference
    from the same state: the live lanes' rows, every dead lane's flags and
    every output plane bit for bit; the permutation moved lanes.  The
    boxes both launches wrote give the key kernel sort_key's key and box."""
    from bpt_tpu_torch.kernels import staged

    scene, cam, cfg = _staged_cases(cuda_device)[case]
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    pool = staged.make_pool(64, 64, (2.0, 3.0), (RV, np.array([0.6, 0.1], np.float32)), cuda_device)
    for grads in (False, True):
        kernel = megakernel.empty_outputs(scene, cfg, (2, 64, 64), grads, cuda_device)
        boxes = [staged.phase_boxes(pool, lo, cuda_device) for lo in (0, 1)]
        state = staged.launch_phase(scene, cam, cfg, pool, bn, None, None, 0, 1, kernel, boxes[0])
        perm = torch.sort(staged.launch_key(state, boxes=boxes[0])[0], stable=True).indices
        assert not torch.equal(perm, torch.arange(pool.lanes, device=cuda_device))
        plain = {k: None if v is None else v.clone() for k, v in kernel.items()}
        got = staged.launch_phase(scene, cam, cfg, pool, bn, state, perm, 1, 2, kernel, boxes[1])
        ref = staged.trace_phase_reference(scene, cam, cfg, pool, bn, state, perm, 1, 2, plain)
        torch.cuda.synchronize()
        for rows, box in ((state, boxes[0]), (got, boxes[1])):
            key, lo, hi = staged.launch_key(rows, boxes=box)
            assert torch.equal(key, staged.sort_key(rows)) and torch.equal(torch.cat([lo, hi]),
                                                                           torch.cat(staged.key_box(rows)))
        live = (ref[:, staged.FLAGS_WORD] & 1) != 0
        torch.testing.assert_close(got[:, staged.FLAGS_WORD], ref[:, staged.FLAGS_WORD], rtol=0, atol=0)
        torch.testing.assert_close(got[live], ref[live], rtol=0, atol=0)
        for k in kernel:
            if kernel[k] is not None:
                torch.testing.assert_close(kernel[k], plain[k], rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_cuda_staged_batched_render(cuda_device):
    """attach_cuda_path(reorder=True): render(spp=5, batch=2) traces each
    batch as one pool (a staged launch per bounce and batch, one K1 launch
    for the first sample) and equals the unattached render bit for bit; a
    second attach without reorder steps frame by frame again."""
    renderers = [ProgressiveRenderer(cornell_scene(), IntegratorConfig(bounces=4), 64, 64, seed=7, device=cuda_device)
                 for _ in range(2)]
    attach_cuda_path(renderers[1], reorder=True)
    staged_before, k1_before = megakernel.STAGED_LAUNCHES["cornell"], megakernel.LAUNCHES["cornell"]
    img = renderers[1].render(cornell_camera(), spp=5, batch=2)
    assert megakernel.STAGED_LAUNCHES["cornell"] == staged_before + 4 * 2
    assert megakernel.LAUNCHES["cornell"] == k1_before + 1
    ref = renderers[0].render(cornell_camera(), spp=5, batch=2)
    torch.testing.assert_close(renderers[1].state.accum, renderers[0].state.accum, rtol=0, atol=0)
    torch.testing.assert_close(img, ref, rtol=0, atol=0)
    attach_cuda_path(renderers[1])
    assert renderers[1].batch_step is None


KEY_EDGE_CASES = ["all-dead", "one-live", "zeros-and-faces", "nan-in-dead-rows", "zero-directions"]


def key_edge_pools(n=512, seed=3) -> dict:
    """Edge pools of the sort key, as numpy (ro, rd, alive): every lane
    dead; one live lane (a box of one point); origins at +-0.0 and on the
    live box's faces (an axis whose box is a zero of either sign, one whose
    box has no extent); NaN and infinities in the dead rows' ro and rd;
    direction components at exactly +-0.0 and on dir-morton's cell edges."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 30, (n, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    live = rng.random(n) < 0.9
    faces = np.stack([rng.choice(np.array(v, np.float32), n) for v in
                      ([-0.0, 0.0, 4.0], [-7.5, 7.5, -0.0, 0.0, 1.25], [-0.0, 0.0])], axis=1)
    half = rng.random(n) < 0.5
    nan_ro, nan_rd = ro.copy(), rd.copy()
    nan_ro[~half] = np.nan
    nan_rd[~half] = np.array([np.nan, np.inf, -np.inf], np.float32)
    edges = rng.choice(np.array([-0.0, 0.0, -1.0, -0.5, 0.5, 1.0, 0.3], np.float32), (n, 3))
    return {"all-dead": (ro, rd, np.zeros(n, bool)), "one-live": (ro, rd, np.arange(n) == 37),
            "zeros-and-faces": (faces, rd, live), "nan-in-dead-rows": (nan_ro, nan_rd, half),
            "zero-directions": (ro, edges, live)}


def pack_key_state(ro, rd, alive, seed=4) -> torch.Tensor:
    """A state of the staged path's row layout holding ``ro``, ``rd`` and
    the alive bit, with other flag bits set and seeded garbage in every word
    the key does not read."""
    from bpt_tpu_torch.kernels import staged

    rng = np.random.default_rng(seed)
    n = len(alive)
    state = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n, staged.STATE_WORDS), dtype=np.int64).astype(np.int32))
    state[:, staged.RO_WORD:staged.RO_WORD + 3] = torch.from_numpy(np.ascontiguousarray(ro)).view(torch.int32)
    state[:, staged.RD_WORD:staged.RD_WORD + 3] = torch.from_numpy(np.ascontiguousarray(rd)).view(torch.int32)
    state[:, staged.FLAGS_WORD] = torch.from_numpy((alive.astype(np.int32) | (rng.integers(0, 2 ** 15, n) << 1))
                                                   .astype(np.int32))
    return state


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["oct-morton", "morton-oct", "dir-morton"])
@pytest.mark.parametrize("case", KEY_EDGE_CASES)
def test_cuda_key_kernel_matches_its_plain_halves(cuda_device, case, mode):
    """On the edge pools, each pass of the key kernel equals its plain half:
    pass 1's box over the rows equals key_box's (as values: the key is
    blind to the sign of a zero), pass 2 from the plain box (given as the
    one box to reduce) equals key_from_box bit for bit; the whole kernel
    equals sort_key on the card and on the CPU, and gives torch.sort the
    same permutation; one count per key."""
    from bpt_tpu_torch.kernels import staged

    host = pack_key_state(*key_edge_pools()[case])
    state = host.to(cuda_device)
    lo, hi = staged.key_box(state)
    before = staged.KEY_LAUNCHES[mode]
    key, klo, khi = staged.launch_key(state, mode)
    alone = staged.launch_key(state, mode, boxes=torch.cat([lo, hi])[None])[0]
    assert staged.KEY_LAUNCHES[mode] == before + 2
    plain = staged.sort_key(state, mode)
    torch.cuda.synchronize()
    assert torch.equal(klo, lo) and torch.equal(khi, hi)
    torch.testing.assert_close(alone, staged.key_from_box(state, lo, hi, mode), rtol=0, atol=0)
    torch.testing.assert_close(key, plain, rtol=0, atol=0)
    torch.testing.assert_close(key.cpu(), staged.sort_key(host, mode), rtol=0, atol=0)
    torch.testing.assert_close(torch.sort(key, stable=True).indices, torch.sort(plain, stable=True).indices,
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["capacity", "cornell"])
def test_cuda_key_kernel_on_real_pool_states(cuda_device, case):
    """A 1024x1024 pool of frames 2 and 3 (the capacity mesh from the glTF
    camera, the Cornell box), phase by phase: at each boundary the key
    kernel, from the rows and from the boxes K2 wrote, equals sort_key in
    every mode, and so does the permutation."""
    from bpt_tpu_torch.kernels import staged
    from bpt_tpu_torch.scenes.gltf_scene import heightfield_model

    if case == "capacity":
        scene = gltf_scene(mesh_from_model(heightfield_model(), mat_type=DIFFUSE, use_native="require"),
                           device=cuda_device)
        cam = gltf_camera(device=cuda_device)
    else:
        scene, cam = cornell_scene(device=cuda_device), cornell_camera(device=cuda_device)
    cfg = IntegratorConfig(bounces=4)
    bn = torch.as_tensor(blue_noise_table()).to(cuda_device)
    pool = staged.make_pool(1024, 1024, (2.0, 3.0), (RV, np.array([0.6, 0.1], np.float32)), cuda_device)
    outputs = megakernel.empty_outputs(scene, cfg, (2, 1024, 1024), False, cuda_device)
    boxes = staged.phase_boxes(pool, 0, cuda_device)
    state, perm = staged.launch_phase(scene, cam, cfg, pool, bn, None, None, 0, 1, outputs, boxes), None
    for lo in range(1, cfg.bounces):
        for mode in staged.KEY_MODES:
            key = staged.launch_key(state, mode, boxes)[0]
            plain = staged.sort_key(state, mode)
            torch.testing.assert_close(key, plain, rtol=0, atol=0)
            torch.testing.assert_close(staged.launch_key(state, mode)[0], plain, rtol=0, atol=0)
            sorted_key = torch.sort(key, stable=True)
            torch.testing.assert_close(sorted_key.indices, torch.sort(plain, stable=True).indices, rtol=0, atol=0)
            if mode == "oct-morton":
                perm = sorted_key.indices
        assert bool((key != 1 << 30).any())
        boxes = None if lo + 1 >= cfg.bounces else staged.phase_boxes(pool, lo, cuda_device)
        state = staged.launch_phase(scene, cam, cfg, pool, bn, state, perm, lo, lo + 1, outputs, boxes)



def _loop_cost_inputs(device, seed=0):
    """The tool's inputs, and a seeded table whose rows grow or (about half)
    shrink the tile, so that the max and the any-reduce go both ways."""
    from bpt_tpu_torch.tools import loop_cost as tool

    rng = np.random.default_rng(seed)
    shrink = np.where(rng.random((64, 1)) < 0.5, -2e-3, 0.0)
    seeded = ((1.0 + rng.uniform(-1e-3, 1e-3, (64, 128)) + shrink).astype(np.float32),
              rng.uniform(0.5, 1.5, (8, 256)).astype(np.float32))
    return [tuple(torch.from_numpy(a).to(device) for a in pair) for pair in ((tool.table(), tool.tile_input(3)),
                                                                              seeded)]


@pytest.mark.cuda
@pytest.mark.parametrize("config", [(0, False, False), (40, False, False), (100, False, False), (320, False, False),
                                    (40, True, False), (40, True, True), (320, True, True)])
def test_cuda_loop_cost_matches_plain_version(cuda_device, config):
    """K5 in each instantiation equals its plain version on the card bit for
    bit (an explicit FMA in both), 30 iterations, one launch each; and, 4
    iterations each, on chip_smoke's shrinking table with one rising
    element in each of the tile's 8 rows in turn, where the any-reduce is
    set by one block of the cluster alone (every iteration's flag set)."""
    from bpt_tpu_torch.kernels import loop_cost as k5

    rises = [(tuple(torch.from_numpy(a).to(cuda_device) for a in (tab, x)), 4)
             for _, tab, x in loop_cost_rise_inputs()]
    for (tab, x), n_iter in [(pair, 30) for pair in _loop_cost_inputs(cuda_device)] + rises:
        before = k5.LAUNCHES[config]
        got = k5.loop_cost(tab, x, n_iter, *config)
        assert k5.LAUNCHES[config] == before + 1
        flags = []
        ref = k5.loop_cost_reference(tab, x, n_iter, *config, flags=flags)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        assert bool(torch.isfinite(got).all()) and (config[0] == 0) == bool(torch.equal(got, x))
        if n_iter == 4 and config[1]:
            assert [bool(f) for f in flags] == [True] * 4


@pytest.mark.cuda
def test_cuda_loop_cost_refusals(cuda_device):
    """A configuration without an instantiation, a tensor on another device,
    of another dtype or not contiguous raise, and launch nothing; the C
    entry refuses an unknown configuration itself."""
    from bpt_tpu_torch.kernels import loop_cost as k5

    tab, x = _loop_cost_inputs(cuda_device)[1]
    before = dict(k5.LAUNCHES)
    for config in ((41, False, False), (0, True, False), (40, False, True), (100, True, True)):
        with pytest.raises(ValueError, match="no kernel instantiation"):
            k5.loop_cost(tab, x, 4, *config)
    with pytest.raises(ValueError, match="tab is on"):
        k5.loop_cost(tab.cpu(), x, 4, 40, False, False)
    with pytest.raises(TypeError, match="float32"):
        k5.loop_cost(tab, x.double(), 4, 40, False, False)
    with pytest.raises(ValueError, match="contiguous"):
        k5.loop_cost(tab, x.t().contiguous().t(), 4, 40, False, False)
    assert k5.LAUNCHES == before
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    assert k5._library().bpt_loop_cost(tab.data_ptr(), x.data_ptr(), out.data_ptr(), 4, 41, 0, 0, stream) != 0


@pytest.mark.cuda
def test_cuda_profiler_section_waits_for_the_card(cuda_device, tmp_path):
    """A device_trace around a launch holds the kernel."""
    from bpt_tpu_torch.kernels import loop_cost as k5
    from bpt_tpu_torch.utils.profiling import device_trace

    tab, x = _loop_cost_inputs(cuda_device)[0]
    k5.loop_cost(tab, x, 10, 320, True, True)
    torch.cuda.synchronize()
    with device_trace(str(tmp_path)):
        k5.loop_cost(tab, x, 10, 40, True, False)
        torch.cuda.synchronize()
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert traces and "loop_cost_kernel" in traces[0].read_text()
