"""The HDRI family of the port against the JAX package: the equirect lookup,
the brightest-texel sun, the environment CDFs and their sampler, the .hdr
reader and writer, the HDRI scene and its conversion, Scene.to on a mesh +
HDRI scene, and the HDRI demo's render with sun and env NEE.

The blob is tests/test_kernels.py's random triangle soup with 128
triangles, scaled by 1.5, turned and placed in front of the HDRI camera so
that it takes 18.8% of the first hits at 32x128 (the demo's own placement:
0-1 of 4,096 lanes); the map is the demo's ``synthetic_hdr(32, 64)``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apps.hdri_environment import synthetic_hdr as j_synthetic_hdr
from bpt_tpu import env as jenv
from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.integrator.frame import trace_image as j_trace_image
from bpt_tpu.io import hdr as jhdr
from bpt_tpu.io.gltf import GLTFModel as JGLTFModel
from bpt_tpu.scenes.types import Environment as JEnvironment
from bpt_tpu.scenes.types import Quads as JQuads
from bpt_tpu.scenes.types import Scene as JScene
from bpt_tpu.scenes.types import TriangleMesh as JTriangleMesh
from bpt_tpu.scenes.types import UnitSpheres as JUnitSpheres
from bpt_tpu_torch import convert, env
from bpt_tpu_torch.apps.hdri_environment import synthetic_hdr
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.integrator.frame import trace_image
from bpt_tpu_torch.io import hdr
from bpt_tpu_torch.io.gltf import GLTFModel
from bpt_tpu_torch.kernels.megakernel import trace_image_fused
from bpt_tpu_torch.scenes import gltf_scene
from bpt_tpu_torch.scenes.types import DIFFUSE, Scene
from test_torch_kernels import blob_model

torch.set_num_threads(2)
jgltf = importlib.import_module("bpt_tpu.scenes.gltf_scene")  # bpt_tpu.scenes exports a function of that name

BN = blue_noise_table()
RV = np.array([0.3, 0.7], np.float32)
PLACE = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5), translation=(0.0, 0.0, -165.0))
MESH_ID = 6.0  # 2 spheres + 4 quads precede the mesh
SUN_CFG = dict(bounces=3, env="hdri", nee="sun", sun_weight_mode="hdri", sun_lobe_roughness=0.03,
               diffuse_indirect_max=2)  # the demo's (apps/hdri_environment.py)
ENV_CFG = dict(bounces=3, env="hdri", nee="env", diffuse_indirect_max=2)


def _np(x):
    return jax.tree.map(np.asarray, x)


def blob(T=128, seed=0, cls=GLTFModel):
    """tests/test_kernels.py's random triangle blob, T triangles, as the
    port's GLTFModel or (cls) the JAX package's."""
    return cls(*blob_model(T, seed))


def _directions(n=8192, seed=11):
    """Random unit directions, a quarter of them with atan2(x, z) near -pi
    (u * w < 0.5: the bilinear lookup's x0 = -1 wraps to the last column)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 4, 2] = -np.abs(d[: n // 4, 2])
    d[: n // 4, 0] = -rng.uniform(0.0, 1e-3, n // 4) * np.abs(d[: n // 4, 2])
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_synthetic_hdr_is_the_demos():
    np.testing.assert_array_equal(synthetic_hdr(32, 64), j_synthetic_hdr(32, 64))


def test_get_hdr_color_matches_jax():
    """The bilinear equirect lookup on 8,192 directions, a quarter of them in
    the wrapping first half-texel of u: >= 99.9% within rtol 1e-5 (measured
    100%); a lane whose atan2 or acos differs by an ulp between the two CPU
    libraries may cross a texel boundary, which the share allows."""
    img = synthetic_hdr(32, 64)
    d = _directions()
    w = img.shape[1]
    u = np.arctan2(d[:, 0], d[:, 2]) / (2 * np.pi) + 0.5
    assert (u * w < 0.5).mean() > 0.2
    got = env.get_hdr_color(torch.as_tensor(img), torch.as_tensor(d), torch.tensor(1.5)).numpy()
    ref = np.asarray(jenv.get_hdr_color(jnp.asarray(img), jnp.asarray(d), jnp.float32(1.5)))
    close = np.isclose(got, ref, rtol=1e-5, atol=1e-6).all(-1)
    assert close.mean() >= 0.999, close.mean()


def test_sun_direction_and_cdf_tables_match_jax():
    """The brightest-texel sun and the three CDF tables are the JAX
    package's exactly (both computed on the host in float64)."""
    img = synthetic_hdr(32, 64)
    np.testing.assert_array_equal(env.sun_direction_from_hdr(img), jenv.sun_direction_from_hdr(img))
    got, ref = env.build_env_cdf(img), jenv.build_env_cdf(img)
    for name, a, b in zip(env.EnvCDF._fields, got, ref):
        assert a.dtype == torch.float32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("size", [(32, 64), (24, 40)])
def test_sample_env_cdf_matches_jax(size):
    """4,096 draws: the texel (row, column) exact against the one JAX's
    direction points at, the pdf exact, the direction within rtol 1e-6;
    (24, 40) has a width that is no power of 2 (ceil(log2 W) steps)."""
    img = synthetic_hdr(*size)
    rng = np.random.default_rng(2)
    u1, u2 = (rng.random(4096).astype(np.float32) for _ in range(2))
    cdf = env.build_env_cdf(img)
    row, col = env.env_cdf_index(cdf, torch.as_tensor(u1), torch.as_tensor(u2))
    d, pdf = env.sample_env_cdf(cdf, torch.as_tensor(u1), torch.as_tensor(u2))
    jd, jpdf = jenv.sample_env_cdf(jenv.build_env_cdf(img), jnp.asarray(u1), jnp.asarray(u2))
    jd = np.asarray(jd, np.float64)
    h, w = size
    j_row = np.floor(np.arccos(np.clip(-jd[:, 1], -1, 1)) / np.pi * h).astype(np.int64)
    j_col = np.floor((np.arctan2(jd[:, 0], jd[:, 2]) / (2 * np.pi) + 0.5) * w).astype(np.int64)
    np.testing.assert_array_equal(row.numpy(), j_row)
    np.testing.assert_array_equal(col.numpy(), j_col)
    np.testing.assert_array_equal(pdf.numpy(), np.asarray(jpdf))
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-6, atol=1e-7)
    assert len(np.unique(row.numpy())) > h // 4  # the draws spread over the map


def test_hdr_round_trip(tmp_path):
    """write_hdr -> read_hdr through both packages, each way: the same RGBE
    bytes and the same decoded floats."""
    img = synthetic_hdr(16, 32) * np.float32(3.0)
    ours, theirs = tmp_path / "ours.hdr", tmp_path / "theirs.hdr"
    hdr.write_hdr(str(ours), img)
    jhdr.write_hdr(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    back = hdr.read_hdr(str(ours))
    np.testing.assert_array_equal(back, jhdr.read_hdr(str(ours)))
    assert back.shape == img.shape and back.dtype == np.float32
    assert (np.abs(back - img) <= img.max(-1, keepdims=True) / 64).all()  # write_hdr keeps 7 bits of the brightest


def _jax_hdri_scene(sun_uv=(0.7, 0.3)):
    return jgltf.hdri_scene(jgltf.mesh_from_model(blob(cls=JGLTFModel), mat_type=DIFFUSE, **PLACE),
                            j_synthetic_hdr(32, 64, sun_uv=sun_uv), sun_power=4.0)


def test_hdri_scene_and_conversion_match_jax():
    """The port's hdri_scene equals the converted JAX scene field by field
    (CDF tables and map exact, inverse matrices within 1e-6); and JAX ->
    port -> numpy -> JAX carries every field of the environment (the CDFs
    included) and of the mesh exactly."""
    src = _np(_jax_hdri_scene())
    ref = convert.scene_from_numpy(src)
    got = gltf_scene.hdri_scene(gltf_scene.mesh_from_model(blob(), mat_type=DIFFUSE, **PLACE), synthetic_hdr(32, 64),
                                sun_power=4.0)
    for group in Scene._fields:
        if getattr(got, group) is None:
            assert getattr(ref, group) is None, group
            continue
        for name, a, b in zip(getattr(got, group)._fields, getattr(got, group), getattr(ref, group)):
            for x, y in (zip(a, b) if name == "env_cdf" else [(a, b)]):
                assert (x is None) == (y is None), (group, name)
                if x is None:
                    continue
                assert x.dtype == y.dtype and x.shape == y.shape, (group, name)
                atol = 1e-6 if name == "inv_matrix" else 0.0
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=atol, err_msg=f"{group}.{name}")
    back = convert.to_numpy(ref)
    rebuilt = JScene(quads=JQuads(**back.quads._asdict()), spheres=JUnitSpheres(**back.spheres._asdict()),
                     mesh=JTriangleMesh(**{f: getattr(back.mesh, f) for f in convert.MESH_FIELDS}),
                     env=JEnvironment(**back.env._asdict()))
    for name in JEnvironment._fields:
        a, b = getattr(rebuilt.env, name), getattr(src.env, name)
        for x, y in (zip(a, b) if name == "env_cdf" else [(a, b)]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
    for name in convert.MESH_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rebuilt.mesh, name)), getattr(src.mesh, name))


def test_scene_to_moves_a_mesh_and_hdri_scene():
    """Scene.to moves the mesh and the environment's HDRI fields, the CDF
    tables (a tuple) included, to "meta" and back, field by field; a host
    exposure becomes a 0-d float32 tensor and a host material an int32 one."""
    scene = gltf_scene.hdri_scene(gltf_scene.mesh_from_model(blob(16)), synthetic_hdr(8, 16))
    scene = scene._replace(env=scene.env._replace(hdr_exposure=2.0, env_cdf=tuple(scene.env.env_cdf)),
                           mesh=scene.mesh._replace(mat_type=2))
    meta = scene.to("meta")
    for group in ("quads", "spheres", "mesh", "env"):
        for name, a, b in zip(getattr(scene, group)._fields, getattr(scene, group), getattr(meta, group)):
            for x, y in (zip(a, b) if name == "env_cdf" else [(a, b)]):
                if x is None:
                    assert y is None, (group, name)
                    continue
                assert y.device.type == "meta" and y.shape == torch.as_tensor(x).shape, (group, name)
    assert meta.env.hdr_exposure.dtype == torch.float32 and meta.mesh.mat_type.dtype == torch.int32
    back = scene.to("cpu")
    assert isinstance(back.env.env_cdf, tuple) and len(back.env.env_cdf) == 3
    for a, b in zip(back.env.env_cdf, scene.env.env_cdf):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for name in ("p0", "node_tri", "node_min", "inv_matrix"):
        torch.testing.assert_close(getattr(back.mesh, name), getattr(scene.mesh, name), rtol=0, atol=0)
    assert back.env.hdr_exposure.item() == 2.0 and back.mesh.mat_type.item() == 2


#: case -> (the map's sun, the configuration): the demo's map with sun and
#: with env NEE, and sun NEE under a map whose sun is above the horizon.
HDRI_CASES = {"sun": ((0.7, 0.3), SUN_CFG), "env": ((0.7, 0.3), ENV_CFG), "sun-up": ((0.7, 0.7), SUN_CFG)}


@pytest.fixture(scope="module")
def hdri_renders():
    """case -> (JAX scene, JAX's wavefront render of it), computed once."""
    out = {}
    for case, (sun_uv, kw) in HDRI_CASES.items():
        jscene = _jax_hdri_scene(sun_uv)
        out[case] = jscene, _np(j_trace_image(jscene, jgltf.hdri_camera(), JConfig(**kw), 128, 32, 2.0,
                                              jnp.asarray(RV), jnp.asarray(BN)))
    return out


@pytest.mark.parametrize("case", list(HDRI_CASES))
def test_hdri_trace_image_matches_jax(hdri_renders, case):
    """The HDRI demo's configuration with sun NEE and with env NEE, and sun
    NEE with the sun above the horizon, 3 bounces, 32x128, frame 2, by the
    Cornell bar: >= 99.5% of lanes with color within rtol 1e-4 / atol 1e-5
    (measured 99.98% / 100%), first-hit normals within rtol 1e-3 / atol
    1e-4, object colors, ids and >= 99% of sharpness flags equal; the mesh
    takes >= 10% of the first hits, the environment is seen, NEE lights
    lanes, and under the raised sun shadow rays reach it."""
    jscene, ref = hdri_renders[case]
    tscene = convert.scene_from_numpy(_np(jscene))
    tcam = convert.camera_from_numpy(_np(jgltf.hdri_camera()))
    cfg = IntegratorConfig(**HDRI_CASES[case][1])
    got = trace_image_fused(tscene, tcam, cfg, 128, 32, 2.0, RV, torch.as_tensor(BN))  # the plain version on CPU
    if case == "sun-up":
        counts = []
        trace_image(tscene, tcam, cfg, 128, 32, 2.0, RV, torch.as_tensor(BN), lane_counts=counts)
        assert sum(int(c.shadow_misses) for c in counts) > 0
    ids = got.object_id.numpy()
    assert (ids == MESH_ID).mean() >= 0.10 and (ids < -1.0).mean() > 0.3
    close = np.isclose(got.color.numpy(), ref.color, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() > 0.995, f"color parity {close.mean():.4f}"
    np.testing.assert_allclose(got.object_normal.numpy(), ref.object_normal, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.object_color.numpy(), ref.object_color, rtol=1e-6)
    np.testing.assert_array_equal(ids, ref.object_id)
    assert (got.pixel_sharpness.numpy() == ref.pixel_sharpness).mean() > 0.99
    lit_surfaces = (got.color.numpy().max(-1) > 0.0) & (ids >= 0.0)
    assert lit_surfaces.mean() > 0.01


def test_env_nee_lane_counts():
    """LaneCounts reports the shadow rays that reached the environment: env
    NEE sends them at every diffuse vertex."""
    from bpt_tpu_torch.core.rng import blue_noise_table as t_blue_noise_table

    scene = gltf_scene.hdri_scene(gltf_scene.mesh_from_model(blob(), mat_type=DIFFUSE, **PLACE),
                                  synthetic_hdr(32, 64))
    counts = []
    trace_image(scene, gltf_scene.hdri_camera(), IntegratorConfig(**ENV_CFG), 64, 16, 2.0, RV,
                torch.as_tensor(t_blue_noise_table()), lane_counts=counts)
    assert int(counts[0].shadow_misses) == 0 and sum(int(c.shadow_misses) for c in counts[1:]) > 0
    assert int(counts[0].misses) > 0 and int(counts[0].tri_tests) > 0
