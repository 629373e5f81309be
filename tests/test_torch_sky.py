"""The port's Preetham sky, sun direction, specular lobe and sun-rotation
gradient against the JAX package's, on the CPU.

Inputs are made from a numpy seed.  Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu import sky as jsky
from bpt_tpu.core.sampling import specular_lobe_from_uniforms as j_lobe
from bpt_tpu.diff.gradients import make_render_loss as j_make_render_loss
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.scenes.sky_scene import physical_sky_scene as j_sky_scene
from bpt_tpu.scenes.sky_scene import sky_camera as j_sky_camera
from bpt_tpu.scenes.sky_scene import sun_direction_from_rotation as j_sun_dir
from bpt_tpu_torch import sky
from bpt_tpu_torch.core.sampling import specular_lobe_from_uniforms
from bpt_tpu_torch.diff import finite_difference, make_render_loss, value_and_param_grads
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.scenes.sky_scene import physical_sky_scene, sky_camera, sun_direction_from_rotation

torch.set_num_threads(2)

GEN = np.random.default_rng(11)
DIRS = GEN.normal(size=(4096, 3)).astype(np.float32)
ROTATIONS = [(298.0, 318.0), (330.0, 45.0), (275.0, 200.0)]  # the demo's sun, a high sun, a low one


@pytest.mark.parametrize("rot", ROTATIONS)
def test_get_sky_color_matches_jax(rot):
    """Unnormalized seeded view directions (the sun disc included: the first
    rays point at the sun); rtol 1e-5, atol 1e-7."""
    sun = np.array(j_sun_dir(*rot))
    dirs = DIRS.copy()
    dirs[:16] = sun * np.float32(3.0) + GEN.normal(scale=1e-3, size=(16, 3)).astype(np.float32)
    want = np.asarray(jsky.get_sky_color(jnp.asarray(dirs), jnp.asarray(sun)))
    got = sky.get_sky_color(torch.as_tensor(dirs), torch.as_tensor(sun)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert np.isfinite(got).all() and got.max() > 0.0


@pytest.mark.parametrize("rot", ROTATIONS)
def test_sun_direction_from_rotation_matches_jax(rot):
    """rtol 1e-6; tensor angles keep their graph."""
    want = np.asarray(j_sun_dir(*rot))
    np.testing.assert_allclose(sun_direction_from_rotation(*rot).numpy(), want, rtol=1e-6, atol=1e-7)
    rx = torch.tensor(rot[0], requires_grad=True)
    d = sun_direction_from_rotation(rx, rot[1])
    (g,) = torch.autograd.grad(d[1], rx)
    want_g = float(jax.grad(lambda a: j_sun_dir(a, rot[1])[1])(jnp.float32(rot[0])))
    np.testing.assert_allclose(g.item(), want_g, rtol=1e-5)


@pytest.mark.parametrize("roughness", [0.03, 0.1, 0.6])
def test_specular_lobe_matches_jax(roughness):
    """4096 seeded axes and uniform pairs; rtol 1e-5, atol 1e-6."""
    gen = np.random.default_rng(5)
    axis = gen.normal(size=(4096, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    c, p = gen.random(4096).astype(np.float32), gen.random(4096).astype(np.float32)
    want = np.asarray(j_lobe(jnp.asarray(axis), roughness, jnp.asarray(c), jnp.asarray(p)))
    got = specular_lobe_from_uniforms(torch.as_tensor(axis), roughness, torch.as_tensor(c), torch.as_tensor(p))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


RES = 24


def _port_loss():
    cam = sky_camera()
    return make_render_loss(lambda p: (physical_sky_scene(p["rx"], p["ry"]), cam),
                            IntegratorConfig(bounces=2, env="sky", nee="sun"), RES, RES, frames=(1.0, 2.0))


@pytest.fixture(scope="module")
def sun_rotation_grads():
    params = {"rx": torch.tensor(298.0), "ry": torch.tensor(318.0)}
    loss = _port_loss()
    value, g = value_and_param_grads(loss, params)
    return value, g, loss, params


def test_sun_rotation_gradient_matches_finite_differences(sun_rotation_grads):
    """The port of tests/test_gradients.py::test_sun_rotation_gradients_match_fd:
    autograd through the wavefront against central differences (eps 0.05
    degrees), rtol 0.15 with atol 0.15 of the largest FD component."""
    _, g, loss, params = sun_rotation_grads
    fd = finite_difference(loss, params, eps=0.05)
    got = np.array([g["rx"].item(), g["ry"].item()])
    want = np.array([fd["rx"].item(), fd["ry"].item()])
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=0.15, atol=0.15 * np.abs(want).max())


def test_sun_rotation_gradient_matches_jax_grad(sun_rotation_grads):
    """The same gradient against jax.grad of the JAX loss on the same
    frames, blue noise and rand_vec2: loss within rtol 1e-4 (measured
    1.1e-5), gradient within rtol 1e-3 (measured 3.6e-4 on the smaller Y
    component)."""
    value, g, _, _ = sun_rotation_grads
    cam = j_sky_camera()
    jloss = j_make_render_loss(lambda p: (j_sky_scene(p["rx"], p["ry"]), cam),
                               JConfig(bounces=2, env="sky", nee="sun"), RES, RES, frames=(1.0, 2.0))
    params = {"rx": jnp.asarray(298.0), "ry": jnp.asarray(318.0)}
    jvalue, jg = jax.value_and_grad(jloss)(params)
    np.testing.assert_allclose(value.item(), float(jvalue), rtol=1e-4)
    np.testing.assert_allclose([g["rx"].item(), g["ry"].item()], [float(jg["rx"]), float(jg["ry"])], rtol=1e-3)


def test_fov_gradient_on_sky_only_scene_matches_fd():
    """The port of tests/test_gradients.py::test_camera_fov_gradient_matches_fd_on_smooth_scene:
    a scene of the sky alone (no quads: the loss runs on the camera's
    device), d(mean radiance)/d(fov) by autograd against central
    differences (eps 1e-3), rtol 0.05."""
    from bpt_tpu_torch.camera import Camera
    from bpt_tpu_torch.scenes.types import Scene

    sky_only = Scene(env=physical_sky_scene().env)

    def build(p):
        return sky_only, Camera.look(position=(0.0, -20.0, -120.0), fov=p["fov"], focus_distance=113.0)

    loss = make_render_loss(build, IntegratorConfig(bounces=2, env="sky", nee="sun"), RES, RES, frames=(1.0, 2.0))
    params = {"fov": torch.tensor(0.8)}
    _, g = value_and_param_grads(loss, params)
    fd = finite_difference(loss, params, eps=1e-3)
    assert g["fov"].item() != 0.0
    np.testing.assert_allclose(g["fov"].item(), fd["fov"].item(), rtol=0.05, atol=0.05 * abs(fd["fov"].item()))
