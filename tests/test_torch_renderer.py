"""Edge detection, accumulation, denoise/tonemap and the progressive renderer
of bpt_tpu_torch against bpt_tpu, plus the renderer's own invariants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu import postprocess as jpost
from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.integrator import frame as jframe
from bpt_tpu.integrator.radiance import RadianceResult as JResult
from bpt_tpu.renderer import ProgressiveRenderer as JRenderer
from bpt_tpu.renderer import init_state as j_init_state
from bpt_tpu.renderer import step_state as j_step_state
from bpt_tpu.scenes.cornell import cornell_camera as j_cornell_camera
from bpt_tpu.scenes.cornell import cornell_scene as j_cornell_scene
from bpt_tpu_torch import convert, postprocess
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.integrator import frame
from bpt_tpu_torch.integrator.radiance import RadianceResult
from bpt_tpu_torch.renderer import ProgressiveRenderer, init_state, step_state
from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene

torch.set_num_threads(2)

RES = 64
BN = blue_noise_table()
RV = np.array([0.3, 0.7], np.float32)


def _radiance(seed, h=32, w=48):
    """A seeded RadianceResult with the discrete structure edges come from."""
    gen = np.random.default_rng(seed)
    normals = np.array([[0, 0, 1], [1, 0, 0], [0, -1, 0], [0.6, 0.8, 0]], np.float32)
    palette = np.array([[1, 1, 1], [0.7, 0.05, 0.05], [0.05, 0.05, 0.7], [1, 1, 0]], np.float32)
    return dict(
        color=gen.random((h, w, 3)).astype(np.float32) * 3.0,
        object_normal=normals[gen.integers(0, 4, (h, w))],
        object_color=palette[gen.integers(0, 4, (h, w))],
        object_id=np.array([-1.0e6, 0, 1, 2, 7], np.float32)[gen.integers(0, 5, (h, w))],
        pixel_sharpness=np.array([0.0, -1.0, 1.01], np.float32)[gen.integers(0, 3, (h, w))],
    )


def _accum(seed, h=32, w=48):
    gen = np.random.default_rng(seed)
    rgb = gen.random((h, w, 3)).astype(np.float32) * 5.0
    alpha = np.array([0.0, -1.0, 1.01, 0.5], np.float32)[gen.integers(0, 4, (h, w, 1))]
    return np.concatenate([rgb, alpha], axis=-1)


def _both(d):
    return RadianceResult(**{k: torch.as_tensor(v) for k, v in d.items()}), JResult(**{
        k: jnp.asarray(v) for k, v in d.items()})


def test_detect_edges_matches_jax():
    got, ref = _both(_radiance(0))
    for a, b in zip(frame.detect_edges(got), jframe.detect_edges(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("frame_counter,moving", [(1.0, False), (5.0, False), (1.0, True), (5.0, True)])
def test_finish_frame_matches_jax(frame_counter, moving):
    got, ref = _both(_radiance(1))
    prev = _accum(2)
    a = frame.finish_frame(got, torch.as_tensor(prev), frame_counter, moving)
    b = jframe.finish_frame(ref, jnp.asarray(prev), frame_counter, moving)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_denoise_matches_jax():
    acc = _accum(3)
    np.testing.assert_allclose(postprocess.denoise(torch.as_tensor(acc)).numpy(),
                               np.asarray(jpost.denoise(jnp.asarray(acc))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("inv_n", [1.0 / 3.0, 0.004, 0.0001])
@pytest.mark.parametrize("apply_denoise", [True, False])
def test_screen_output_matches_jax(inv_n, apply_denoise):
    acc = _accum(4)
    a = postprocess.screen_output(torch.as_tensor(acc), inv_n, 1.3, apply_denoise)
    b = jpost.screen_output(jnp.asarray(acc), inv_n, 1.3, apply_denoise)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_accumulation_fsm_counters():
    """Port of tests/test_integrator.py::test_accumulation_fsm_counters."""
    scene, camera, cfg = cornell_scene(), cornell_camera(), IntegratorConfig(bounces=2)
    bn = torch.as_tensor(BN)
    state = init_state(RES, RES)
    state = step_state(scene, camera, cfg, state, False, RV, bn)
    assert state.sample_counter == 1.0 and state.frame_counter == 1.0
    s1 = state.accum[..., :3].clone()
    state = step_state(scene, camera, cfg, state, False, RV, bn)
    assert state.sample_counter == 2.0 and state.frame_counter == 2.0
    s2 = state.accum[..., :3]
    assert s2.sum() > s1.sum()
    state = step_state(scene, camera, cfg, state, True, RV, bn)
    assert state.sample_counter == 1.0 and state.frame_counter == 1.0
    assert state.accum[..., :3].sum() < s2.sum()
    # a moving streak keeps sample_counter at 1 and counts frames on
    state = step_state(scene, camera, cfg, state, True, RV, bn)
    assert state.sample_counter == 1.0 and state.frame_counter == 2.0


def test_camera_move_resets_renderer():
    r = ProgressiveRenderer(cornell_scene(), IntegratorConfig(bounces=2), 16, 16, blue_noise=BN, device="cpu")
    cam = cornell_camera()
    for _ in range(3):
        r.render_sample(cam)
    assert r.state.sample_counter == 3.0
    r.render_sample(cam._replace(position=cam.position + torch.tensor([1.0, 0.0, 0.0])))
    assert r.state.sample_counter == 1.0 and r.state.frame_counter == 1.0


def test_batched_render_equals_per_sample_stepping():
    """Port of tests/test_aux.py::test_batched_render_equals_per_sample_stepping."""
    scene, cam, cfg = cornell_scene(), cornell_camera(), IntegratorConfig(bounces=2)
    r1 = ProgressiveRenderer(scene, cfg, 24, 24, blue_noise=BN, seed=7, device="cpu")
    r2 = ProgressiveRenderer(scene, cfg, 24, 24, blue_noise=BN, seed=7, device="cpu")
    for _ in range(7):
        r1.render_sample(cam)
    img1 = r1.display()
    img2 = r2.render(cam, spp=7, batch=3)
    assert r1.state.sample_counter == r2.state.sample_counter == 7.0
    torch.testing.assert_close(r1.state.accum, r2.state.accum, rtol=0, atol=0)
    torch.testing.assert_close(img1, img2, rtol=0, atol=0)


def test_ceiling_light_is_brightest_up_there():
    """Port of tests/test_integrator.py::test_ceiling_light_is_brightest_up_there."""
    scene, camera, cfg = cornell_scene(), cornell_camera(), IntegratorConfig(bounces=3)
    imgs = [frame.trace_image(scene, camera, cfg, RES, RES, float(f), RV, torch.as_tensor(BN)).color
            for f in range(1, 9)]
    mean = torch.stack(imgs).mean(0).sum(-1)
    assert mean[-RES // 4:].mean() > mean[: RES // 4].mean()


def test_state_carried_across_from_jax():
    """JAX renders two frames; the state is converted and the port renders
    the third, which matches JAX's third frame by the integrator criterion."""
    jscene, jcam = j_cornell_scene(), j_cornell_camera()
    jcfg, cfg = JConfig(bounces=4), IntegratorConfig(bounces=4)
    rvs = np.random.default_rng(5).random((3, 2)).astype(np.float32)
    jstep = jax.jit(j_step_state, static_argnums=(2,))
    bn = jnp.asarray(BN)
    s = j_init_state(RES, RES)
    s = jstep(jscene, jcam, jcfg, s, True, jnp.asarray(rvs[0]), bn)
    s = jstep(jscene, jcam, jcfg, s, False, jnp.asarray(rvs[1]), bn)
    carried = convert.render_state_from_numpy(jax.tree.map(np.asarray, s))
    ref = jstep(jscene, jcam, jcfg, s, False, jnp.asarray(rvs[2]), bn)
    got = step_state(convert.scene_from_numpy(jax.tree.map(np.asarray, jscene)),
                     convert.camera_from_numpy(jax.tree.map(np.asarray, jcam)), cfg, carried, False, rvs[2],
                     torch.as_tensor(BN))
    assert got.sample_counter == float(ref.sample_counter) == 3.0
    assert got.frame_counter == float(ref.frame_counter) == 3.0
    a, b = got.accum.numpy(), np.asarray(ref.accum)
    close = np.isclose(a[..., :3], b[..., :3], rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() > 0.995, f"accumulated color parity {close.mean():.4f}"
    assert (a[..., 3] == b[..., 3]).mean() > 0.99


def test_progressive_render_matches_jax():
    """The whole slice at 64x64: the torch Cornell scene, ProgressiveRenderer
    and render(spp=4) against the JAX renderer with the same seed."""
    jr = JRenderer(j_cornell_scene(), JConfig(bounces=4), RES, RES, blue_noise=jnp.asarray(BN), seed=3)
    ref = np.asarray(jr.render(j_cornell_camera(), spp=4))
    r = ProgressiveRenderer(cornell_scene(), IntegratorConfig(bounces=4), RES, RES, blue_noise=BN, seed=3, device="cpu")
    got = r.render(cornell_camera(), spp=4)
    assert got.shape == (RES, RES, 3) and r.state.sample_counter == 4.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-3)


def test_camera_edited_in_place_resets_and_is_rendered(monkeypatch):
    """A camera edited in place (the same object, cam.position.add_) counts
    as moving, as the reference's 16-float comparison sees it: the third
    sample resets sample_counter to 1 and its rays start from the new
    position.  A camera on another device than the renderer's is copied
    once per distinct set of values, so the edit makes a new copy."""
    import bpt_tpu_torch.renderer as renderer_module

    seen = []
    real = renderer_module.trace_image_fused

    def spy(scene, camera, *args, **kwargs):
        seen.append(camera.position.clone())
        return real(scene, camera, *args, **kwargs)

    monkeypatch.setattr(renderer_module, "trace_image_fused", spy)
    r = ProgressiveRenderer(cornell_scene(), IntegratorConfig(bounces=2), 16, 16, blue_noise=BN, device="cpu")
    cam = cornell_camera()
    r.render_sample(cam)
    r.render_sample(cam)
    assert r.state.sample_counter == 2.0
    cam.position.add_(torch.tensor([5.0, 0.0, 0.0]))
    r.render_sample(cam)
    assert r.state.sample_counter == 1.0 and r.state.frame_counter == 1.0
    torch.testing.assert_close(seen[-1], seen[0] + torch.tensor([5.0, 0.0, 0.0]), rtol=0, atol=0)
    r.render_sample(cam)
    assert r.state.sample_counter == 2.0  # still again

    r.device, r.blue_noise = torch.device("meta"), r.blue_noise.to("meta")  # a stand-in for the card
    first = r._device_camera(cam)
    assert first.position.device.type == "meta" and r._device_camera(cam) is first
    cam.position.add_(torch.tensor([1.0, 0.0, 0.0]))
    assert r._device_camera(cam) is not first
