"""Checkpoint / resume of the port (bpt_tpu_torch.utils.checkpoint) on the
CPU: tests/test_aux.py:18's bar (a resumed step_state equals one that never
stopped, bit for bit), the renderer with its generator, the pytree pair
(nested without ``like``, a deliberate divergence from the JAX package), and
a JAX state carried across, saved and continued in both packages within
test_torch_renderer.py's test_state_carried_across_from_jax bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.renderer import init_state as j_init_state
from bpt_tpu.renderer import step_state as j_step_state
from bpt_tpu.scenes.cornell import cornell_camera as j_cornell_camera
from bpt_tpu.scenes.cornell import cornell_scene as j_cornell_scene
from bpt_tpu.utils.checkpoint import load_pytree as j_load_pytree
from bpt_tpu.utils.checkpoint import save_pytree as j_save_pytree
from bpt_tpu_torch import convert
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.renderer import ProgressiveRenderer, RenderState, init_state, step_state
from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
from bpt_tpu_torch.utils.checkpoint import (load_pytree, load_render_state, load_renderer, save_pytree,
                                            save_render_state, save_renderer)

torch.set_num_threads(2)

RES = 32
BN = blue_noise_table()
TBN = torch.as_tensor(BN)
RV = np.array([0.3, 0.7], np.float32)
CFG = IntegratorConfig(bounces=2)


def test_checkpoint_roundtrip_resumes_progressive_render(tmp_path):
    """tests/test_aux.py:18: three frames, saved and loaded; the next frame
    from the checkpoint equals the next frame of the state that never
    stopped, bit for bit."""
    scene, camera = cornell_scene(), cornell_camera()
    state = init_state(RES, RES)
    for _ in range(3):
        state = step_state(scene, camera, CFG, state, False, RV, TBN)
    path = save_render_state(str(tmp_path / "ckpt.pt"), state)
    restored = load_render_state(path)
    assert isinstance(restored, RenderState)
    torch.testing.assert_close(restored.accum, state.accum, rtol=0, atol=0)
    assert restored.sample_counter == 3.0 and restored.frame_counter == 3.0
    cont_a = step_state(scene, camera, CFG, state, False, RV, TBN)
    cont_b = step_state(scene, camera, CFG, restored, False, RV, TBN)
    torch.testing.assert_close(cont_b.accum, cont_a.accum, rtol=0, atol=0)
    assert (cont_b.sample_counter, cont_b.frame_counter) == (4.0, 4.0)


def test_renderer_resumes_with_its_generator(tmp_path):
    """A renderer saved after 3 frames and loaded into a fresh one renders
    frames 4 and 5 as one that never stopped: the generator's 128-bit PCG64
    state and the last camera matrix come back (without them the fresh
    renderer would draw other offsets and count the camera as moving)."""
    camera = cornell_camera()
    whole = ProgressiveRenderer(cornell_scene(), CFG, RES, RES, blue_noise=BN, seed=7, device="cpu")
    part = ProgressiveRenderer(cornell_scene(), CFG, RES, RES, blue_noise=BN, seed=7, device="cpu")
    for _ in range(3):
        whole.render_sample(camera)
        part.render_sample(camera)
    path = save_renderer(str(tmp_path / "renderer.pt"), part)
    saved = torch.load(path, weights_only=True)
    assert saved["rng"]["state"]["state"] == part._np_rng.bit_generator.state["state"]["state"] > 2 ** 64
    fresh = load_renderer(path, ProgressiveRenderer(cornell_scene(), CFG, RES, RES, blue_noise=BN, seed=123,
                                                    device="cpu"))
    for _ in range(2):
        whole.render_sample(camera)
        fresh.render_sample(camera)
    torch.testing.assert_close(fresh.state.accum, whole.state.accum, rtol=0, atol=0)
    assert fresh.state.sample_counter == whole.state.sample_counter == 5.0
    torch.testing.assert_close(fresh.display(), whole.display(), rtol=0, atol=0)
    # the state without the generator's goes on with other frames
    other = load_renderer(path, ProgressiveRenderer(cornell_scene(), CFG, RES, RES, blue_noise=BN, device="cpu"))
    other._np_rng = np.random.default_rng(123)
    for _ in range(2):
        other.render_sample(camera)
    assert other.state.sample_counter == 5.0 and not torch.equal(other.state.accum, whole.state.accum)
    with pytest.raises(ValueError, match="film"):
        load_renderer(path, ProgressiveRenderer(cornell_scene(), CFG, 16, 16, blue_noise=BN, device="cpu"))


def test_pytree_roundtrip_nested_without_like(tmp_path, monkeypatch):
    """save_pytree / load_pytree: without ``like`` the nested dicts, lists
    and tuples come back as saved.  This diverges from the JAX package on
    purpose: its load_pytree without ``like`` returns a flat list of leaves
    (bpt_tpu/utils/checkpoint.py:85-98), checked here on its .npz path."""
    tree = {"params": {"emission": torch.tensor(4.0), "albedo": torch.rand(4, 4, 3)},
            "adam": [torch.zeros(3), (torch.ones(2), 7)], "step": 12, "lr": 0.5}
    back = load_pytree(save_pytree(str(tmp_path / "tree.pt"), tree))
    assert back.keys() == tree.keys() and isinstance(back["adam"], list) and isinstance(back["adam"][1], tuple)
    torch.testing.assert_close(back["params"]["albedo"], tree["params"]["albedo"], rtol=0, atol=0)
    assert back["adam"][1][1] == 7 and back["step"] == 12 and back["lr"] == 0.5

    # NamedTuples come back as tuples without ``like``, rebuilt with it
    state = RenderState(accum=torch.rand(2, 2, 4), sample_counter=3.0, frame_counter=5.0)
    path = save_pytree(str(tmp_path / "state.pt"), {"state": state})
    assert type(load_pytree(path)["state"]) is tuple
    again = load_pytree(path, like={"state": init_state(2, 2)})["state"]
    assert isinstance(again, RenderState) and again.frame_counter == 5.0
    torch.testing.assert_close(again.accum, state.accum, rtol=0, atol=0)
    with pytest.raises(ValueError, match="keys"):
        load_pytree(path, like={"other": init_state(2, 2)})

    # the reference, without ``like``: a flat list (the defect not copied)
    import bpt_tpu.utils.checkpoint as jck

    monkeypatch.setattr(jck, "_try_orbax", lambda: None)
    flat = j_load_pytree(j_save_pytree(str(tmp_path / "jtree"), {"a": {"b": jnp.ones(2)}, "c": [jnp.zeros(3)]}))
    assert isinstance(flat, list) and len(flat) == 2


def test_state_carried_across_from_jax_and_checkpointed(tmp_path):
    """JAX renders two frames; the state is carried into the port, saved and
    loaded, and both packages render the third frame: equal by
    test_state_carried_across_from_jax's bars (color rtol 1e-4, atol 1e-5 on
    99.5% of pixels; alpha flags on 99%)."""
    jscene, jcam = j_cornell_scene(), j_cornell_camera()
    jcfg, cfg = JConfig(bounces=2), CFG
    rvs = np.random.default_rng(5).random((3, 2)).astype(np.float32)
    bn = jnp.asarray(BN)
    s = j_init_state(RES, RES)
    s = j_step_state(jscene, jcam, jcfg, s, True, jnp.asarray(rvs[0]), bn)
    s = j_step_state(jscene, jcam, jcfg, s, False, jnp.asarray(rvs[1]), bn)
    carried = convert.render_state_from_numpy(jax.tree.map(np.asarray, s))
    restored = load_render_state(save_render_state(str(tmp_path / "carried.pt"), carried))
    ref = j_step_state(jscene, jcam, jcfg, s, False, jnp.asarray(rvs[2]), bn)
    got = step_state(convert.scene_from_numpy(jax.tree.map(np.asarray, jscene)),
                     convert.camera_from_numpy(jax.tree.map(np.asarray, jcam)), cfg, restored, False, rvs[2], TBN)
    assert got.sample_counter == float(ref.sample_counter) == 3.0
    assert got.frame_counter == float(ref.frame_counter) == 3.0
    a, b = got.accum.numpy(), np.asarray(ref.accum)
    close = np.isclose(a[..., :3], b[..., :3], rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() > 0.995, f"accumulated color parity {close.mean():.4f}"
    assert (a[..., 3] == b[..., 3]).mean() > 0.99
