"""The staged multi-frame path of the port (``kernels/staged.py``,
``trace_frames_fused``, ``trace_image_fused(reorder=True)``, the renderer's
batched step and ``render_avg(reorder=True)``) on the CPU, where each phase
is the plain version and the sort and the permutations are real.

Against the JAX package: ``_sort_key`` on the same state, exactly (the
interpret-mode staged kernels are in test_torch_staged_interpret.py).
Against the port's own monolithic plain path: bit for bit (the ports of tests/test_kernels.py:377-438 and
tests/test_aux.py:112), since every lane's arithmetic is the same whatever
its place in the pool.  The HDRI env-NEE statistical tests of
tests/test_integrator.py:194,208 run through one pool of 200 and of 64
frames, with their seeds and tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.kernels.megakernel import _sort_key, _state_layout
from bpt_tpu_torch.apps.hdri_environment import synthetic_hdr
from bpt_tpu_torch.camera import Camera
from bpt_tpu_torch.diff.inverse import render_avg
from bpt_tpu_torch.env import build_env_cdf, get_hdr_color, sun_direction_from_hdr
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.kernels import megakernel, staged
from bpt_tpu_torch.kernels.integration import staged_batch_step
from bpt_tpu_torch.renderer import ProgressiveRenderer
from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene, hdri_camera, hdri_scene, mesh_from_model
from bpt_tpu_torch.scenes.sky_scene import physical_sky_scene, sky_camera
from bpt_tpu_torch.scenes.types import DIFFUSE, TRANSPARENT, Environment, Scene, make_quad, quads_from_rows
from test_torch_kernels import blob_model, textured_model

torch.set_num_threads(2)

BN = blue_noise_table()
TBN = torch.as_tensor(BN)
RV = np.array([0.3, 0.7], np.float32)
FRAMES = (2.0, 3.0)
RVS = (RV, np.array([0.6, 0.1], np.float32))
BOX = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5), translation=(0.0, -20.0, -85.0))
SKY = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5), translation=(0.0, 0.0, -165.0))


def _cases():
    """Each configuration the staged path runs, at 32x32 (the blob placed
    where the camera sees it)."""
    return {
        "cornell": (cornell_scene(right_sphere_mat=TRANSPARENT), cornell_camera(), IntegratorConfig(bounces=4)),
        "sky": (physical_sky_scene(), sky_camera(), IntegratorConfig(bounces=4, env="sky", nee="sun")),
        "mesh": (gltf_scene(mesh_from_model(blob_model(), mat_type=DIFFUSE, **BOX)), gltf_camera(),
                 IntegratorConfig(bounces=3)),
        "hdri-env": (hdri_scene(mesh_from_model(blob_model(), mat_type=DIFFUSE, **SKY), synthetic_hdr(32, 64),
                                sun_power=4.0), hdri_camera(),
                     IntegratorConfig(bounces=3, env="hdri", nee="env", diffuse_indirect_max=2)),
        "textured": (gltf_scene(mesh_from_model(textured_model(varying=True, normal=True), **BOX)), gltf_camera(),
                     IntegratorConfig(bounces=3, metal_roughness_lobe=True)),
    }


def _assert_equal(got, ref):
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("splits", [None, (2,)])
@pytest.mark.parametrize("case", ["cornell", "sky", "mesh", "hdri-env", "textured"])
def test_pool_equals_single_frames(case, splits):
    """A pool of frames 2 and 3 equals two monolithic frames bit for bit, in
    the forward and in the grads mode (every plane); the sort moved lanes."""
    scene, cam, cfg = _cases()[case]
    pool = megakernel.trace_frames_fused(scene, cam, cfg, 32, 32, FRAMES, RVS, TBN, reorder_splits=splits)
    grads, sg, deferred = staged.trace_staged(scene, cam, cfg, 32, 32, FRAMES, RVS, TBN, splits=splits, grads=True)
    assert pool.color.shape == (2, 32, 32, 3)
    for i, (frame, rv) in enumerate(zip(FRAMES, RVS)):
        _assert_equal((t[i] for t in pool), megakernel.trace_image_fused(scene, cam, cfg, 32, 32, frame, rv, TBN))
        one, sg_one, deferred_one = megakernel.trace_image_fused_grads(scene, cam, cfg, 32, 32, frame, rv, TBN)
        _assert_equal([t[i] for t in grads] + [sg[:, i], deferred[:, i]], list(one) + [sg_one, deferred_one])
    if case in ("mesh", "textured"):
        assert (pool.object_id == 8.0).any()  # the blob takes first hits
    assert float(pool.color.max()) > 0.0


def test_one_frame_reorder_equals_monolithic():
    """trace_image_fused(reorder=True) is the pool of one frame: bit-equal
    to the monolithic call, forward and differentiable (nothing requires a
    gradient: the forward)."""
    scene, cam, cfg = _cases()["cornell"]
    ref = megakernel.trace_image_fused(scene, cam, cfg, 32, 32, 2.0, RV, TBN)
    _assert_equal(megakernel.trace_image_fused(scene, cam, cfg, 32, 32, 2.0, RV, TBN, reorder=True), ref)
    _assert_equal(megakernel.trace_image_fused(scene, cam, cfg, 32, 32, 2.0, RV, TBN, reorder=True,
                                               reorder_key="dir-morton", differentiable=True), ref)


def test_phases_resume_where_they_stopped():
    """One phase at a time: each phase's sort moves lanes, dead lanes sort
    last and their rows say dead; the plain phase from a permuted state ends
    where the unpermuted one does."""
    scene, cam, cfg = _cases()["textured"]
    pool = staged.make_pool(32, 32, FRAMES, RVS, "cpu")
    outputs = megakernel.empty_outputs(scene, cfg, (2, 32, 32), True, "cpu")
    state = staged.trace_phase_reference(scene, cam, cfg, pool, TBN, None, None, 0, 1, outputs)
    key = staged.sort_key(state)
    perm = torch.sort(key, stable=True).indices
    assert not torch.equal(perm, torch.arange(pool.lanes))
    alive = (state[:, staged.FLAGS_WORD] & 1) != 0
    assert 0 < int(alive.sum()) < pool.lanes and bool((key[~alive] == 1 << 30).all())
    quad = staged.FLAGS_WORD // 4 * 4  # the 16 bytes that hold the flags word: a dead lane's zeros
    assert bool((state[~alive, quad:quad + 4] == 0).all())
    sorted_alive = alive[perm]
    assert bool(sorted_alive[:int(alive.sum())].all())  # the live lanes first
    identity = {k: None if v is None else v.clone() for k, v in outputs.items()}
    after = staged.trace_phase_reference(scene, cam, cfg, pool, TBN, state, perm, 1, 2, outputs)
    after_id = staged.trace_phase_reference(scene, cam, cfg, pool, TBN, state, torch.arange(pool.lanes), 1, 2,
                                            identity)
    for k in outputs:  # the color of a path that has not ended is not written yet: the same garbage in both
        if outputs[k] is not None:
            torch.testing.assert_close(outputs[k], identity[k], rtol=0, atol=0, equal_nan=True)
    flags, home = staged.FLAGS_WORD, staged.HOME_WORD
    rows, rows_id = after[(after[:, flags] & 1) != 0], after_id[(after_id[:, flags] & 1) != 0]
    torch.testing.assert_close(rows[rows[:, home].argsort()], rows_id[rows_id[:, home].argsort()], rtol=0, atol=0)


def test_row_slice_equals_rows_of_the_whole_image():
    """A pool of rows [8, 24) of a 32-row film (row_offset 8) equals those
    rows of the whole image's pool: RNG, blue noise and film use absolute
    rows."""
    scene, cam, cfg = _cases()["cornell"]
    whole = megakernel.trace_frames_fused(scene, cam, cfg, 32, 32, FRAMES, RVS, TBN)
    part = megakernel.trace_frames_fused(scene, cam, cfg, 32, 16, FRAMES, RVS, TBN, full_height=32, row_offset=8)
    _assert_equal(part, (t[:, 8:24] for t in whole))


def test_staged_inputs_are_checked():
    """Bad splits, keys, pools and devices raise; nothing falls back."""
    scene, cam, cfg = _cases()["cornell"]
    with pytest.raises(ValueError, match="reorder_splits"):
        megakernel.trace_frames_fused(scene, cam, cfg, 8, 8, FRAMES, RVS, TBN, reorder_splits=(0, 2))
    with pytest.raises(ValueError, match="reorder_key"):
        megakernel.trace_frames_fused(scene, cam, cfg, 8, 8, FRAMES, RVS, TBN, reorder_key="morton")
    with pytest.raises(ValueError, match="one pair per frame"):
        megakernel.trace_frames_fused(scene, cam, cfg, 8, 8, FRAMES, RVS[:1], TBN)
    with pytest.raises(ValueError, match="32-bit"):
        staged.make_pool(65536, 65536, FRAMES, RVS, "cpu")
    with pytest.raises(ValueError, match="rows"):
        megakernel.trace_frames_fused(scene, cam, cfg, 8, 8, FRAMES, RVS, TBN, full_height=8, row_offset=4)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        staged.trace_staged(scene, cam, cfg, 8, 8, FRAMES, RVS, TBN.to("meta"))


@pytest.mark.parametrize("mode", ["oct-morton", "morton-oct", "dir-morton"])
@pytest.mark.parametrize("live", [0.7, 0.0])
def test_sort_key_matches_jax(mode, live):
    """sort_key equals JAX's _sort_key on the same lanes, every mode, also
    on a pool with no live lane (the masked min and max clip)."""
    rng = np.random.default_rng(0)
    m = 4096
    ro = rng.normal(0, 30, (m, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (m, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    alive = rng.random(m) < live
    layout = _state_layout(JConfig(bounces=4), False)
    planes = np.zeros((len(layout), 1, m), np.float32)
    for i, axis in enumerate("xyz"):
        planes[layout.index(f"ro{axis}"), 0] = ro[:, i]
        planes[layout.index(f"rd{axis}"), 0] = rd[:, i]
    planes[layout.index("alive"), 0] = alive
    ref = np.asarray(_sort_key(jnp.asarray(planes), layout, mode))[0]
    packed = torch.zeros((m, staged.STATE_WORDS), dtype=torch.int32)
    packed[:, staged.RO_WORD:staged.RO_WORD + 3] = torch.as_tensor(ro).view(torch.int32)
    packed[:, staged.RD_WORD:staged.RD_WORD + 3] = torch.as_tensor(rd).view(torch.int32)
    packed[:, staged.FLAGS_WORD] = torch.as_tensor(alive.astype(np.int32))
    np.testing.assert_array_equal(staged.sort_key(packed, mode).numpy(), ref)


def test_batched_render_through_the_staged_step():
    """render(batch=3) with the staged batch step installed (one pool per
    batch) equals sample-at-a-time stepping bit for bit, as does
    render(batch=3) without one."""
    scene, cam, cfg = cornell_scene(), cornell_camera(), IntegratorConfig(bounces=2)
    renderers = [ProgressiveRenderer(scene, cfg, 24, 32, blue_noise=BN, seed=7, device="cpu") for _ in range(3)]
    renderers[2].batch_step = staged_batch_step(renderers[2])
    images = [renderers[0].render(cam, spp=7, batch=1)] + [r.render(cam, spp=7, batch=3) for r in renderers[1:]]
    for r, img in zip(renderers[1:], images[1:]):
        assert r.state.sample_counter == 7.0 and r.state.frame_counter == 7.0
        torch.testing.assert_close(r.state.accum, renderers[0].state.accum, rtol=0, atol=0)
        torch.testing.assert_close(img, images[0], rtol=0, atol=0)


@pytest.mark.parametrize("case", ["cornell", "textured"])
def test_render_avg_reorder_gradients(case):
    """render_avg(reorder=True): the same average as reorder=False bit for
    bit, and the path-replay gradients within rtol 1e-4 (the backward sums
    the pool's pixels in another order): the light color on Cornell; the
    albedo map and a sphere color on the textured blob (the shape of
    tests/test_fused_gradients.py:125)."""
    scene, cam, cfg = _cases()[case]
    w = torch.as_tensor(np.random.default_rng(2).normal(size=(32, 32, 3)).astype(np.float32))
    if case == "cornell":
        leaves = [scene.quads.color[5].clone()]

        def build(lc):
            return scene._replace(quads=scene.quads._replace(color=torch.cat([scene.quads.color[:5], lc[None]])))
    else:
        leaves = [scene.mesh.albedo.clone(), torch.tensor([1.0, 1.0, 0.0])]

        def build(albedo, sc):
            spheres = scene.spheres._replace(color=torch.cat([sc[None], scene.spheres.color[1:]]))
            return scene._replace(mesh=scene.mesh._replace(albedo=albedo), spheres=spheres)
    out = {}
    for reorder in (False, True):
        params = [t.clone().requires_grad_(True) for t in leaves]
        img = render_avg(build(*params), cam, cfg, 32, FRAMES, RV, TBN, reorder=reorder)
        out[reorder] = (img.detach(), torch.autograd.grad((w * img).mean(), params))
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        assert float(b.abs().max()) > 0
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-9)
    with pytest.raises(ValueError, match="wavefront"):
        render_avg(build(*leaves), cam, cfg, 8, FRAMES, RV, TBN, fused=False, reorder=True)


# ---- HDRI env NEE, statistically (tests/test_integrator.py:194,208), one pool of frames ----

def _env_test_scene(hdr):
    """A single diffuse floor under an HDRI: direct lighting integrable by
    quadrature over the hemisphere."""
    w = 50.0
    rows = [make_quad((0, 1, 0), (-w, 0, w), (w, 0, w), (w, 0, -w), (-w, 0, -w), (0.8, 0.6, 0.4), DIFFUSE)]
    env = Environment(sun_direction=torch.as_tensor(sun_direction_from_hdr(hdr), dtype=torch.float32),
                      sun_power=torch.tensor(4.0), hdr_image=torch.as_tensor(hdr),
                      hdr_exposure=torch.tensor(1.0), env_cdf=tuple(build_env_cdf(hdr)))
    return Scene(quads=quads_from_rows(rows), env=env)


def _spiky_hdr(h=32, w=64):
    """A near-black map with a few very bright texels in the upper
    hemisphere."""
    rng = np.random.default_rng(5)
    img = 0.002 * np.ones((h, w, 3), np.float32)
    for (y, x, v) in ((20, 10, 200.0), (24, 45, 150.0), (28, 30, 300.0)):
        img[y, x] = v
    img += 0.001 * rng.random((h, w, 3)).astype(np.float32)
    return img


def _render_frames(scene, cfg, n_frames, res=16):
    """n_frames 1-spp frames (counters 2.., the JAX test's offsets) as one
    staged pool of n_frames * res² lanes."""
    cam = Camera.look(position=(0.0, 30.0, 0.0), pitch=1.5707, fov=0.6)
    rvs = [np.array([(f * 0.173) % 1.0, (f * 0.519) % 1.0], np.float32) for f in range(n_frames)]
    pool = megakernel.trace_frames_fused(scene, cam, cfg, res, res, [float(f + 2) for f in range(n_frames)], rvs,
                                         TBN)
    return pool.color.numpy()


def _direct_truth(hdr):
    """0.5 * albedo / pi * the hemisphere quadrature of L cos(theta)."""
    th = (np.arange(64) + 0.5) / 64 * (np.pi / 2)
    ph = (np.arange(128) + 0.5) / 128 * (2 * np.pi)
    t, p = np.meshgrid(th, ph, indexing="ij")
    dirs = np.stack([np.sin(t) * np.sin(p), np.cos(t), np.sin(t) * np.cos(p)], -1).astype(np.float32)
    radiance = get_hdr_color(torch.as_tensor(hdr), torch.as_tensor(dirs.reshape(-1, 3)), 1.0).numpy()
    w_ = (np.cos(t) * np.sin(t)).reshape(-1, 1) * (np.pi / 2 / 64) * (2 * np.pi / 128)
    return 0.5 * np.array([0.8, 0.6, 0.4]) / np.pi * (radiance * w_).sum(axis=0)


def test_env_nee_unbiased_vs_quadrature():
    """Env NEE's direct lighting over 200 frames (one pool) converges to the
    quadrature truth (rtol 0.12)."""
    hdr = _spiky_hdr()
    frames = _render_frames(_env_test_scene(hdr), IntegratorConfig(bounces=2, env="hdri", nee="env"), 200)
    got = frames[:, 4:12, 4:12].mean(axis=(0, 1, 2))
    np.testing.assert_allclose(got, _direct_truth(hdr), rtol=0.12)


def test_env_nee_mse_below_sun_nee():
    """On a multi-spike map, env NEE's 64-frame MSE against the quadrature
    truth is below a quarter of sun-lobe NEE's."""
    hdr = _spiky_hdr()
    scene = _env_test_scene(hdr)
    truth = _direct_truth(hdr).sum()

    def mse(nee):
        cfg = IntegratorConfig(bounces=2, env="hdri", nee=nee, sun_weight_mode="hdri", sun_lobe_roughness=0.03)
        est = _render_frames(scene, cfg, 64).sum(axis=-1).mean(axis=0)[4:12, 4:12]
        return float(((est - truth) ** 2).mean())

    m_env, m_sun = mse("env"), mse("sun")
    assert m_env < 0.25 * m_sun, (m_env, m_sun)
