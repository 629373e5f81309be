"""The port's path-replay gradient and inverse-rendering loop against the
JAX package, on the CPU.

Cornell box with the TRANSPARENT right sphere, 32x32, 4 bounces, frame 2,
loss mean(color * [1, 2, 3]); gradients with respect to the light (quad 5),
a wall (quad 2) and the glass sphere (sphere 1).  On CPU tensors
``trace_image_fused(differentiable=True)`` runs the plain version of the
CUDA kernel's grads mode inside the same ``torch.autograd.Function`` the
card uses, so these tests hold its backward (the port of ``_prb_fn``'s
``f_bwd``) to JAX.  Each tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.diff.inverse import optimize as j_optimize
from bpt_tpu.diff.inverse import render_avg as j_render_avg
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.integrator.frame import trace_image as j_trace_image
from bpt_tpu.kernels import megakernel as jmk
from bpt_tpu.scenes.cornell import cornell_camera as j_cornell_camera
from bpt_tpu.scenes.cornell import cornell_scene as j_cornell_scene
from bpt_tpu_torch import convert
from bpt_tpu_torch.diff import finite_difference, make_render_loss, optimize, render_avg, value_and_param_grads
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.integrator.frame import trace_image
from bpt_tpu_torch.kernels import megakernel
from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
from bpt_tpu_torch.scenes.types import TRANSPARENT

torch.set_num_threads(2)

RES = 32
BOUNCES = 4
BN = blue_noise_table()
RV = np.array([0.3, 0.7], np.float32)
WVEC = np.array([1.0, 2.0, 3.0], np.float32)
# light emission, wall 2 (right, blue) and glass sphere colors
LC = np.array([10.0, 10.0, 10.0], np.float32)
WC = np.array([0.05, 0.05, 0.7], np.float32)
SC = np.array([0.4, 0.9, 0.6], np.float32)


def _jax_inputs():
    return j_cornell_scene(right_sphere_mat=TRANSPARENT), j_cornell_camera()


def _port_inputs():
    jscene, jcam = _jax_inputs()
    return (convert.scene_from_numpy(jax.tree.map(np.asarray, jscene)),
            convert.camera_from_numpy(jax.tree.map(np.asarray, jcam)))


def _jax_grads(tint):
    jscene, jcam = _jax_inputs()
    cfg = JConfig(bounces=BOUNCES, transparent_tint=tint)

    def loss(lc, wc, sc):
        quads = jscene.quads._replace(color=jscene.quads.color.at[5].set(lc).at[2].set(wc))
        spheres = jscene.spheres._replace(color=jscene.spheres.color.at[1].set(sc))
        r = j_trace_image(jscene._replace(quads=quads, spheres=spheres), jcam, cfg, RES, RES, 2.0,
                          jnp.asarray(RV), jnp.asarray(BN))
        return jnp.mean(r.color * jnp.asarray(WVEC))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (LC, WC, SC)))]


def _port_loss(tint, trace):
    """loss(lc, wc, sc) through ``trace`` (a trace_image-like callable)."""
    scene, cam = _port_inputs()
    cfg = IntegratorConfig(bounces=BOUNCES, transparent_tint=tint)
    bn = torch.as_tensor(BN)

    def loss(lc, wc, sc):
        qc = torch.stack([lc if i == 5 else wc if i == 2 else scene.quads.color[i] for i in range(6)])
        s = scene._replace(quads=scene.quads._replace(color=qc),
                           spheres=scene.spheres._replace(color=torch.stack([scene.spheres.color[0], sc])))
        return torch.mean(trace(s, cam, cfg, RES, RES, 2.0, RV, bn).color * torch.as_tensor(WVEC))

    return loss


def _fused(*args):
    return megakernel.trace_image_fused(*args, differentiable=True)


def _port_grads(tint, trace):
    leaves = [torch.tensor(v, requires_grad=True) for v in (LC, WC, SC)]
    return [g.numpy() for g in torch.autograd.grad(_port_loss(tint, trace)(*leaves), leaves)]


def test_sg_planes_match_pallas_param_grads():
    """(a) The plain version's path-replay planes against the TPU kernel's
    param_grads output, run in interpret mode as trace_image_pallas reaches
    it (tint off: 8 count planes + 8 Beer planes).  Counts exact; Beer sums
    within rtol 3e-5: the Pallas kernel computes the sphere exit distance t
    with another association than the wavefront (measured max 1.03e-5)."""
    jscene, jcam = _jax_inputs()
    jcfg = JConfig(bounces=BOUNCES)
    packs, cam, scalars, _ = jmk._setup_inputs(jscene, jcam, jcfg, RES, RES, 2.0)
    bn_planes = jmk._blue_noise_planes(jnp.asarray(BN), RES, RES, jnp.asarray(RV))
    outs = jmk._pallas_forward(packs, cam, scalars, bn_planes, jcfg, RES, RES, RES, RES, True, param_grads=True,
                               fast_quads=jmk._all_parallelograms(jscene.quads))
    ref = np.asarray(outs[-1])
    scene, tcam = _port_inputs()
    _, sg, _ = trace_image(scene, tcam, IntegratorConfig(bounces=BOUNCES), RES, RES, 2.0, RV, torch.as_tensor(BN),
                           param_grads=True)
    sg = sg.numpy()
    n_obj = 8
    assert sg.shape == ref.shape == (2 * n_obj, RES, RES)
    np.testing.assert_array_equal(sg[:n_obj], ref[:n_obj])
    np.testing.assert_allclose(sg[n_obj:], ref[n_obj:], rtol=3e-5, atol=0)
    assert sg[n_obj + 1].sum() > 0  # the glass sphere's Beer plane is exercised


@pytest.mark.parametrize("tint", [False, True])
def test_fused_gradient_matches_jax_wavefront_grad(tint):
    """(b) trace_image_fused(differentiable=True) on the CPU against
    jax.grad through the JAX wavefront, rtol 1e-4 (measured ~1e-6)."""
    want = _jax_grads(tint)
    got = _port_grads(tint, _fused)
    for g, w, name in zip(got, want, ("light", "wall", "sphere")):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-9, err_msg=name)
    assert np.abs(got[2]).min() > 0  # the glass sphere's gradient is not 0


@pytest.mark.parametrize("tint", [False, True])
def test_fused_gradient_matches_port_autograd(tint):
    """(c) The path-replay gradient against torch.autograd through the
    port's own plain trace_image, rtol 1e-4 (measured ~2e-7)."""
    got = _port_grads(tint, _fused)
    want = _port_grads(tint, trace_image)
    for g, w, name in zip(got, want, ("light", "wall", "sphere")):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("tint", [False, True])
def test_fused_gradient_matches_finite_differences(tint):
    """(d) Central differences of the port's forward (h = 1e-2; matched RNG,
    so noise-free), rtol 2e-2 as tests/test_kernels.py holds the TPU
    kernel: light (linear), a wall channel and the glass sphere (Beer)."""
    got = _port_grads(tint, _fused)
    params = {"lc": torch.as_tensor(LC), "wc": torch.as_tensor(WC), "sc": torch.as_tensor(SC)}
    loss = _port_loss(tint, megakernel.trace_image_fused)
    fd = finite_difference(lambda p: loss(p["lc"], p["wc"], p["sc"]), params, eps=1e-2)
    for g, name, ch in zip(got, ("lc", "wc", "sc"), (0, 1, 0)):
        np.testing.assert_allclose(g[ch], fd[name][ch].item(), rtol=2e-2, atol=1e-7, err_msg=name)


def test_differentiable_without_grad_is_the_forward():
    """With nothing requiring a gradient the differentiable call is the plain
    forward (JAX's custom_vjp runs its primal), and the grads mode's 11
    planes equal the forward's; so is the staged pool of one frame
    (reorder=True).  The plain forward takes the kernel's quad test
    (``fast_quads=None``: the parallelogram test on the Cornell box)."""
    scene, cam = _port_inputs()
    cfg, bn = IntegratorConfig(bounces=BOUNCES), torch.as_tensor(BN)
    plain = trace_image(scene, cam, cfg, RES, RES, 2.0, RV, bn, fast_quads=None)
    fused = megakernel.trace_image_fused(scene, cam, cfg, RES, RES, 2.0, RV, bn, differentiable=True)
    result, sg, deferred = megakernel.trace_image_fused_grads(scene, cam, cfg, RES, RES, 2.0, RV, bn)
    for a, b, c in zip(plain, fused, result):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert not fused.color.requires_grad and sg.shape == (16, RES, RES) and deferred.shape == (0, RES, RES)
    staged = megakernel.trace_image_fused(scene, cam, cfg, RES, RES, 2.0, RV, bn, differentiable=True, reorder=True)
    for a, b in zip(plain, staged):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_object_color_gradient_is_the_first_hit_one_hot():
    """The backward's one-hot term: d sum(object_color) / d color[j] is the
    number of pixels whose first hit is object j, in every channel."""
    scene, cam = _port_inputs()
    qc = scene.quads.color.clone().requires_grad_(True)
    sc = scene.spheres.color.clone().requires_grad_(True)
    s = scene._replace(quads=scene.quads._replace(color=qc), spheres=scene.spheres._replace(color=sc))
    r = megakernel.trace_image_fused(s, cam, IntegratorConfig(bounces=BOUNCES), RES, RES, 2.0, RV,
                                     torch.as_tensor(BN), differentiable=True)
    g_q, g_s = torch.autograd.grad(r.object_color.sum(), [qc, sc])
    ids = r.object_id.detach()
    want = torch.stack([(ids == j).sum().float() for j in range(8)])[:, None].expand(8, 3)
    torch.testing.assert_close(torch.cat([g_s, g_q]), want, rtol=0, atol=0)


def _emission_problem(bounces):
    """The problem of tests/test_inverse.py: recover the ceiling light's
    emission (quad 5, grey) from a target rendered at 10."""
    cfg = IntegratorConfig(bounces=bounces)
    base, camera = cornell_scene(device="cpu"), cornell_camera(device="cpu")

    def build(params):
        color = torch.cat([base.quads.color[:5], (params["emission"] * torch.ones(3))[None]])
        return base._replace(quads=base.quads._replace(color=color)), camera

    target_scene, _ = build({"emission": torch.tensor(10.0)})
    target = render_avg(target_scene, camera, cfg, RES, (1.0, 2.0), RV, BN)
    return cfg, build, target


def test_recover_light_emission():
    """(e) The port of tests/test_inverse.py::test_recover_light_emission
    (3 bounces, 30 steps, lr 0.5) on the CPU, through the fused route."""
    cfg, build, target = _emission_problem(3)
    result = optimize(build, {"emission": 4.0}, target, cfg, RES, steps=30, lr=0.5, device="cpu")
    losses = result.losses.numpy()
    assert losses.shape == (30,)
    assert losses[-1] < losses[0] * 0.05, f"loss {losses[0]:.4f} -> {losses[-1]:.4f}"
    recovered = float(result.params["emission"])
    assert abs(recovered - 10.0) < 1.0, f"emission {recovered} != 10.0"


@pytest.fixture(scope="module")
def jax_five_steps():
    """JAX's optimize over 5 steps of the emission problem (3 bounces)."""
    cfg = JConfig(bounces=3)
    camera, base = j_cornell_camera(), j_cornell_scene()

    def build(params):
        quads = base.quads._replace(color=base.quads.color.at[5].set(params["emission"] * jnp.ones(3)))
        return base._replace(quads=quads), camera

    target_scene, _ = build({"emission": jnp.asarray(10.0)})
    target = j_render_avg(target_scene, camera, cfg, RES, (1.0, 2.0), jnp.asarray(RV), jnp.asarray(BN))
    result = j_optimize(build, {"emission": jnp.asarray(4.0)}, target, cfg, RES, steps=5, lr=0.5)
    return np.asarray(target), float(result.params["emission"]), np.asarray(result.losses)


@pytest.mark.parametrize("fused", [True, False])
def test_optimize_matches_jax(jax_five_steps, fused):
    """(f) 5 Adam steps against JAX's optimize (optax.adam) on the same
    problem: the target by the integrator parity bar (rtol 1e-4 / atol 1e-5
    per value; measured 2 of 3072 values above 1e-5 relative), the parameter
    within rtol 1e-4 and the losses within rtol 1e-3, through the fused
    route and the wavefront."""
    j_target, j_emission, j_losses = jax_five_steps
    cfg, build, target = _emission_problem(3)
    np.testing.assert_allclose(target.numpy(), j_target, rtol=1e-4, atol=1e-5)
    result = optimize(build, {"emission": np.float32(4.0)}, target, cfg, RES, steps=5, lr=0.5, fused=fused,
                      device="cpu")
    np.testing.assert_allclose(float(result.params["emission"]), j_emission, rtol=1e-4)
    np.testing.assert_allclose(result.losses.numpy(), j_losses, rtol=1e-3)


def test_param_clip_and_reorder():
    """param_clip is applied after every step; reorder=True (the staged pool
    of the frames) takes the same steps, up to the order of the backward's
    sums."""
    cfg, build, target = _emission_problem(2)
    result = optimize(build, {"emission": 4.0}, target, cfg, RES, steps=3, lr=0.5, device="cpu",
                      param_clip=lambda p: {"emission": torch.clamp(p["emission"], max=4.2)})
    assert float(result.params["emission"]) == pytest.approx(4.2)
    staged = optimize(build, {"emission": 4.0}, target, cfg, RES, steps=3, lr=0.5, device="cpu",
                      param_clip=lambda p: {"emission": torch.clamp(p["emission"], max=4.2)}, reorder=True)
    assert float(staged.params["emission"]) == pytest.approx(4.2)
    torch.testing.assert_close(staged.losses, result.losses, rtol=1e-5, atol=0)


@pytest.mark.parametrize("where", ["quad_vertex", "sphere_matrix", "camera_position"])
def test_fused_route_refuses_geometry_and_camera_gradients(where):
    """A parameter that reaches only the geometry or the camera would get no
    gradient through the path-replay VJP: the fused route raises and names
    the wavefront route, which (fused=False) moves the parameter."""
    scene, cam = _port_inputs()

    def build(p):
        if where == "quad_vertex":
            return scene._replace(quads=scene.quads._replace(v0=scene.quads.v0 + p["x"])), cam
        if where == "sphere_matrix":
            inv = scene.spheres.inv_matrix * (1 + p["x"])
            return scene._replace(spheres=scene.spheres._replace(inv_matrix=inv)), cam
        return scene, cam._replace(position=cam.position + p["x"])

    cfg, target = IntegratorConfig(bounces=2), torch.zeros(RES, RES, 3)
    with pytest.raises(NotImplementedError, match="fused=False"):
        optimize(build, {"x": 0.0}, target, cfg, RES, steps=1, device="cpu")
    result = optimize(build, {"x": 0.0}, target, cfg, RES, steps=1, fused=False, device="cpu")
    assert float(result.params["x"]) != 0.0


def test_make_render_loss_grads_match_finite_differences():
    """make_render_loss + value_and_param_grads (the wavefront route) against
    finite_difference on the same loss (h = 1e-2, rtol 2e-2), and against
    the fused route's gradient (rtol 1e-4); a parameter the loss does not
    reach gets a zero gradient."""
    scene, cam = _port_inputs()

    def build(p):
        color = torch.cat([scene.quads.color[:2], p["wall"][None], scene.quads.color[3:5],
                           (p["emission"] * torch.ones(3))[None]])
        return scene._replace(quads=scene.quads._replace(color=color)), cam

    params = {"emission": torch.tensor(10.0), "wall": torch.as_tensor(WC), "unused": torch.tensor(1.0)}
    loss = make_render_loss(build, IntegratorConfig(bounces=3), RES, RES, frames=(1.0, 2.0), blue_noise=BN)
    value, grads = value_and_param_grads(loss, params)
    fd = finite_difference(loss, params, eps=1e-2)
    for name in ("emission", "wall"):
        np.testing.assert_allclose(grads[name].numpy(), fd[name].numpy(), rtol=2e-2, atol=1e-7, err_msg=name)
    assert grads["unused"].item() == 0.0
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items() if k != "unused"}
    s, c = build(leaves)
    img = render_avg(s, c, IntegratorConfig(bounces=3), RES, (1.0, 2.0), (0.3, 0.7), BN)
    fused = torch.autograd.grad(img.mean(), list(leaves.values()))
    np.testing.assert_allclose(img.mean().item(), value.item(), rtol=1e-6)
    for g, name in zip(fused, leaves):
        np.testing.assert_allclose(g.numpy(), grads[name].numpy(), rtol=1e-4, atol=1e-9, err_msg=name)


def test_params_from_numpy_round_trips():
    """(g) The JAX parameter dict -> the port's leaf tensors -> numpy, exact."""
    params = {"emission": jnp.asarray(4.0), "albedo": jnp.asarray([0.2, 0.5, 0.8]),
              "tex": jnp.asarray(np.random.default_rng(0).random((4, 4, 3)), jnp.float32)}
    params_np = jax.tree.map(np.asarray, params)
    leaves = convert.params_from_numpy(params_np, "cpu")
    for name, v in leaves.items():
        assert v.is_leaf and v.requires_grad and v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.detach().numpy(), params_np[name])
    back = jax.tree.map(jnp.asarray, {k: v.detach().numpy() for k, v in leaves.items()})
    for name in params:
        np.testing.assert_array_equal(np.asarray(back[name]), np.asarray(params[name]))
    assert not any(v.requires_grad for v in convert.params_from_numpy(params_np, requires_grad=False).values())


# ---- the quadric family: the path-replay gradient of a quadric color ------

QRES = 32
QBOUNCES = 3
QI = 11  # the torus: the front row, seen through by the transparent variant
QC = np.array([0.8, 0.6, 0.4], np.float32)  # the color given to quadric QI


def _quadric_inputs(mat):
    from bpt_tpu.scenes.quadric_geometry import quadric_camera, quadric_geometry_scene

    jscene, jcam = quadric_geometry_scene(all_shapes_mat=mat), quadric_camera()
    return (jscene, jcam), (convert.scene_from_numpy(jax.tree.map(np.asarray, jscene)),
                            convert.camera_from_numpy(jax.tree.map(np.asarray, jcam)))


def _quadric_port_grads(mat, trace, **kw):
    """d mean(color * [1, 2, 3]) / d (quadric QI's color, the light's color)."""
    _, (scene, cam) = _quadric_inputs(mat)
    qc, lc = torch.tensor(QC, requires_grad=True), torch.tensor(LC, requires_grad=True)
    colors = torch.cat([scene.quadrics.color[:QI], qc[None], scene.quadrics.color[QI + 1:]])
    s = scene._replace(quadrics=scene.quadrics._replace(color=colors),
                       quads=scene.quads._replace(color=torch.cat([scene.quads.color[:5], lc[None]])))
    cfg = IntegratorConfig(bounces=QBOUNCES, transparent_tint=True)
    loss = torch.mean(trace(s, cam, cfg, QRES, QRES, 2.0, RV, torch.as_tensor(BN), **kw).color
                      * torch.as_tensor(WVEC))
    return [g.numpy() for g in torch.autograd.grad(loss, [qc, lc])]


@pytest.mark.parametrize("mat", [4, TRANSPARENT])
def test_quadric_color_gradient_matches_port_autograd(mat):
    """The path-replay gradient of a quadric color (tint on, so a
    transparent shape counts its refractions linearly) and of the light,
    against autograd through the port's plain trace_image, rtol 1e-4."""
    got = _quadric_port_grads(mat, megakernel.trace_image_fused, differentiable=True)
    want = _quadric_port_grads(mat, trace_image)
    for g, w, name in zip(got, want, ("quadric", "light")):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-9, err_msg=name)
    assert np.abs(got[0]).min() > 0


@pytest.mark.parametrize("mat", [4, TRANSPARENT])
def test_quadric_color_gradient_matches_jax_grad(mat):
    """The same gradient against jax.grad through the JAX wavefront at 32x32,
    rtol 1e-4."""
    (jscene, jcam), _ = _quadric_inputs(mat)
    cfg = JConfig(bounces=QBOUNCES, transparent_tint=True)

    def loss(qc, lc):
        quadrics = jscene.quadrics._replace(color=jscene.quadrics.color.at[QI].set(qc))
        quads = jscene.quads._replace(color=jscene.quads.color.at[5].set(lc))
        r = j_trace_image(jscene._replace(quadrics=quadrics, quads=quads), jcam, cfg, QRES, QRES, 2.0,
                          jnp.asarray(RV), jnp.asarray(BN))
        return jnp.mean(r.color * jnp.asarray(WVEC))

    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(QC), jnp.asarray(LC))]
    got = _quadric_port_grads(mat, megakernel.trace_image_fused, differentiable=True)
    for g, w, name in zip(got, want, ("quadric", "light")):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-9, err_msg=name)


def test_optimize_quadric_color_matches_jax():
    """optimize(fused=True) on the quadric scene's shared shape color (one
    grey level for all 12 shapes, target 0.8, start 0.3, 5 Adam steps of lr
    0.05) against JAX's optimize (optax.adam): the parameter within rtol
    1e-4 and the losses within rtol 1e-3, the bars of the Cornell case
    above.  16x16, 2 bounces, one frame per step: JAX's optimize jits the
    whole step, and its compile of the quadric wavefront's gradient takes
    ~45 s at this size on this CPU (~500 s at 32x32, 3 bounces, 2 frames)."""
    from bpt_tpu.scenes.quadric_geometry import quadric_camera as j_qcam
    from bpt_tpu.scenes.quadric_geometry import quadric_geometry_scene as j_qscene
    from bpt_tpu_torch.scenes.quadric_geometry import quadric_camera, quadric_geometry_scene

    size, frames = 16, (1.0,)
    jcfg, cfg = JConfig(bounces=2, transparent_tint=True), IntegratorConfig(bounces=2, transparent_tint=True)
    jbase, jcam = j_qscene(), j_qcam()

    def jbuild(p):
        return jbase._replace(quadrics=jbase.quadrics._replace(color=p["grey"] * jnp.ones((12, 3)))), jcam

    jtarget = j_render_avg(jbuild({"grey": jnp.asarray(0.8)})[0], jcam, jcfg, size, frames, jnp.asarray(RV),
                           jnp.asarray(BN))
    jres = j_optimize(jbuild, {"grey": jnp.asarray(0.3)}, jtarget, jcfg, size, steps=5, lr=0.05, frames=frames)

    base, cam = quadric_geometry_scene(device="cpu"), quadric_camera(device="cpu")

    def build(p):
        return base._replace(quadrics=base.quadrics._replace(color=p["grey"] * torch.ones(12, 3))), cam

    target = render_avg(build({"grey": torch.tensor(0.8)})[0], cam, cfg, size, frames, RV, BN)
    np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), rtol=1e-4, atol=1e-5)
    res = optimize(build, {"grey": np.float32(0.3)}, target, cfg, size, steps=5, lr=0.05, frames=frames,
                   device="cpu")
    np.testing.assert_allclose(float(res.params["grey"]), float(jres.params["grey"]), rtol=1e-4)
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(jres.losses), rtol=1e-3)
    assert res.losses[-1] < res.losses[0]
