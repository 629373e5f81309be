"""The port's table caches under ``torch.inference_mode``.

Three caches key their results on the tensors they were made from and on
those tensors' in-place versions: ``geometry.triangles.cached_on`` (the
parallelogram decision and rows, the kernels' quad rows and material
columns), ``scenes.types.resident_tables`` (a mesh's kernel tables) and
``kernels.launch_args.texel_table_of`` (the texel tables).  An inference
tensor keeps no version counter and can still be edited in place inside
inference mode, so none of them may serve a result made from one twice:
here the tables are built under inference mode without raising and equal
those built outside it, a light quad moved in place inside inference mode
renders as a freshly built moved scene does (and as the JAX package renders
it, at tests/test_torch_integrator.py's bar), moved quads take the
parallelogram test of their new place, an edited map is repacked, and
outside inference mode every cache still makes each result once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.integrator.frame import trace_image as j_trace_image
from bpt_tpu.scenes.cornell import cornell_camera as j_cornell_camera
from bpt_tpu.scenes.cornell import cornell_scene as j_cornell_scene
from bpt_tpu_torch import convert
from bpt_tpu_torch.geometry import triangles
from bpt_tpu_torch.geometry.triangles import cached_on, parallelogram_constants, parallelogram_intersect
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.integrator.intersect import scene_intersect
from bpt_tpu_torch.kernels import launch_args
from bpt_tpu_torch.kernels.megakernel import trace_image_fused
from bpt_tpu_torch.scenes.gltf_scene import heightfield_model, mesh_from_model
from bpt_tpu_torch.scenes.types import MAP_FIELDS, kernel_tables_of, mesh_tables, resident_tables
from bpt_tpu_torch.textures import texel_quads
from chip_smoke import textured_stand_in
from test_torch_integrator import assert_radiance_parity

torch.set_num_threads(2)

BN = blue_noise_table()
RV = np.array([0.3, 0.7], np.float32)
SIZE = 32
LIGHT = 5  # the Cornell box's quad light, the last of its six quads
VERTICES = ("v0", "v1", "v2", "v3")


def _cornell_numpy():
    return jax.tree.map(np.asarray, j_cornell_scene()), jax.tree.map(np.asarray, j_cornell_camera())


def _light_shift(scene_np) -> np.ndarray:
    """5 units along the light quad's first edge: it stays a parallelogram
    on the ceiling's plane."""
    q = scene_np.quads
    e1 = q.v1[LIGHT] - q.v0[LIGHT]
    return (5.0 * e1 / np.linalg.norm(e1)).astype(np.float32)


def _moved(scene_np, shift: np.ndarray, rows=slice(LIGHT, LIGHT + 1)):
    """The numpy scene with the vertices of the quads ``rows`` shifted."""
    def move(v):
        v = np.array(v)
        v[rows] = v[rows] + shift
        return v

    q = scene_np.quads
    return scene_np._replace(quads=q._replace(**{n: move(getattr(q, n)) for n in VERTICES}))


def _assert_equal_results(got, ref):
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("textured", [False, True])
def test_mesh_tables_under_inference_mode(textured):
    """``mesh_tables`` and ``kernel_tables_of`` raise nothing under inference
    mode, on a mesh made outside it and on one made inside it, and equal
    the tables made outside it; tables made from inference tensors are
    never resident, tables made from normal ones stay resident."""
    model = heightfield_model(8)
    if textured:
        model = textured_stand_in(model, size=16)
    outside = mesh_tables(mesh_from_model(model))
    mesh = mesh_from_model(model)  # normal tensors
    with torch.inference_mode():
        inference_mesh = mesh_from_model(model)
        for m in (mesh, inference_mesh):
            for tables in (mesh_tables(m), kernel_tables_of(m)):
                for name in ("nodes", "tris", "normals", "uvs"):
                    a, b = getattr(tables, name), getattr(outside, name)
                    assert (a is None) == (b is None) == (name == "uvs" and not textured)
                    if a is not None:  # the records hold int32 bits: compare bits
                        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
        made_inside = mesh_tables(inference_mesh)
        assert resident_tables(inference_mesh._replace(kernel_tables=made_inside)) is None
        assert all(v is None for _, v in made_inside.source)
        kept = mesh_tables(mesh)
        assert resident_tables(mesh._replace(kernel_tables=kept)) is kept
    assert resident_tables(mesh._replace(kernel_tables=kept)) is kept
    assert resident_tables(inference_mesh._replace(kernel_tables=made_inside)) is None


@pytest.mark.parametrize("made", ["inside", "outside"])
def test_light_moved_in_place_under_inference_mode(made):
    """Cornell at 32², 4 bounces, frame 2, the kernel module's plain version
    (the parallelogram test, its rows and decision cached): render, move
    the light quad in place under inference mode, render again.  The second
    render equals that of a freshly built moved scene bit for bit, differs
    from the first, and agrees with the JAX package's render of the moved
    scene; the kernels' quad rows equal the fresh scene's.  The scene's
    tensors are inference tensors (made inside) or normal ones edited
    inside (made outside)."""
    scene_np, cam_np = _cornell_numpy()
    shift = _light_shift(scene_np)
    cfg, bn = IntegratorConfig(bounces=4), torch.as_tensor(BN)
    if made == "outside":
        scene = convert.scene_from_numpy(scene_np)
    with torch.inference_mode():
        if made == "inside":
            scene = convert.scene_from_numpy(scene_np)
        cam = convert.camera_from_numpy(cam_np)
        first = trace_image_fused(scene, cam, cfg, SIZE, SIZE, 2.0, RV, bn)
        launch_args.pack_scene(scene)
        delta = torch.as_tensor(shift)
        for name in VERTICES:
            getattr(scene.quads, name)[LIGHT].add_(delta)
        moved = trace_image_fused(scene, cam, cfg, SIZE, SIZE, 2.0, RV, bn)
        rows = launch_args.pack_scene(scene)[0]
        fresh_scene = convert.scene_from_numpy(_moved(scene_np, shift))
        fresh = trace_image_fused(fresh_scene, cam, cfg, SIZE, SIZE, 2.0, RV, bn)
        fresh_rows = launch_args.pack_scene(fresh_scene)[0]
    _assert_equal_results(moved, fresh)
    torch.testing.assert_close(rows, fresh_rows, rtol=0, atol=0)
    assert not torch.equal(first.color, moved.color)
    jscene = jax.tree.map(jnp.asarray, _moved(scene_np, shift))
    ref = j_trace_image(jscene, j_cornell_camera(), JConfig(bounces=4), SIZE, SIZE, 2.0, jnp.asarray(RV),
                        jnp.asarray(BN))
    assert_radiance_parity(moved, ref)


def test_moved_quads_take_the_parallelogram_test_of_their_new_place():
    """Every quad moved in place by +5 under inference mode:
    ``scene_intersect(..., fast_quads=True)`` returns the fans' hits on the
    moved quads (and the fresh scene's), not those of the old place."""
    scene_np, _ = _cornell_numpy()
    rng = np.random.default_rng(4)
    ro = torch.as_tensor(rng.uniform(-20, 20, (256, 3)).astype(np.float32))
    rd = torch.as_tensor(rng.normal(size=(256, 3)).astype(np.float32))
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    with torch.inference_mode():
        scene = convert.scene_from_numpy(scene_np)
        before = scene_intersect(scene, ro, rd, fast_quads=True)
        for name in VERTICES:
            getattr(scene.quads, name).add_(5.0)
        fast = scene_intersect(scene, ro, rd, fast_quads=True)
        fans = scene_intersect(scene, ro, rd, fast_quads=False)
        fresh = scene_intersect(convert.scene_from_numpy(_moved(scene_np, np.float32(5.0), slice(None))), ro, rd,
                                fast_quads=True)
    hit = torch.isfinite(fans.t)
    assert int(hit.sum()) > 100
    torch.testing.assert_close(fast.t, fans.t, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(fast.object_id, fans.object_id, rtol=0, atol=0)
    _assert_equal_results(fast, fresh)
    assert not torch.equal(before.t, fast.t)


def test_texel_table_repacked_after_an_edit_under_inference_mode():
    """A map edited in place under inference mode (the albedo halved, one
    texel of the emissive map lit): ``texel_table_of`` returns the tables of
    the edited maps, ``texel_quads`` of each."""
    model = textured_stand_in(heightfield_model(4), size=16)
    with torch.inference_mode():
        mesh = mesh_from_model(model)
        before = launch_args.texel_table_of(mesh)
        mesh.albedo.mul_(0.5)
        mesh.emissive[3, 5] = torch.tensor([1.0, 0.5, 0.25])
        after = launch_args.texel_table_of(mesh)
        for name, table in zip(MAP_FIELDS, after):
            torch.testing.assert_close(table, texel_quads(getattr(mesh, name)), rtol=0, atol=0)
    assert not torch.equal(before[0], after[0]) and not torch.equal(before[3], after[3])


def test_caches_make_once_outside_inference_mode_and_every_call_inside(monkeypatch):
    """Outside inference mode ``cached_on`` and ``texel_table_of`` make each
    result once over repeated lookups, and again after an in-place edit;
    on inference tensors they make it on every call."""
    calls = []

    def make():
        calls.append(1)
        return torch.zeros(3)

    a = torch.ones(3)
    for _ in range(4):
        cached_on((a,), "count", make)
    assert len(calls) == 1
    a.add_(1.0)
    cached_on((a,), "count", make)
    cached_on((a,), "count", make)
    assert len(calls) == 2
    with torch.inference_mode():
        b = torch.ones(3)
        for _ in range(3):
            cached_on((b,), "count", make)
    assert len(calls) == 5

    packed = []
    real = launch_args.texel_quads

    def counting(t):
        packed.append(1)
        return real(t)

    monkeypatch.setattr(launch_args, "texel_quads", counting)
    model = textured_stand_in(heightfield_model(4), size=8)
    mesh = mesh_from_model(model)
    for _ in range(3):
        launch_args.texel_table_of(mesh)
    assert len(packed) == 4  # one table per map, once
    mesh.albedo.mul_(0.5)
    launch_args.texel_table_of(mesh)
    launch_args.texel_table_of(mesh)
    assert len(packed) == 8
    with torch.inference_mode():
        inference_mesh = mesh_from_model(model)
        for _ in range(2):
            launch_args.texel_table_of(inference_mesh)
    assert len(packed) == 16


def test_rows_made_under_inference_mode_serve_autograd_outside_it():
    """Parallelogram rows looked up under inference mode for quads of normal
    tensors are inference tensors, which autograd cannot save: the lookup
    outside inference mode gets rows of its own, and a ray origin that
    requires a gradient gets it, equal to that of rows made afresh."""
    scene_np, _ = _cornell_numpy()
    quads = convert.scene_from_numpy(scene_np).quads
    with torch.inference_mode():
        inside = parallelogram_constants(quads)
    assert torch.is_inference(inside)
    rows = parallelogram_constants(quads)
    assert not torch.is_inference(rows)
    torch.testing.assert_close(rows, inside, rtol=0, atol=0)
    ro = torch.tensor([[0.0, 0.0, -30.0]], requires_grad=True)
    rd = torch.tensor([[0.05, 0.1, 1.0]])
    t = parallelogram_intersect(rows, ro[:, None, :], rd[:, None, :]).amin(-1)
    (g,) = torch.autograd.grad(t.sum(), ro)
    ro2 = ro.detach().clone().requires_grad_(True)
    fresh = triangles._parallelogram_rows(quads.v0, quads.v1, quads.v3)
    t2 = parallelogram_intersect(fresh, ro2[:, None, :], rd[:, None, :]).amin(-1)
    (g2,) = torch.autograd.grad(t2.sum(), ro2)
    assert bool(torch.isfinite(t).all())
    torch.testing.assert_close(g, g2, rtol=0, atol=0)
