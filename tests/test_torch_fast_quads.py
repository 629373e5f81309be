"""The parallelogram quad test (JAX's ``fast_quads``) in the port, on the CPU.

The port's plain render with the parallelogram test against the TPU
kernel run with ``fast_quads=True`` in interpret mode (Cornell, sky and
quadric scenes, 16x16; the Cornell box and the sky at 2 bounces, the
quadric scene at 1: JAX's interpret-mode compile of its kernel takes about
20 s at 1 bounce and 70 s at 2 on one CPU core); the test itself against
the two triangle fans on seeded random rays; the per-quad constants of the pack
against JAX's expressions evaluated in numpy float32; and the decision (a
skewed quad takes the fans, ``fast_quads=True`` on it raises ValueError,
made once per quad geometry).  Each tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.kernels import megakernel as jmk
from bpt_tpu.scenes.cornell import cornell_camera as j_cornell_camera
from bpt_tpu.scenes.cornell import cornell_scene as j_cornell_scene
from bpt_tpu.scenes.quadric_geometry import quadric_camera as j_quadric_camera
from bpt_tpu.scenes.quadric_geometry import quadric_geometry_scene as j_quadric_scene
from bpt_tpu.scenes.sky_scene import physical_sky_scene as j_sky_scene
from bpt_tpu.scenes.sky_scene import sky_camera as j_sky_camera
from bpt_tpu_torch import convert
from bpt_tpu_torch.geometry import triangles
from bpt_tpu_torch.geometry.triangles import (PARALLELOGRAM_COLUMNS, all_parallelograms, parallelogram_constants,
                                              resolve_fast_quads)
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.integrator.frame import trace_image
from bpt_tpu_torch.integrator.intersect import _empty_hit, _intersect_quads
from bpt_tpu_torch.kernels import megakernel
from bpt_tpu_torch.kernels.launch_args import pack_scene
from bpt_tpu_torch.scenes.types import TRANSPARENT

torch.set_num_threads(2)

RES = 16
BOUNCES = 2
BN = blue_noise_table()
RV = np.array([0.3, 0.7], np.float32)


def _convert(jscene, jcam):
    return (convert.scene_from_numpy(jax.tree.map(np.asarray, jscene)),
            convert.camera_from_numpy(jax.tree.map(np.asarray, jcam)))


SCENES = {
    "cornell": (lambda: (j_cornell_scene(right_sphere_mat=TRANSPARENT), j_cornell_camera()),
                dict(bounces=BOUNCES)),
    "sky": (lambda: (j_sky_scene(right_sphere_mat=TRANSPARENT), j_sky_camera()),
            dict(bounces=BOUNCES, env="sky", nee="sun")),
    "quadric": (lambda: (j_quadric_scene(shape_k=0.35), j_quadric_camera()),
                dict(bounces=1, transparent_tint=True)),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_parallelogram_render_matches_pallas_fast_quads(name):
    """``trace_image(..., fast_quads=True, plain_walk=True, param_grads=True)``
    against the TPU kernel's ``_pallas_forward(..., param_grads=True,
    fast_quads=True)`` in interpret mode, 16x16, frame 2.

    Path-replay planes: the counts exact, the Beer-Lambert sums (tint off)
    within rtol 3e-5 (the Pallas kernel computes a sphere's exit distance
    with another association, as in test_torch_gradients.py).  First-hit
    ids and colors exact, normals within rtol 1e-3 / atol 1e-4, >= 99% of
    sharpness flags equal; colors by each family's bar of
    test_torch_integrator.py: >= 99.5% of pixels within rtol 1e-4 / atol
    1e-5 (sky: rtol 1e-3 / atol 1e-4); the quadric scene by
    assert_quadric_parity's bar instead of the normals (the torus normal
    is a float32 finite difference): fewer than 2% of pixels off by more
    than 1e-3, the 95th percentile below 1e-3.  The plain run's lane counts
    show the parallelogram test ran on every live lane of every bounce."""
    make, kw = SCENES[name]
    jscene, jcam = make()
    assert jmk._all_parallelograms(jscene.quads)
    jcfg = JConfig(**kw)
    packs, cam, scalars, _ = jmk._setup_inputs(jscene, jcam, jcfg, RES, RES, 2.0)
    bn_planes = jmk._blue_noise_planes(jnp.asarray(BN), RES, RES, jnp.asarray(RV))
    outs = jmk._pallas_forward(packs, cam, scalars, bn_planes, jcfg, RES, RES, RES, RES, True, param_grads=True,
                               fast_quads=True)
    ref = jmk._compose_result(outs[:-1], jscene, jcfg, False)
    ref_sg = np.asarray(outs[-1])

    scene, tcam = _convert(jscene, jcam)
    lanes = []
    got, sg, _ = trace_image(scene, tcam, IntegratorConfig(**kw), RES, RES, 2.0, RV, torch.as_tensor(BN),
                             param_grads=True, lane_counts=lanes, plain_walk=True, fast_quads=True)
    n_q = scene.quads.v0.shape[0]
    assert [int(c.parallelogram_tests) for c in lanes] == [int(c.live) * n_q for c in lanes]
    assert int(lanes[0].live) == RES * RES

    sg = sg.numpy()
    n_obj = sum(g.color.shape[0] for g in (scene.quads, scene.spheres, scene.quadrics) if g is not None)
    assert sg.shape == ref_sg.shape
    np.testing.assert_array_equal(sg[:n_obj], ref_sg[:n_obj])
    np.testing.assert_allclose(sg[n_obj:], ref_sg[n_obj:], rtol=3e-5, atol=0)
    assert sg[:n_obj].sum() > 0

    a, b = got.color.numpy(), np.asarray(ref.color)
    rtol, atol = (1e-3, 1e-4) if name == "sky" else (1e-4, 1e-5)
    close = np.isclose(a, b, rtol=rtol, atol=atol).all(axis=-1)
    assert close.mean() > 0.995, f"{name} color parity {close.mean():.4f}"
    np.testing.assert_array_equal(got.object_id.numpy(), np.asarray(ref.object_id))
    np.testing.assert_array_equal(got.object_color.numpy(), np.asarray(ref.object_color))
    if name == "quadric":  # the bar of test_torch_integrator.py's assert_quadric_parity
        d = np.abs(a - b).max(-1)
        assert (d > 1e-3).mean() < 0.02 and np.quantile(d, 0.95) < 1e-3
    else:
        np.testing.assert_allclose(got.object_normal.numpy(), np.asarray(ref.object_normal), rtol=1e-3, atol=1e-4)
    assert (got.pixel_sharpness.numpy() == np.asarray(ref.pixel_sharpness)).mean() > 0.99


def _random_quads(rng, n):
    """n seeded parallelograms, skewed (e1 and e3 not orthogonal), each a
    random size and orientation inside the Cornell box's extent."""
    v0 = rng.uniform(-40, 40, (n, 3))
    e1 = rng.normal(size=(n, 3)) * rng.uniform(5, 40, (n, 1))
    e3 = rng.normal(size=(n, 3)) * rng.uniform(5, 40, (n, 1))
    return v0, v0 + e1, v0 + e1 + e3, v0 + e3


def _edge_distance(v0, v1, v3, ro, rd):
    """float64: for every (ray, quad) the distance from the plane hit point
    to the nearest of the parallelogram's four edge lines (inf without a
    plane hit in front of the ray)."""
    e1, e3 = v1 - v0, v3 - v0
    n = np.cross(e1, e3)
    denom = rd @ n.T
    t = ((v0 * n).sum(-1)[None] - ro @ n.T) / np.where(denom == 0, 1e-300, denom)
    p = ro[:, None] + rd[:, None] * t[..., None]
    dist = np.full(t.shape, np.inf)
    for a, e in ((v0, e1), (v0, e3), (v0 + e3, e1), (v0 + e1, e3)):
        d = np.linalg.norm(np.cross(p - a[None], e[None]), axis=-1) / np.linalg.norm(e, axis=-1)[None]
        dist = np.minimum(dist, d)
    return np.where(t > 0, dist, np.inf)


def test_parallelogram_test_matches_the_fans_on_random_rays():
    """The parallelogram test against the two triangle fans
    (``_intersect_quads`` both ways) on 4096 seeded rays against the Cornell
    box's 6 quads and 10 skewed random parallelograms: the winning quad
    equal on every lane but those whose hit point on some quad's plane lies
    within 1e-4 of that quad's edge, and t within rtol 1e-5 where both hit
    (the two compute the same plane distance with other roundings)."""
    rng = np.random.default_rng(7)
    scene, _ = _convert(j_cornell_scene(), j_cornell_camera())
    rv = _random_quads(rng, 10)
    q = scene.quads
    quads = q._replace(**{k: torch.cat([getattr(q, k), torch.as_tensor(v, dtype=torch.float32)])
                          for k, v in zip(("v0", "v1", "v2", "v3"), rv)},
                       normal=torch.cat([q.normal, torch.as_tensor(np.cross(rv[1] - rv[0], rv[3] - rv[0]),
                                                                   dtype=torch.float32)]),
                       color=torch.cat([q.color, torch.ones(10, 3)]),
                       mat_type=torch.cat([q.mat_type, torch.ones(10, dtype=q.mat_type.dtype)]))
    assert all_parallelograms(quads)
    n = 4096
    ro = rng.uniform(-45, 45, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    tro, trd = torch.as_tensor(ro), torch.as_tensor(rd)
    tests = []
    fast = _intersect_quads(quads, tro, trd, _empty_hit((n,), "cpu"), 0, fast_quads=True, quad_tests=tests)
    fans = _intersect_quads(quads, tro, trd, _empty_hit((n,), "cpu"), 0, quad_tests=tests)
    assert tests == ["parallelogram", "fans"]

    v = [t.double().numpy() for t in (quads.v0, quads.v1, quads.v3)]
    near_edge = (_edge_distance(*v, ro.astype(np.float64), rd.astype(np.float64)) < 1e-4).any(-1)
    differ = fast.object_id.numpy() != fans.object_id.numpy()
    assert not (differ & ~near_edge).any()
    hit = (fast.t.numpy() < 1e6) & (fans.t.numpy() < 1e6)
    assert hit.sum() > n // 2
    np.testing.assert_allclose(fast.t.numpy()[hit], fans.t.numpy()[hit], rtol=1e-5, atol=1e-5)


def test_parallelogram_constants_match_jax_expressions():
    """The per-quad algebra (ng, c0, d1, k1, d3, k3, v0) and its place in
    the kernel's quad rows against the expressions of the TPU kernel's fast
    path (bpt_tpu/kernels/megakernel.py, fast_quads) evaluated in numpy
    float32, bit for bit: each is one IEEE operation at a time on both
    sides (test_torch_scene.py holds the rest of the row to the TPU
    pack)."""
    scene, _ = _convert(j_cornell_scene(), j_cornell_camera())
    rng = np.random.default_rng(3)
    rv = [x.astype(np.float32) for x in _random_quads(rng, 5)]
    q = scene.quads
    quads = q._replace(**{k: torch.cat([getattr(q, k), torch.as_tensor(v)])
                          for k, v in zip(("v0", "v1", "v2", "v3"), rv)},
                       normal=torch.cat([q.normal, torch.ones(5, 3)]), color=torch.cat([q.color, torch.ones(5, 3)]),
                       mat_type=torch.cat([q.mat_type, torch.ones(5, dtype=q.mat_type.dtype)]))
    v0, v1, v3 = (getattr(quads, k).numpy() for k in ("v0", "v1", "v3"))
    e1x, e1y, e1z = (v1[:, i] - v0[:, i] for i in range(3))
    e3x, e3y, e3z = (v3[:, i] - v0[:, i] for i in range(3))
    ngx, ngy, ngz = e1y * e3z - e1z * e3y, e1z * e3x - e1x * e3z, e1x * e3y - e1y * e3x
    d1x, d1y, d1z = e3y * ngz - e3z * ngy, e3z * ngx - e3x * ngz, e3x * ngy - e3y * ngx
    d3x, d3y, d3z = ngy * e1z - ngz * e1y, ngz * e1x - ngx * e1z, ngx * e1y - ngy * e1x
    den1 = e1x * d1x + e1y * d1y + e1z * d1z
    den3 = e3x * d3x + e3y * d3y + e3z * d3z
    one = np.float32(1.0)
    k1 = one / np.where(np.abs(den1) > 1e-20, den1, one)
    k3 = one / np.where(np.abs(den3) > 1e-20, den3, one)
    c0 = v0[:, 0] * ngx + v0[:, 1] * ngy + v0[:, 2] * ngz
    want = np.stack([ngx, ngy, ngz, c0, d1x, d1y, d1z, k1, d3x, d3y, d3z, k3, v0[:, 0], v0[:, 1], v0[:, 2]], 1)
    assert want.dtype == np.float32
    rows = parallelogram_constants(quads)
    np.testing.assert_array_equal(rows.numpy(), want)
    assert list(PARALLELOGRAM_COLUMNS.values()) == [0, 3, 4, 7, 8, 11, 12]

    packed = pack_scene(scene._replace(quads=quads))[0].numpy()
    assert packed.shape == (11, 32)
    np.testing.assert_array_equal(packed[:, :15], want)


def _skewed_cornell():
    """The Cornell box with its first quad sheared into a trapezoid: v2
    moved along x, so v2 - v1 != v3 - v0."""
    scene, cam = _convert(j_cornell_scene(), j_cornell_camera())
    v2 = scene.quads.v2.clone()
    v2[0] = v2[0] + torch.tensor([5.0, 0.0, 0.0])
    return scene._replace(quads=scene.quads._replace(v2=v2)), cam


def test_skewed_quad_takes_the_fans_and_fast_quads_true_raises():
    """A quad that is not a parallelogram: fast_quads None takes the two
    triangle fans (the lane counts record no parallelogram test, and the
    frame equals the wavefront's), True raises ValueError at every entry
    point that takes it, as JAX's attach guard does; vertices that require
    a gradient decide False, as JAX's check does for traced vertices."""
    scene, cam = _skewed_cornell()
    cfg = IntegratorConfig(bounces=BOUNCES)
    bn = torch.as_tensor(BN)
    assert not all_parallelograms(scene.quads)
    lanes = []
    got = megakernel.trace_image_fused_reference(scene, cam, cfg, RES, RES, 2.0, RV, bn, lane_counts=lanes)
    assert [int(c.parallelogram_tests) for c in lanes] == [0] * BOUNCES
    fans = trace_image(scene, cam, cfg, RES, RES, 2.0, RV, bn)
    for a, b in zip(got, fans):
        assert torch.equal(a, b)
    fused = megakernel.trace_image_fused(scene, cam, cfg, RES, RES, 2.0, RV, bn)
    assert torch.equal(fused.color, fans.color)
    for call in (lambda: megakernel.trace_image_fused(scene, cam, cfg, RES, RES, 2.0, RV, bn, fast_quads=True),
                 lambda: megakernel.trace_image_fused_grads(scene, cam, cfg, RES, RES, 2.0, RV, bn, fast_quads=True),
                 lambda: megakernel.trace_frames_fused(scene, cam, cfg, RES, RES, [2.0], [RV], bn, fast_quads=True),
                 lambda: trace_image(scene, cam, cfg, RES, RES, 2.0, RV, bn, fast_quads=True)):
        with pytest.raises(ValueError, match="parallelogram"):
            call()
    cornell, _ = _convert(j_cornell_scene(), j_cornell_camera())
    assert resolve_fast_quads(cornell.quads, None) and not resolve_fast_quads(cornell.quads, False)
    traced = cornell.quads._replace(v0=cornell.quads.v0.clone().requires_grad_(True))
    assert not resolve_fast_quads(traced, None)


def test_decision_made_once_per_quad_geometry(monkeypatch):
    """The decision and the per-quad algebra are made once per quad
    geometry: a color swapped in by an optimizer step keeps them, an edit
    in place of a vertex (a new version) or another vertex tensor makes
    them again; the fast render and the staged pool agree frame by frame
    with the monolithic one (the pool's plain phases take the same test)."""
    calls = []
    allclose = np.allclose
    monkeypatch.setattr(triangles.np, "allclose", lambda *a, **k: calls.append(1) or allclose(*a, **k))
    scene, cam = _convert(j_cornell_scene(), j_cornell_camera())
    cfg = IntegratorConfig(bounces=BOUNCES)
    bn = torch.as_tensor(BN)
    one = megakernel.trace_image_fused(scene, cam, cfg, RES, RES, 2.0, RV, bn)
    recolored = scene._replace(quads=scene.quads._replace(color=scene.quads.color * 0.5))
    megakernel.trace_image_fused(recolored, cam, cfg, RES, RES, 2.0, RV, bn)
    rows = parallelogram_constants(recolored.quads)
    assert len(calls) == 1 and parallelogram_constants(scene.quads) is rows
    pool = megakernel.trace_frames_fused(scene, cam, cfg, RES, RES, [2.0], [RV], bn)
    assert len(calls) == 1
    for a, b in zip(pool, one):
        assert torch.equal(a[0], b)
    scene.quads.v2.add_(0.0)  # an in-place edit: a new version of the tensor
    megakernel.trace_image_fused(scene, cam, cfg, RES, RES, 2.0, RV, bn)
    assert len(calls) == 2
    moved = scene.quads._replace(v0=scene.quads.v0 + 1.0, v1=scene.quads.v1 + 1.0, v2=scene.quads.v2 + 1.0,
                                 v3=scene.quads.v3 + 1.0)
    assert all_parallelograms(moved) and len(calls) == 3
    assert parallelogram_constants(moved) is not rows


def test_decision_cache_keeps_the_scenes_in_use(monkeypatch):
    """``cached_on`` drops the least recently used entry: a scene launched
    again keeps its decision while other scenes pass through the cache, so
    a caller that alternates between scenes makes each decision once."""
    monkeypatch.setattr(triangles, "_CACHE", type(triangles._CACHE)())
    monkeypatch.setattr(triangles, "_CACHE_SIZE", 4)
    calls = []
    allclose = np.allclose
    monkeypatch.setattr(triangles.np, "allclose", lambda *a, **k: calls.append(1) or allclose(*a, **k))
    base, _ = _convert(j_cornell_scene(), j_cornell_camera())
    scenes = [base.quads._replace(v0=base.quads.v0 + i, v1=base.quads.v1 + i, v2=base.quads.v2 + i,
                                  v3=base.quads.v3 + i) for i in range(6)]
    for other in scenes[1:]:  # 5 other decisions through a cache of 4, scene 0 asked between each
        assert all_parallelograms(scenes[0]) and all_parallelograms(other)
    assert len(calls) == 6 and len(triangles._CACHE) == 4
    assert all_parallelograms(scenes[0]) and len(calls) == 6
    assert all_parallelograms(scenes[1]) and len(calls) == 7  # the oldest entry was dropped
