"""The port's public helpers that the integrator does not call (it draws at
fixed sites through the ``*_from_uniforms`` forms), against their JAX
counterparts on the cases of tests/test_core.py, tests/test_geometry.py and
tests/test_mesh.py, on the CPU.  The hash draws and every comparison and
select are bit-equal; where cos, sin, sqrt or pow enter, the two libraries
may round differently, so the bar is atol 4e-6 on unit vectors and weights
(measured: at most 1.8e-6) and rtol 1e-5 on distances; each JAX test's own
property is checked on the port too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu import lights as jlights
from bpt_tpu.core import rng as jrng
from bpt_tpu.core import sampling as jsampling
from bpt_tpu.geometry import triangles as jtriangles
from bpt_tpu.geometry.quadrics import sphere_intersect as j_sphere_intersect
from bpt_tpu.utils import transforms as jtransforms
from bpt_tpu_torch import lights
from bpt_tpu_torch.core import rng, sampling
from bpt_tpu_torch.core.vecmath import INFINITY, dot, normalize
from bpt_tpu_torch.geometry import triangles
from bpt_tpu_torch.geometry.quadrics import sphere_intersect
from bpt_tpu_torch.utils import transforms


def _states(frame, px, py):
    """The same hash state in both packages."""
    return rng.rng_seed(frame, torch.as_tensor(px), torch.as_tensor(py)), jrng.rng_seed(frame, jnp.asarray(px),
                                                                                       jnp.asarray(py))


def _same_state(t, j):
    assert np.array_equal(t.sx.numpy(), np.asarray(j.sx).astype(np.int64))
    assert np.array_equal(t.sy.numpy(), np.asarray(j.sy).astype(np.int64))


def _close(a, b, atol=4e-6):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def test_rng_next2():
    t, j = _states(3, np.arange(1024) % 32, np.arange(1024) // 32)
    a, b, t = rng.rng_next2(t)
    ja, jb, j = jrng.rng_next2(j)
    assert np.array_equal(a.numpy(), np.asarray(ja)) and np.array_equal(b.numpy(), np.asarray(jb))
    _same_state(t, j)


def test_random_sphere_direction():
    """tests/test_core.py's test_sphere_direction_is_unit."""
    t, j = _states(1, np.arange(512), np.arange(512))
    d, t = sampling.random_sphere_direction(t)
    jd, j = jsampling.random_sphere_direction(j)
    _close(d, jd)
    _same_state(t, j)
    np.testing.assert_allclose(dot(d, d).numpy(), 1.0, atol=1e-5)
    assert abs(d.mean().item()) < 0.05


def test_random_cos_weighted_hemisphere():
    """tests/test_core.py's test_cosine_hemisphere_distribution."""
    t, j = _states(11, np.arange(8192) % 128, np.arange(8192) // 128)
    nl = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), (8192, 3)).copy()
    d, t = sampling.random_cos_weighted_hemisphere(torch.as_tensor(nl), t)
    jd, j = jsampling.random_cos_weighted_hemisphere(jnp.asarray(nl), j)
    _close(d, jd)
    _same_state(t, j)
    assert (d[:, 2] > -1e-6).all() and abs(d[:, 2].mean().item() - 2.0 / 3.0) < 0.02


@pytest.mark.parametrize("roughness", [0.0, 0.35, 1.0])
def test_random_direction_in_specular_lobe(roughness):
    """tests/test_core.py's test_specular_lobe_roughness_limits."""
    t, j = _states(2, np.arange(1024), np.arange(1024))
    refl = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), (1024, 3)).copy()
    d, t = sampling.random_direction_in_specular_lobe(torch.as_tensor(refl), roughness, t)
    jd, j = jsampling.random_direction_in_specular_lobe(jnp.asarray(refl), roughness, j)
    _close(d, jd)
    _same_state(t, j)
    if roughness == 0.0:
        np.testing.assert_allclose(d.numpy(), refl, atol=1e-6)
    else:
        np.testing.assert_allclose(dot(d, d).numpy(), 1.0, atol=1e-5)
        assert dot(d, torch.as_tensor(refl)).mean().item() < 0.999


def _receivers(n=256, seed=0):
    g = np.random.default_rng(seed)
    x = g.uniform(-40, 40, (n, 3)).astype(np.float32)
    x[:, 1] = -49.0  # on the Cornell floor, under the ceiling light
    nl = np.broadcast_to(np.array([0.0, 1.0, 0.0], np.float32), (n, 3)).copy()
    return x, nl


def test_sample_quad_light():
    """The Cornell ceiling light (quad 5) from floor points: three draws,
    the point clamped to the quad's [0.1, 0.9] margin."""
    from bpt_tpu_torch.scenes.cornell import cornell_scene

    q = cornell_scene().quads
    light = [q.v0[5], q.v1[5], q.v2[5], q.v3[5], q.normal[5]]
    x, nl = _receivers()
    t, j = _states(4, np.arange(256), np.arange(256) // 3)
    d, w, t = lights.sample_quad_light(torch.as_tensor(x), torch.as_tensor(nl), *light, t)
    jd, jw, j = jlights.sample_quad_light(jnp.asarray(x), jnp.asarray(nl), *(jnp.asarray(v.numpy()) for v in light), j)
    _close(d, jd)
    _close(w, jw)
    _same_state(t, j)
    assert (w > 0).all() and (w <= 1).all()


def test_sample_sphere_light():
    x, nl = _receivers(seed=1)
    pos, radius = torch.tensor([5.0, 30.0, -10.0]), 6.0
    t, j = _states(5, np.arange(256), np.arange(256) % 7)
    d, w, t = lights.sample_sphere_light(torch.as_tensor(x), torch.as_tensor(nl), pos, radius, t)
    jd, jw, j = jlights.sample_sphere_light(jnp.asarray(x), jnp.asarray(nl), jnp.asarray(pos.numpy()), radius, j)
    _close(d, jd)
    _close(w, jw)
    _same_state(t, j)
    to_light = normalize(pos - torch.as_tensor(x))
    assert (dot(d, to_light) > 0.9).all() and (w > 0).all()


@pytest.mark.parametrize("roughness", [0.1, 0.03])
def test_sample_sun(roughness):
    """The sky demo's (0.1) and the HDRI demo's (0.03) sun lobes."""
    x, nl = _receivers(seed=2)
    sun = normalize(torch.tensor([0.3, 0.8, -0.2]))
    t, j = _states(6, np.arange(256), np.arange(256))
    d, c, t = lights.sample_sun(torch.as_tensor(nl), sun, roughness, t)
    jd, jc, j = jlights.sample_sun(jnp.asarray(nl), jnp.asarray(sun.numpy()), roughness, j)
    _close(d, jd)
    _close(c, jc)
    _same_state(t, j)
    assert (dot(d, sun) > 0.8).all()


def _rays(n, seed, aim, spread):
    """n rays from the cube [-20, 20]^3 toward points within ``spread`` of
    ``aim``."""
    g = np.random.default_rng(seed)
    ro = g.uniform(-20, 20, (n, 3)).astype(np.float32)
    rd = (aim + g.uniform(-spread, spread, (n, 3)) - ro).astype(np.float32)
    return ro, (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)


def test_sphere_intersect():
    """tests/test_geometry.py's world-space sphere case, and random rays:
    t equal to JAX's within 1e-5, misses INFINITY in both."""
    ro, rd = torch.tensor([0.0, 0.0, -5.0]), torch.tensor([0.0, 0.0, 1.0])
    assert abs(float(sphere_intersect(2.0, torch.zeros(3), ro, rd)) - 3.0) < 1e-5
    pos = np.array([1.0, -2.0, 3.0], np.float32)
    ro, rd = _rays(512, 3, aim=pos, spread=12.0)
    t = sphere_intersect(9.0, torch.as_tensor(pos), torch.as_tensor(ro), torch.as_tensor(rd))
    jt = np.asarray(j_sphere_intersect(9.0, jnp.asarray(pos), jnp.asarray(ro), jnp.asarray(rd)))
    assert np.array_equal(t.numpy() == INFINITY, jt == INFINITY) and (jt < INFINITY).mean() > 0.3
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-5, atol=1e-5)


def test_bounding_box_intersect():
    """tests/test_geometry.py's test_aabb_slab_inside_opens, and random
    rays against JAX bit for bit (no rounding but the products')."""
    mn, mx = torch.tensor([-1.0, -1.0, -1.0]), torch.tensor([1.0, 1.0, 1.0])
    t = triangles.bounding_box_intersect(mn, mx, torch.zeros(3), 1.0 / torch.tensor([0.0, 0.0, 1.0]))
    assert float(t) < 0.0
    t2 = triangles.bounding_box_intersect(mn, mx, torch.tensor([0.0, 5.0, 0.0]),
                                          1.0 / torch.tensor([0.0, 1.0, 0.0]))
    assert float(t2) == INFINITY
    ro, rd = _rays(512, 4, aim=np.zeros(3, np.float32), spread=9.0)
    bmn, bmx = np.array([-6, -4, -8], np.float32), np.array([7, 5, 3], np.float32)
    got = triangles.bounding_box_intersect(torch.as_tensor(bmn), torch.as_tensor(bmx), torch.as_tensor(ro),
                                           1.0 / torch.as_tensor(rd))
    ref = jtriangles.bounding_box_intersect(jnp.asarray(bmn), jnp.asarray(bmx), jnp.asarray(ro), 1.0 / jnp.asarray(rd))
    assert np.array_equal(got.numpy(), np.asarray(ref)) and (np.asarray(ref) < INFINITY).mean() > 0.2


@pytest.mark.parametrize("double_sided", [True, False])
def test_bvh_triangle_intersect(double_sided):
    """tests/test_geometry.py's test_bvh_triangle_barycentrics and
    tests/test_mesh.py's brute-force case (64 rays against a random
    triangle soup, closest t per ray), against JAX."""
    v0, v1, v2 = torch.tensor([0.0, 0.0, 0.0]), torch.tensor([1.0, 0.0, 0.0]), torch.tensor([0.0, 1.0, 0.0])
    ro, rd = torch.tensor([0.25, 0.5, 1.0]), torch.tensor([0.0, 0.0, -1.0])
    t, u, v = triangles.bvh_triangle_intersect(v0, v1, v2, ro, rd, double_sided=True)
    np.testing.assert_allclose([float(t), float(u), float(v)], [1.0, 0.25, 0.5], atol=1e-5)
    g = np.random.default_rng(7)
    c = g.normal(0, 8, (200, 1, 3)).astype(np.float32)
    tri = (c + g.normal(0, 3, (200, 3, 3))).astype(np.float32)
    ro = g.uniform(-20, 20, (64, 3)).astype(np.float32)
    rd = normalize(torch.as_tensor(g.normal(size=(64, 3)).astype(np.float32)))
    p = [torch.as_tensor(tri[:, i]) for i in range(3)]
    got = triangles.bvh_triangle_intersect(*p, torch.as_tensor(ro)[:, None], rd[:, None], double_sided=double_sided)
    ref = jtriangles.bvh_triangle_intersect(*(jnp.asarray(v.numpy()) for v in p), jnp.asarray(ro)[:, None],
                                            jnp.asarray(rd.numpy())[:, None], double_sided=double_sided)
    hit = np.asarray(ref[0]) < INFINITY
    assert hit.any() and np.array_equal(got[0].numpy() < INFINITY, hit)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy().min(1), np.asarray(ref[0]).min(1), rtol=1e-5)


def test_compose():
    """compose(a, b, c) = a @ b @ c, as JAX's, on TRS matrices."""
    args = [dict(translation=(1.0, 2.0, 3.0)), dict(rotation=(0.3, -0.2, 0.7)), dict(scale=(2.0, 0.5, 1.5))]
    got = transforms.compose(*(transforms.trs_matrix(**a) for a in args))
    ref = jtransforms.compose(*(jtransforms.trs_matrix(**a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    m = transforms.trs_matrix(**args[1])
    assert torch.equal(transforms.compose(m), m)
