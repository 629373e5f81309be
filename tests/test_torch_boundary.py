"""The port's boundary-gradient terms (bpt_tpu_torch.diff.silhouette and
diff.shadow, plain torch) against the JAX package's on the same inputs, on
the CPU: the scenes of tests/test_gradients.py:232 and :371 (the Cornell
box with sphere 0 moved to x = -22.5, radius 16, 2 bounces) at 32x32 with
n_samples 64, n_paths 2 and n_phi 64.  Each term is a sum over edge samples
of radiance differences, so a lane whose path the two packages end
differently would move it; the bar is rtol 1e-4 (measured: within 1e-6).

The shadow term's NEE gate follows the integrator, not the JAX package:
``diffuse_indirect_max = 0`` shows the two apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.camera import Camera as JCamera
from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.diff.shadow import quad_shadow_boundary_gradient as j_shadow
from bpt_tpu.diff.silhouette import _project as j_project
from bpt_tpu.diff.silhouette import _rays_through as j_rays_through
from bpt_tpu.diff.silhouette import sphere_silhouette_gradient as j_silhouette
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.scenes.cornell import cornell_scene as j_cornell_scene
from bpt_tpu.utils.transforms import invert_rigid, trs_matrix
from bpt_tpu_torch import convert
from bpt_tpu_torch.camera import generate_rays
from bpt_tpu_torch.core.rng import blue_noise_fetch, rng_seed
from bpt_tpu_torch.diff.shadow import first_receivers, quad_shadow_boundary_gradient
from bpt_tpu_torch.diff.silhouette import _project, _rays_through, crn_streams, sphere_silhouette_gradient
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.integrator.intersect import scene_intersect
from bpt_tpu_torch.integrator.radiance import init_paths, run_bounces
from bpt_tpu_torch.scenes.types import DIFFUSE

torch.set_num_threads(2)

RES = 32
BN = blue_noise_table()
TBN = torch.as_tensor(BN)
RV = np.array([0.3, 0.7], np.float32)
SR, CY, CZ, X0 = 16.0, -33.9, -10.0, -22.5
JCAM = JCamera.look(position=(0.0, -20.0, -120.0), fov=0.8, focus_distance=113.0)
CAM = convert.camera_from_numpy(jax.tree.map(np.asarray, JCAM))


def j_scene_of(x):
    base = j_cornell_scene()
    m = trs_matrix(translation=(x, CY, CZ), scale=(SR, SR, SR))
    return base._replace(spheres=base.spheres._replace(inv_matrix=base.spheres.inv_matrix.at[0].set(invert_rigid(m))))


SCENE = convert.scene_from_numpy(jax.tree.map(np.asarray, j_scene_of(jnp.asarray(X0))))


def j_center(x):
    return jnp.stack([x, jnp.asarray(CY), jnp.asarray(CZ)]), SR


def t_center(x):
    return torch.stack([x, torch.tensor(CY), torch.tensor(CZ)]), SR


def test_projection_and_film_rays_match_jax():
    pts = np.random.default_rng(0).uniform(-40, 40, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(_project(CAM, torch.as_tensor(pts), RES, RES).numpy(),
                               np.asarray(j_project(JCAM, jnp.asarray(pts), RES, RES)), rtol=1e-5, atol=1e-4)
    pix = np.random.default_rng(1).uniform(0, RES, (64, 2)).astype(np.float32)
    for a, b in zip(_rays_through(CAM, torch.as_tensor(pix), RES, RES), j_rays_through(JCAM, jnp.asarray(pix), RES, RES)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_common_random_numbers_are_uint32_arithmetic():
    """The per-sample streams: int64 masked to 32 bits equals numpy's uint32
    wrap-around, for the replicate indices the estimator uses and past
    2^32."""
    for k in (0, 1, 7, 40000):
        rng, bx, by = crn_streams(1000, k, "cpu")
        sx = (np.arange(1000, dtype=np.uint32) * np.uint32(7919) + np.uint32(13)) % np.uint32(104729)
        with np.errstate(over="ignore"):
            assert np.array_equal(rng.sx.numpy(), (sx * np.uint32(k + 3)).astype(np.int64))
            assert np.array_equal(rng.sy.numpy(), (sx + np.uint32(17 * k)).astype(np.int64))
        assert np.array_equal(bx.numpy(), sx % 256) and np.array_equal(by.numpy(), (sx // 7) % 256)


def test_silhouette_gradient_matches_jax():
    """tests/test_gradients.py:232's window (the silhouette band the sphere
    covers moving +x) and estimator, the port against JAX."""
    cfg, jcfg = IntegratorConfig(bounces=2), JConfig(bounces=2)
    c_pix = np.asarray(j_project(JCAM, j_center(jnp.asarray(X0))[0][None], RES, RES))[0]
    r_pix = abs(float(np.asarray(j_project(JCAM, (j_center(jnp.asarray(X0))[0] + jnp.asarray([SR, 0.0, 0.0]))[None],
                                           RES, RES))[0][0] - c_pix[0]))
    w_norm = 1.0 / (RES * RES * 3.0)

    def j_weight(pix):
        w = jnp.where((pix[..., 0] > c_pix[0] + 3) & (jnp.abs(pix[..., 1] - c_pix[1]) < r_pix * 0.7), w_norm, 0.0)
        return jnp.broadcast_to(w[..., None], w.shape + (3,))

    def t_weight(pix):
        on = (pix[..., 0] > float(c_pix[0]) + 3) & (torch.abs(pix[..., 1] - float(c_pix[1])) < r_pix * 0.7)
        return (on.float() * w_norm)[..., None].expand(on.shape + (3,))

    ref = float(j_silhouette(j_scene_of, jnp.asarray(X0), j_center, JCAM, jcfg, RES, RES, j_weight, 2.0,
                             jnp.asarray(RV), jnp.asarray(BN), n_samples=64, n_paths=2, eps_px=1.4))
    got = float(sphere_silhouette_gradient(lambda th: SCENE, X0, t_center, CAM, cfg, RES, RES, t_weight, 2.0, RV,
                                           TBN, n_samples=64, n_paths=2, eps_px=1.4))
    assert abs(ref) > 1e-7
    assert abs(got - ref) <= 1e-4 * abs(ref), (got, ref)


def _floor_window():
    """tests/test_gradients.py:371's receiver window at RES: floor pixels in
    an annulus around the contact region, away from the sphere's direct
    silhouette."""
    yy, xx = np.mgrid[0:RES, 0:RES]
    pix = np.stack([xx.ravel() + 0.5, yy.ravel() + 0.5], -1).astype(np.float32)
    ro, rd = (np.asarray(a) for a in j_rays_through(JCAM, jnp.asarray(pix), RES, RES))
    t_f = (-50.0 - ro[:, 1]) / np.where(rd[:, 1] == 0, 1e-9, rd[:, 1])
    xw = ro + t_f[:, None] * rd
    c = np.asarray([X0, CY, CZ])
    line_d = np.linalg.norm(np.cross(rd, c[None] - ro), axis=-1)
    d2d = np.hypot(xw[:, 0] - c[0], xw[:, 2] - c[2])
    sel = ((rd[:, 1] < 0) & (t_f > 0) & (np.abs(xw[:, 0]) < 48) & (np.abs(xw[:, 2]) < 48)
           & (d2d > SR + 5) & (d2d < SR + 24) & (line_d > SR + 5.0))
    assert sel.sum() > 20, sel.sum()
    return pix[sel]


def _shadow_pair(dim: int, pix) -> tuple[float, float]:
    cfg, jcfg = IntegratorConfig(bounces=2, diffuse_indirect_max=dim), JConfig(bounces=2, diffuse_indirect_max=dim)
    w_norm = 1.0 / (pix.shape[0] * 3.0)
    ref = float(j_shadow(j_scene_of, jnp.asarray(X0), j_center, JCAM, jcfg, RES, RES,
                         lambda p: jnp.full(p.shape[:-1] + (3,), w_norm), jnp.asarray(pix), 2.0, jnp.asarray(RV),
                         jnp.asarray(BN), n_phi=64))
    got = float(quad_shadow_boundary_gradient(lambda th: SCENE, X0, t_center, CAM, cfg, RES, RES,
                                              lambda p: torch.full(p.shape[:-1] + (3,), w_norm),
                                              torch.as_tensor(pix), 2.0, RV, TBN, n_phi=64))
    return got, ref


def _bounce0(cfg, pix):
    """The integrator's own bounce 0 at the receivers: (first-hit DIFFUSE,
    took NEE there)."""
    px, py = torch.as_tensor(pix[:, 0]).int(), torch.as_tensor(pix[:, 1]).int()
    ro, rd, rng = generate_rays(CAM, px, py, RES, RES, rng_seed(2.0, px, py))
    diffuse = scene_intersect(SCENE, ro, rd).mat_type == DIFFUSE
    state = init_paths(SCENE, cfg, ro, rd, rng, blue_noise_fetch(TBN, px, py, RV), 2.0)
    return diffuse, run_bounces(SCENE, cfg, state, 0, 1).sample_light


def test_shadow_gradient_matches_jax():
    """tests/test_gradients.py:371's floor window and estimator (interior
    sub-rectangle term and the clamped-edge atoms), the port against JAX at
    the default diffuse_indirect_max = 1, where the two NEE gates agree.
    The receivers reach the branch: some took NEE, some the cosine bounce,
    as the integrator's own bounce 0 decides."""
    pix = _floor_window()
    got, ref = _shadow_pair(1, pix)
    assert abs(ref) > 1e-7
    assert abs(got - ref) <= 1e-4 * abs(ref), (got, ref)
    cfg = IntegratorConfig(bounces=2)
    _, _, _, valid = first_receivers(SCENE, CAM, cfg, RES, RES, torch.as_tensor(pix), 2.0, RV, TBN)
    diffuse, nee = _bounce0(cfg, pix)
    assert 0 < int(valid.sum()) < int(diffuse.sum())
    assert torch.equal(valid, diffuse & nee)


def test_shadow_nee_gate_follows_the_integrator():
    """At diffuse_indirect_max = 0 the integrator takes NEE at every first
    diffuse vertex; the port's receivers are exactly those, while the JAX
    package still gates on the blue noise (bpt_tpu/diff/shadow.py:269-272)
    and so misses about half of them: the two terms differ."""
    pix = _floor_window()
    cfg = IntegratorConfig(bounces=2, diffuse_indirect_max=0)
    _, _, _, valid = first_receivers(SCENE, CAM, cfg, RES, RES, torch.as_tensor(pix), 2.0, RV, TBN)
    diffuse, nee = _bounce0(cfg, pix)
    assert bool(nee[diffuse].all()) and torch.equal(valid, diffuse)
    _, _, _, valid1 = first_receivers(SCENE, CAM, IntegratorConfig(bounces=2), RES, RES, torch.as_tensor(pix), 2.0,
                                      RV, TBN)
    assert int(valid1.sum()) < int(valid.sum())
    got, ref = _shadow_pair(0, pix)
    ref1 = _shadow_pair(1, pix)[1]
    assert ref == ref1  # JAX ignores diffuse_indirect_max
    assert abs(got - ref) > 0.1 * abs(ref), (got, ref)


@pytest.mark.parametrize("term", ["silhouette", "shadow"])
def test_boundary_terms_run_where_their_inputs_live(term):
    """The terms run on the device of the blue noise; theta may be a float
    or a tensor; the result is a finite 0-d tensor."""
    cfg = IntegratorConfig(bounces=1)
    w = lambda p: torch.full(p.shape[:-1] + (3,), 1.0)
    if term == "silhouette":
        out = sphere_silhouette_gradient(lambda th: SCENE, torch.tensor(X0), t_center, CAM, cfg, 8, 8, w, 2.0, RV,
                                         TBN, n_samples=8, n_paths=1)
    else:
        out = quad_shadow_boundary_gradient(lambda th: SCENE, torch.tensor(X0), t_center, CAM, cfg, 8, 8, w,
                                            torch.tensor([[4.5, 1.5], [5.5, 0.5]]), 2.0, RV, TBN, n_phi=8)
    assert out.shape == () and bool(torch.isfinite(out))
