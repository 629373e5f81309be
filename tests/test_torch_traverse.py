"""The wavefront closest-hit query (``bpt_tpu_torch.kernels.traverse``)
against the JAX package's two Pallas kernels, ``packet_closest_hit`` (K3)
and ``hbm_closest_hit`` (K4), both run in interpret mode as
tests/test_mesh.py runs them, and its recompute VJP against ``jax.vjp`` of
``packet_closest_hit`` and against autograd through the plain walk.

On the CPU ``closest_hit`` runs its plain version, ``traverse_bvh``; the
CUDA kernel is held to that bit for bit on the card
(tests/test_torch_kernels.py, chip_smoke.py).  JAX walks clusterized packs
with one cursor per packet, the port the binary BVH per lane: the same
closest hits, with t within the walks' float association (rtol 1e-5), and
triangle ids that map through the pack's ``tri_order``.  The mesh
transform's gradient through the whole wavefront is held to JAX's packet
route (its per-lane walk is a while loop that reverse mode cannot cross),
run in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.integrator.frame import trace_image as j_trace_image
from bpt_tpu.io.gltf import GLTFModel as JGLTFModel

from bpt_tpu.accel.builder import build_bvh, triangle_aabbs
from bpt_tpu.accel.cluster import pack_clustered, pack_clustered_dense
from bpt_tpu.kernels.traverse import hbm_closest_hit, packet_closest_hit
from bpt_tpu_torch.diff import make_render_loss, value_and_param_grads
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.integrator.frame import trace_image
from bpt_tpu_torch.io.gltf import GLTFModel
from bpt_tpu_torch.kernels import traverse
from bpt_tpu_torch.scenes import gltf_scene
from bpt_tpu_torch.scenes.types import TriangleMesh, kernel_tables_of, mesh_tables, resident_tables
from test_mesh import random_soup
from test_torch_mesh_grads import BN, BOX, RES, RV, jgltf, plain_blob

torch.set_num_threads(2)


def _port_mesh(p0, p1, p2, bvh) -> TriangleMesh:
    """The port's TriangleMesh over the JAX builder's binary BVH of a soup."""
    n = p0.shape[0]
    z3, z2 = torch.zeros(n, 3), torch.zeros(n, 2)
    t = torch.as_tensor
    return TriangleMesh(p0=t(p0), p1=t(p1), p2=t(p2), n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2, uv2=z2,
                        node_tri=t(np.asarray(bvh.node_tri, np.int32)),
                        node_right=t(np.asarray(bvh.node_right, np.int32)),
                        node_min=t(np.asarray(bvh.node_min, np.float32)),
                        node_max=t(np.asarray(bvh.node_max, np.float32)), inv_matrix=torch.eye(4),
                        mat_type=torch.tensor(1, dtype=torch.int32))


def _packing_soup():
    """tests/test_mesh.py:139's soup: the first whose clusterized node count
    is not a multiple of 8."""
    for n in (96, 128, 160, 224, 256):
        p0, p1, p2 = random_soup(n, seed=11)
        mn, mx, _ = triangle_aabbs(p0, p1, p2)
        bvh = build_bvh(mn, mx)
        z2, z3 = np.zeros((n, 2), np.float32), np.zeros((n, 3), np.float32)
        pk = pack_clustered(bvh, p0, p1, p2, z3, z3, z3, z2, z2, z2, leaf_size=4)
        if pk.n_nodes % 8 != 0:
            return p0, p1, p2, bvh, pk
    raise AssertionError("no soup produced a non-multiple-of-8 node count")


def _rays(soup, seed, aimed):
    """32x32 rays: tests/test_mesh.py's (uniform origins, random unit
    directions) or, with ``aimed``, from the same origins toward random
    points inside random triangles of the soup (most of them hit)."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-20, 20, (32, 32, 3)).astype(np.float32)
    if aimed:
        pick = rng.integers(0, soup[0].shape[0], (32, 32))
        a, b = rng.uniform(0, 1, (2, 32, 32, 1))
        a, b = np.where(a + b > 1, 1 - a, a), np.where(a + b > 1, 1 - b, b)
        tgt = soup[0][pick] + a * (soup[1][pick] - soup[0][pick]) + b * (soup[2][pick] - soup[0][pick])
        rd = (tgt - ro).astype(np.float32)
    else:
        rd = rng.normal(size=(32, 32, 3)).astype(np.float32)
    return ro, (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)


def _jax_packet(pk, ro, rd, cull=0.0):
    return packet_closest_hit(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(cull), jnp.ones(ro.shape[:2], jnp.float32),
                              (jnp.asarray(pk.nodes_f), jnp.asarray(pk.nodes_i), jnp.asarray(pk.tris)),
                              int(pk.nodes_f.shape[0]), True)


def _close(got, want, rtol_all, rtol_most, share=0.99):
    """Every element within rtol_all, and at least ``share`` of them within
    rtol_most (the strict bar)."""
    np.testing.assert_allclose(got, want, rtol=rtol_all, atol=0)
    assert np.isclose(got, want, rtol=rtol_most, atol=0).mean() >= share


@pytest.mark.parametrize("aimed", [False, True])
def test_closest_hit_matches_packet_kernel(aimed):
    """The plain closest hit against JAX's K3 on the node-padding soup, back
    faces kept (cull off): the same hit mask, the same triangles (JAX's ids
    are the pack's, mapped by ``tri_order``), and t within rtol 1e-5 on
    tests/test_mesh.py's rays (random directions: few hits).  Rays aimed
    into the soup hit on most lanes, some of them at grazing angles, where
    the two walks' float association (JAX tests packed edges) moves t
    further: there 99% of the lanes meet rtol 1e-5 and all meet 1e-4
    (measured: 5 of 1024 lanes above 1e-5, at most 3.2e-5)."""
    p0, p1, p2, bvh, pk = _packing_soup()
    ro, rd = _rays((p0, p1, p2), 5, aimed)
    t_pk, _, _, _, tri_pk = (np.asarray(x) for x in _jax_packet(pk, ro, rd))
    t, tri, _, _ = traverse.closest_hit(torch.as_tensor(ro), torch.as_tensor(rd), False, None,
                                        _port_mesh(p0, p1, p2, bvh))
    hit = tri.numpy() >= 0
    np.testing.assert_array_equal(hit, tri_pk >= 0)
    np.testing.assert_array_equal(tri.numpy()[hit], np.asarray(pk.tri_order)[tri_pk[hit]])
    if aimed:
        _close(t.numpy()[hit], t_pk[hit], 1e-4, 1e-5)
        assert hit.sum() > 500
    else:
        np.testing.assert_allclose(t.numpy()[hit], t_pk[hit], rtol=1e-5)
        assert hit.sum() > 0


def test_closest_hit_matches_hbm_kernel():
    """The plain closest hit against JAX's K4 (the HBM-streamed walk) on
    tests/test_mesh.py:347's 300-triangle soup, culling back faces, with a
    lane mask: on the active lanes the same hit mask and triangles, and t
    within the bars of the aimed K3 case; masked lanes miss (JAX's mask only
    keeps a lane from steering the packet's cursor, so its masked lanes may
    report leaf hits)."""
    n = 300
    p0, p1, p2 = random_soup(n, seed=3)
    mn, mx, _ = triangle_aabbs(p0, p1, p2)
    bvh = build_bvh(mn, mx)
    z2, z3 = np.zeros((n, 2), np.float32), np.zeros((n, 3), np.float32)
    fz = pack_clustered_dense(bvh, p0, p1, p2, z3, z3, z3, z2, z2, z2, leaf_size=16)
    ro, rd = _rays((p0, p1, p2), 9, aimed=True)
    act = np.random.default_rng(2).uniform(0, 1, (32, 32)) < 0.8
    t_hb, _, _, _, slot = (np.asarray(x) for x in hbm_closest_hit(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(1.0), jnp.asarray(act, jnp.float32), jnp.asarray(fz.nodes_f),
        jnp.asarray(fz.tris), True))
    t, tri, _, _ = traverse.closest_hit(torch.as_tensor(ro), torch.as_tensor(rd), True, torch.as_tensor(act),
                                        _port_mesh(p0, p1, p2, bvh))
    hit = tri.numpy() >= 0
    np.testing.assert_array_equal(hit[act], slot[act] >= 0)
    np.testing.assert_array_equal(tri.numpy()[hit], np.asarray(fz.tri_order)[slot[hit]])
    _close(t.numpy()[hit], t_hb[hit], 1e-4, 1e-5)
    assert hit.sum() > 300 and not hit[~act].any()


def test_closest_hit_vjp_matches_jax_and_plain_autograd():
    """The recompute VJP: (g_ro, g_rd) for a cotangent on t against
    ``jax.vjp`` of ``packet_closest_hit`` on the lanes with the same winner,
    and for cotangents on t, u and v against autograd through the plain walk
    (rtol 1e-5).  Against JAX: rtol 1e-4 on tests/test_mesh.py's rays; on
    rays aimed into the soup, 99.5% of the components within rtol 1e-4 and
    all within 1e-3 (JAX's recompute divides by det where the walk
    multiplies by ``safe_inv`` and sums in another order, which grazing
    lanes amplify: measured 3 of 3072 components above 1e-4, at most
    1.8e-4).  Vertex tensors that require a gradient get one through the
    gathered vertices (JAX gives its packs zeros), equal to autograd's
    through the walk."""
    p0, p1, p2, bvh, pk = _packing_soup()
    mesh = _port_mesh(p0, p1, p2, bvh)
    rng = np.random.default_rng(3)
    ct, cu, cv = (rng.normal(size=(32, 32)).astype(np.float32) for _ in range(3))

    def kernel_walk(o, d, m):
        return traverse.closest_hit(o, d, False, None, m)

    def plain_walk(o, d, m):
        return traverse.closest_hit_reference(o, d, False, None, m)

    def port(ro, rd, walk, with_uv, vertices=False):
        o, d = torch.tensor(ro, requires_grad=True), torch.tensor(rd, requires_grad=True)
        m = mesh._replace(**{k: getattr(mesh, k).clone().requires_grad_(vertices) for k in ("p0", "p1", "p2")})
        t, tri, u, v = walk(o, d, m)
        loss = (torch.where(tri >= 0, t, 0.0) * torch.as_tensor(ct)).sum()
        if with_uv:
            loss = loss + (u * torch.as_tensor(cu) + v * torch.as_tensor(cv)).sum()
        leaves = [o, d] + ([m.p0, m.p1, m.p2] if vertices else [])
        return tri.numpy(), [g.numpy() for g in torch.autograd.grad(loss, leaves)]

    for aimed in (False, True):
        ro, rd = _rays((p0, p1, p2), 5 if not aimed else 7, aimed)
        out, vjp = jax.vjp(lambda o, d: _jax_packet(pk, o, d), jnp.asarray(ro), jnp.asarray(rd))
        zero = np.zeros((32, 32), jax.dtypes.float0)
        j_grads = [np.asarray(g) for g in vjp((jnp.asarray(ct), jnp.zeros((32, 32, 3)), jnp.zeros((32, 32)),
                                               jnp.zeros((32, 32)), zero))]
        tri, grads = port(ro, rd, kernel_walk, with_uv=False)
        same = (tri >= 0) & (np.asarray(pk.tri_order)[np.maximum(np.asarray(out[4]), 0)] == tri)
        assert same.sum() > (500 if aimed else 0)
        for g, j in zip(grads, j_grads):
            if aimed:
                np.testing.assert_allclose(g[same], j[same], rtol=1e-3, atol=1e-5)
                assert np.isclose(g[same], j[same], rtol=1e-4, atol=1e-5).mean() >= 0.995
            else:
                np.testing.assert_allclose(g[same], j[same], rtol=1e-4, atol=1e-5)
            assert not g[tri < 0].any()  # missed lanes: killed cotangents
    _, got = port(ro, rd, kernel_walk, with_uv=True, vertices=True)
    _, ref = port(ro, rd, plain_walk, with_uv=True, vertices=True)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert np.abs(got[2]).sum() > 0


def test_resident_tables_follow_the_soup():
    """A mesh's kernel tables are used only while they were made from the
    soup and BVH tensors it holds: swapping a map keeps them, replacing or
    editing in place a vertex table or the BVH does not (the tables are made
    anew for the call), and a textured mesh needs its UV records.  Scene.to keeps
    resident tables on the card (tests/test_torch_kernels.py) and drops
    them elsewhere."""
    p0, p1, p2, bvh, _ = _packing_soup()
    mesh = _port_mesh(p0, p1, p2, bvh)
    tables = mesh_tables(mesh)
    mesh = mesh._replace(kernel_tables=tables)
    assert resident_tables(mesh) is tables and kernel_tables_of(mesh) is tables
    albedo = torch.full((4, 4, 3), 0.5)
    assert resident_tables(mesh._replace(albedo=albedo)) is None  # textured now: the tables lack UV records
    textured = mesh._replace(albedo=albedo, kernel_tables=mesh_tables(mesh._replace(albedo=albedo)))
    assert resident_tables(textured._replace(albedo=torch.zeros(4, 4, 3))) is textured.kernel_tables
    for field in ("p0", "node_min", "uv1"):
        moved = mesh._replace(**{field: getattr(mesh, field).clone()})
        assert resident_tables(moved) is None
        assert kernel_tables_of(moved) is not tables
    shifted = mesh._replace(p0=mesh.p0 + 1.0)
    torch.testing.assert_close(kernel_tables_of(shifted).tris[:, 0, :3], shifted.p0, rtol=0, atol=0)
    edited = mesh._replace(p0=mesh.p0.clone(), node_max=mesh.node_max.clone())
    edited = edited._replace(kernel_tables=mesh_tables(edited))
    assert resident_tables(edited) is edited.kernel_tables
    for field in ("p0", "node_max"):
        getattr(edited, field).add_(1.0)
        assert resident_tables(edited) is None
        torch.testing.assert_close(kernel_tables_of(edited).tris[:, 0, :3], edited.p0, rtol=0, atol=0)
        edited = edited._replace(kernel_tables=mesh_tables(edited))


# ---- the mesh transform through the wavefront route --------------------------------

@pytest.fixture(scope="module")
def translation_jax():
    jmesh = jgltf.mesh_from_model(plain_blob(JGLTFModel), mat_type=1, **BOX)
    cam, cfg = jgltf.gltf_camera(), JConfig(bounces=2)

    def loss(t):
        inv = jmesh.inv_matrix @ jnp.eye(4).at[:3, 3].set(-t)
        color = j_trace_image(jgltf.gltf_scene(jmesh._replace(inv_matrix=inv)), cam, cfg, RES, RES, 2.0,
                              jnp.asarray(RV), jnp.asarray(BN)).color
        return jnp.mean(color)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BPT_MESH_TRAVERSAL", "interpret")  # JAX reads it per call: its packet route, in interpret mode
        return np.asarray(jax.grad(loss)(jnp.zeros(3, jnp.float32)))


def test_mesh_translation_gradient_matches_jax_packet_route(translation_jax):
    """make_render_loss's gradient in the mesh's translation (the wavefront
    route: the closest-hit query's recompute VJP) against ``jax.grad``
    through JAX's trace_image on its packet route (``_pch_bwd``), on the
    21-triangle blob at 32², 2 bounces (with 1 the color takes no term that
    moves with the mesh): rtol 1e-3 (the walks' t differ in the last bits),
    and against the same loss through the plain walk (rtol 1e-5)."""
    mesh = gltf_scene.mesh_from_model(plain_blob(GLTFModel), mat_type=1, **BOX)
    scene, cam = gltf_scene.gltf_scene(mesh), gltf_scene.gltf_camera()
    inv0 = mesh.inv_matrix

    def build(params):
        shift = torch.eye(4)
        shift = torch.cat([torch.cat([shift[:3, :3], -params["t"].reshape(3, 1)], 1), shift[3:]])
        return scene._replace(mesh=scene.mesh._replace(inv_matrix=inv0 @ shift)), cam

    def plain_loss(params):  # the same loss with the plain walk
        s, c = build(params)
        return trace_image(s, c, IntegratorConfig(bounces=2), RES, RES, 2.0, RV, torch.as_tensor(BN),
                           plain_walk=True).color.mean()

    _, g = value_and_param_grads(make_render_loss(build, IntegratorConfig(bounces=2), RES, RES, frames=(2.0,),
                                                  blue_noise=BN), {"t": torch.zeros(3)})
    _, g_plain = value_and_param_grads(plain_loss, {"t": torch.zeros(3)})
    np.testing.assert_allclose(g["t"].numpy(), translation_jax, rtol=1e-3, atol=1e-7)
    torch.testing.assert_close(g["t"], g_plain["t"], rtol=1e-5, atol=1e-9)
    assert float(g["t"].abs().min()) > 0
