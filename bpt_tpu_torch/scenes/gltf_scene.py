"""glTF-model demo scenes (port of ``bpt_tpu.scenes.gltf_scene``).

* ``gltf_scene``: the Cornell box with its quad light, the two instanced
  spheres and a BVH mesh (the glTF demo);
* ``hdri_scene``: the open box, the two spheres, the mesh and an equirect
  HDR environment with its brightest-texel sun and its sampling CDFs (the
  HDRI demo);
* ``heightfield_model``: the 524,288-triangle heightfield of ``bench.py``'s
  capacity cell (``n_side = 512``), a stand-in for large glTF assets.

``mesh_from_model`` builds the binary BVH on the host (binned SAH, the
native builder when it compiles) and wraps the soup and the model's PBR maps
as a ``TriangleMesh``.  The reference's TPU bakes and splits
(``bake_triangle_attrs``, ``_bake_vertex_normal_map``,
``split_mixed_decision_triangles``, ``split_normal_variance_triangles``) are
not carried: they shrink the bias of a Pallas kernel that cannot fetch a
texel per lane, and the CUDA kernel fetches its own texels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bpt_tpu_torch.accel.builder import build_bvh_sah, triangle_aabbs
from bpt_tpu_torch.camera import Camera
from bpt_tpu_torch.env import build_env_cdf, sun_direction_from_hdr
from bpt_tpu_torch.io.gltf import GLTFModel
from bpt_tpu_torch.scenes.cornell import SPHERE_RADIUS, WALL_RADIUS, cornell_walls_rows, quad_light_rows
from bpt_tpu_torch.scenes.types import (
    CLEARCOAT_DIFFUSE,
    DIFFUSE,
    METAL,
    Environment,
    Scene,
    TriangleMesh,
    UnitSpheres,
    make_quad,
    quads_from_rows,
)
from bpt_tpu_torch.utils.transforms import invert_rigid, trs_matrix


def mesh_from_model(model: GLTFModel, mat_type: int = METAL, translation=(0.0, 0.0, 0.0),
                    rotation=(0.0, 0.0, 0.0), scale=(1.0, 1.0, 1.0), use_native: str = "auto",
                    device=None) -> TriangleMesh:
    """A glTF soup -> TriangleMesh with a freshly built BVH.

    The transform is the model's runtime TransformNode (its inverse becomes
    ``inv_matrix``); the initial scale is already in the vertices.  The
    BVH is the binned-SAH build; ``use_native``: as
    ``accel.builder.build_bvh_sah``.  The four PBR maps are carried as
    (H, W, 3) float32, sRGB-encoded, v = 0 at row 0; ``mat_type`` is the
    material of a model without an albedo.
    """
    mn, mx, _ = triangle_aabbs(model.p0, model.p1, model.p2)
    bvh = build_bvh_sah(mn, mx, use_native=use_native)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def tex(a):
        return None if a is None else torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    m = trs_matrix(translation=translation, rotation=rotation, scale=scale, device=device)
    return TriangleMesh(
        p0=dev(model.p0), p1=dev(model.p1), p2=dev(model.p2),
        n0=dev(model.n0), n1=dev(model.n1), n2=dev(model.n2),
        uv0=dev(model.uv0), uv1=dev(model.uv1), uv2=dev(model.uv2),
        node_tri=dev(bvh.node_tri), node_right=dev(bvh.node_right),
        node_min=dev(bvh.node_min), node_max=dev(bvh.node_max),
        inv_matrix=invert_rigid(m),
        mat_type=torch.tensor(mat_type, dtype=torch.int32, device=device),
        albedo=tex(model.albedo), normal_map=tex(model.normal_map),
        metallic_roughness=tex(model.metallic_roughness), emissive=tex(model.emissive),
    )


def _demo_spheres(device=None) -> UnitSpheres:
    w, sr = WALL_RADIUS, SPHERE_RADIUS
    left_m = trs_matrix(translation=(-w * 0.45, -w + sr + 0.1, -w * 0.2), scale=(sr, sr, sr), device=device)
    right_m = trs_matrix(translation=(w * 0.45, -w + sr + 0.1, -w * 0.2), scale=(sr, sr, sr), device=device)
    return UnitSpheres(
        inv_matrix=torch.stack([invert_rigid(left_m), invert_rigid(right_m)]),
        color=torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]], dtype=torch.float32, device=device),
        mat_type=torch.tensor(np.array([CLEARCOAT_DIFFUSE, METAL], np.int32), device=device),
    )


def gltf_scene(mesh: TriangleMesh, quad_light_plane: int = 6, quad_light_radius: float = 50.0,
               device=None) -> Scene:
    """Cornell box + quad light + two spheres + the BVH mesh (glTF demo)."""
    rows = cornell_walls_rows()
    rows.append(quad_light_rows(quad_light_plane, quad_light_radius))
    scene = Scene(quads=quads_from_rows(rows), spheres=_demo_spheres(), mesh=mesh)
    return scene if device is None else scene.to(device)


def hdri_scene(mesh: TriangleMesh, hdr_image, hdr_exposure: float = 1.0, sun_power: float = 4.0,
               sun_direction: Optional[np.ndarray] = None, device=None) -> Scene:
    """Open box + two spheres + the mesh + an equirect environment (HDRI
    demo).  ``sun_direction`` defaults to the brightest-texel estimate; the
    env-NEE CDF tables are built from the map."""
    w = WALL_RADIUS
    rows = [
        make_quad((0, 0, 1), (-w, w, w), (w, w, w), (w, -w, w), (-w, -w, w), (1, 1, 1), DIFFUSE),
        make_quad((1, 0, 0), (-w, -w, w), (-w, -w, -w), (-w, w, -w), (-w, w, w), (0.7, 0.05, 0.05), DIFFUSE),
        make_quad((-1, 0, 0), (w, -w, -w), (w, -w, w), (w, w, w), (w, w, -w), (0.05, 0.05, 0.7), DIFFUSE),
        make_quad((0, 1, 0), (-w, -w, w), (w, -w, w), (w, -w, -w), (-w, -w, -w), (1, 1, 1), DIFFUSE),
    ]
    hdr = np.asarray(hdr_image.cpu() if isinstance(hdr_image, torch.Tensor) else hdr_image, np.float32)
    if sun_direction is None:
        sun_direction = sun_direction_from_hdr(hdr)
    env = Environment(
        sun_direction=torch.as_tensor(np.asarray(sun_direction, np.float32)),
        sun_power=torch.tensor(sun_power, dtype=torch.float32),
        hdr_image=torch.as_tensor(hdr),
        hdr_exposure=torch.tensor(hdr_exposure, dtype=torch.float32),
        env_cdf=build_env_cdf(hdr),
    )
    scene = Scene(quads=quads_from_rows(rows), spheres=_demo_spheres(), mesh=mesh, env=env)
    return scene if device is None else scene.to(device)


def gltf_camera(device=None) -> Camera:
    """The glTF demo's start camera."""
    return Camera.look(position=(0.0, -20.0, -120.0), fov=0.8, focus_distance=113.0, device=device)


def hdri_camera(device=None) -> Camera:
    """The HDRI demo's start camera."""
    return Camera.look(position=(0.0, 0.0, -200.0), fov=0.8, focus_distance=113.0, device=device)


def heightfield_model(n_side: int = 512, rugged: bool = False) -> GLTFModel:
    """The heightfield of ``bench.py``'s capacity cell: 2 * n_side² triangles
    over [-45, 45]² at y = -20 + 4 sin(0.4 x) cos(0.3 z) (524,288 at the
    default n_side), with flat vertex normals and no UVs.  ``rugged`` adds
    the multi-octave displacement and the vertex jitter of ``--rugged``."""
    xs = np.linspace(-45, 45, n_side + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = -20.0 + 4.0 * np.sin(X * 0.4) * np.cos(Z * 0.3)
    if rugged:
        rng = np.random.default_rng(3)
        Y = Y + 2.0 * np.sin(X * 2.3 + Z * 1.7) * np.cos(Z * 2.9) \
              + 0.8 * np.sin(X * 9.1) * np.sin(Z * 8.3) \
              + rng.normal(0, 0.35, Y.shape)
        X = X + rng.normal(0, 0.03, X.shape)
        Z = Z + rng.normal(0, 0.03, Z.shape)
    P = np.stack([X, Y, Z], -1).astype(np.float32)
    a = P[:-1, :-1].reshape(-1, 3)
    b = P[1:, :-1].reshape(-1, 3)
    c = P[1:, 1:].reshape(-1, 3)
    d = P[:-1, 1:].reshape(-1, 3)
    p0 = np.concatenate([a, a])
    p1 = np.concatenate([c, d])
    p2 = np.concatenate([b, c])
    T = len(p0)
    n = np.cross(p1 - p0, p2 - p0)
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-9
    z2 = np.zeros((T, 2), np.float32)
    return GLTFModel(p0=p0, p1=p1, p2=p2, n0=n, n1=n, n2=n, uv0=z2, uv1=z2, uv2=z2, albedo=None,
                     normal_map=None, metallic_roughness=None, emissive=None)
