"""The ``gltf_textured`` configuration: the glTF-model demo with a textured
PBR mesh at the reference's capacity (``gltf_textured.json`` holds its
sizes).

The DamagedHelmet is not in the repository, so the mesh is the capacity
heightfield (2 x 512^2 = 524,288 triangles over [-45, 45]^2 at y = -20 +
4 sin(0.4 x) cos(0.3 z), flat vertex normals; a frozen copy of
``bpt_tpu_torch/scenes/gltf_scene.py`` ``heightfield_model`` at commit
930457f) with planar UVs tiled 4x, and four 2048^2 maps made on the device
from the seed (the structure of ``chip_smoke.py`` ``textured_stand_in`` at
commit 930457f): a smooth albedo, a bump normal map, a metallic-roughness
map of 8x8-texel cells (a heightfield triangle spans about 16 texels, so
classes change inside triangles), each cell DIFFUSE, CLEARCOAT_DIFFUSE or
METAL with a roughness that varies across it, and an emissive map with 3%
of its cells lit.  The inverse problem of its train cells is the albedo,
downsampled to ``tex_size``^2 as ``apps/inverse_rendering.recover_albedo``
does.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.bvh import build_bvh
from benchmark.reference.scenes.cornell import cornell_scene
from benchmark.reference.scenes.types import DIFFUSE, Scene, TriangleMesh
from benchmark.reference.utils.transforms import invert_rigid, trs_matrix

SOUP = ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2")
MAPS = ("albedo", "normal_map", "metallic_roughness", "emissive")


def heightfield(n_side: int) -> dict:
    """The heightfield's de-indexed soup, float32 numpy arrays."""
    xs = np.linspace(-45, 45, n_side + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = -20.0 + 4.0 * np.sin(X * 0.4) * np.cos(Z * 0.3)
    P = np.stack([X, Y, Z], -1).astype(np.float32)
    a = P[:-1, :-1].reshape(-1, 3)
    b = P[1:, :-1].reshape(-1, 3)
    c = P[1:, 1:].reshape(-1, 3)
    d = P[:-1, 1:].reshape(-1, 3)
    p0, p1, p2 = np.concatenate([a, a]), np.concatenate([c, d]), np.concatenate([b, c])
    n = np.cross(p1 - p0, p2 - p0)
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-9

    def uv(p):
        return np.stack([(p[:, 0] + 45.0) / 90.0 * 4.0 - 0.5, (p[:, 2] + 45.0) / 90.0 * 4.0 - 0.3],
                        -1).astype(np.float32)

    return {"p0": p0, "p1": p1, "p2": p2, "n0": n, "n1": n, "n2": n, "uv0": uv(p0), "uv1": uv(p1), "uv2": uv(p2)}


def pbr_maps(size: int, cell: int, lit_share: float, seed: int, device) -> dict:
    """The four (size, size, 3) float32 maps on ``device``; the cells'
    classes, roughness, metalness and lit cells drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device)
    t = (torch.arange(size, **f32) + 0.5) / size
    x, y = t[None, :], t[:, None]  # columns u, rows v
    two_pi = 2.0 * np.pi
    ones = torch.ones((size, size), **f32)
    albedo = torch.stack([0.55 + 0.3 * torch.sin(two_pi * (3 * x + 2 * y)),
                          0.5 + 0.3 * torch.cos(two_pi * (2 * x - 5 * y)),
                          0.45 + 0.25 * torch.sin(two_pi * 7 * x) * torch.cos(two_pi * 4 * y)], -1)
    normal = torch.stack([0.5 + 0.3 * torch.sin(two_pi * 96 * x) * torch.cos(two_pi * 64 * y),
                          0.5 + 0.3 * torch.cos(two_pi * 80 * x + 1.0) * torch.sin(two_pi * 112 * y), ones], -1)
    cells = size // cell
    draws = torch.rand((4, cells, cells), generator=gen, **f32)

    def blocks(v):
        return v.repeat_interleave(cell, 0).repeat_interleave(cell, 1)

    cls = blocks(torch.floor(draws[0] * 3.0).clamp(max=2.0))
    rough = blocks(0.05 + 0.85 * draws[1]) * (0.75 + 0.25 * torch.sin(two_pi * 512 * x))
    metal = blocks(0.5 + 0.5 * draws[2])
    zero = torch.zeros_like(ones)
    metal_rough = torch.stack([zero, torch.where(cls >= 1, rough, zero), torch.where(cls == 2, metal, zero)], -1)
    lit = blocks((draws[3] < lit_share).to(torch.float32)) > 0
    emissive = torch.where(lit[..., None], torch.tensor([0.9, 0.7, 0.4], **f32), torch.zeros((), **f32))
    maps = {"albedo": albedo, "normal_map": normal, "metallic_roughness": metal_rough, "emissive": emissive}
    return {k: v.expand(size, size, 3).contiguous() for k, v in maps.items()}


def make_inputs(spec: dict, seed: int, device) -> dict:
    """The walls, light and spheres and the soup on the host, the maps on
    ``device``."""
    s = spec["scene"]
    walls = cornell_scene(quad_light_plane=s["quad_light_plane"], quad_light_radius=s["quad_light_radius"])
    return {"walls": walls, "soup": heightfield(s["heightfield_side"]),
            "maps": pbr_maps(s["map_size"], s["map_cell"], s["lit_share"], seed, device),
            "inv_matrix": invert_rigid(trs_matrix())}


def reference_scene(inputs: dict, device):
    """The reference's scene: the same soup and maps, its own BVH."""
    soup = {k: torch.as_tensor(v, device=device) for k, v in inputs["soup"].items()}
    bvh = build_bvh(soup["p0"], soup["p1"], soup["p2"])
    mesh = TriangleMesh(**soup, node_tri=bvh.node_tri, node_right=bvh.node_right, node_min=bvh.node_min,
                        node_max=bvh.node_max, inv_matrix=inputs["inv_matrix"].to(device),
                        mat_type=torch.tensor(DIFFUSE, dtype=torch.int32, device=device), **inputs["maps"])
    walls = inputs["walls"].to(device)
    return Scene(quads=walls.quads, spheres=walls.spheres, mesh=mesh)


def program_scene(inputs: dict, device):
    """The port's scene, as ``recover_albedo`` and the glTF app build it:
    ``mesh_from_model`` (the port's native SAH build) and ``Scene.to`` (its
    kernel tables)."""
    from bpt_tpu_torch.io.gltf import GLTFModel
    from bpt_tpu_torch.scenes.gltf_scene import mesh_from_model
    from bpt_tpu_torch.scenes.types import Scene as PortScene

    from benchmark.sides import to_port

    maps = {k: v.cpu().numpy() for k, v in inputs["maps"].items()}
    model = GLTFModel(**inputs["soup"], **maps)
    mesh = mesh_from_model(model, mat_type=DIFFUSE, use_native="require" if torch.device(device).type == "cuda"
                           else "auto")
    walls = to_port(inputs["walls"])
    return PortScene(quads=walls.quads, spheres=walls.spheres, mesh=mesh).to(device)


def apply(scene, params: dict):
    """The scene with the mesh's albedo map replaced by ``params["albedo"]``."""
    return scene._replace(mesh=scene.mesh._replace(albedo=params["albedo"]))


def train_values(spec: dict, inputs: dict, device) -> tuple[dict, dict]:
    """(true parameters, initial parameters): the albedo downsampled to
    ``tex_size``^2 as ``recover_albedo`` does, and grey ``init``."""
    t = spec["train"]["tex_size"]
    albedo = inputs["maps"]["albedo"]
    h, w = albedo.shape[:2]
    true = albedo[:: max(h // t, 1), :: max(w // t, 1)][:t, :t].contiguous().to(device)
    return {"albedo": true}, {"albedo": torch.full_like(true, float(spec["train"]["init"]))}
