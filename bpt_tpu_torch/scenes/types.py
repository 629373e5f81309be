"""Material ids and scene containers (port of ``bpt_tpu.scenes.types``).

Containers are NamedTuples of tensors with the reference's field names:
quads, unit spheres, the transformed-quadric set, the triangle mesh with
its binary BVH and its PBR texture maps, and the sun / sky / HDRI
environment.  The TPU packs of the reference's ``TriangleMesh`` (``pk_*``,
``fz_*``, ``*_q``) are not carried: they exist because the TPU kernels
cannot gather per lane.  In their place a mesh on a CUDA device carries the
CUDA kernel's node, triangle, normal and UV tables (``MeshTables``),
made by ``Scene.to``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from bpt_tpu_torch.geometry.triangles import _version

# Material type ids (the reference's enum values).  Only the ids the ported
# families dispatch on are carried; PBR_MATERIAL is a textured mesh's, decided
# per texel into DIFFUSE, CLEARCOAT_DIFFUSE or METAL.
LIGHT = 0
DIFFUSE = 1
TRANSPARENT = 2
METAL = 3
CLEARCOAT_DIFFUSE = 4
PBR_MATERIAL = 10


class Quads(NamedTuple):
    """Quad list; the light is one of these (``IntegratorConfig.light_index``)."""

    normal: torch.Tensor  # (N, 3)
    v0: torch.Tensor  # (N, 3)
    v1: torch.Tensor  # (N, 3)
    v2: torch.Tensor  # (N, 3)
    v3: torch.Tensor  # (N, 3)
    color: torch.Tensor  # (N, 3) — emission radiance for LIGHT-typed quads
    mat_type: torch.Tensor  # (N,) int32


class UnitSpheres(NamedTuple):
    """Unit spheres instanced by inverse object matrices."""

    inv_matrix: torch.Tensor  # (N, 4, 4)
    color: torch.Tensor  # (N, 3)
    mat_type: torch.Tensor  # (N,) int32


class Quadrics(NamedTuple):
    """The transformed-quadric-geometry shape set: one entry per shape in the
    fixed order of ``geometry.quadrics.UNIT_INTERSECTORS``; ``shape_k`` is
    the shared shape parameter (uShapeK)."""

    inv_matrix: torch.Tensor  # (12, 4, 4)
    shape_k: torch.Tensor  # 0-d
    color: torch.Tensor  # (12, 3)
    mat_type: torch.Tensor  # (12,) int32


class MeshTables(NamedTuple):
    """A mesh's tables in the layout of the CUDA kernels (csrc/bvh.cuh,
    csrc/textures.cuh), float32.  ``nodes`` holds the BVH as child-pair
    records of 64 bytes (``child_pair_nodes``): record 0 a header with the
    root's box and reference, then one record per inner node with both
    children's boxes and references, so that the walk reads one record per
    inner step and none at a leaf.  A triangle is three 16-byte records, one
    vertex each, a normal record its three vertex normals.  A textured mesh
    (an albedo or a normal map) adds its 24-byte UV record (uv0, uv1, uv2);
    the kernel reads the maps from a texel table of their own, made once per
    map set (``kernels/launch_args.py`` ``texel_table_of``).
    ``source`` holds the soup and BVH tensors the tables were made from
    (references, no copy), each with its version counter then, so that
    tables that no longer match their mesh, replaced or edited in place, are
    never used; tables made from inference tensors, which keep no version
    counter, are used by no later call."""

    nodes: torch.Tensor  # (R, 4, 4): R = T for a BVH of one triangle per leaf
    tris: torch.Tensor  # (T, 3, 4)
    normals: torch.Tensor  # (T, 3, 4)
    uvs: Optional[torch.Tensor] = None  # (T, 3, 2)
    source: tuple = ()


class TriangleMesh(NamedTuple):
    """De-indexed triangle soup in model space plus its flat binary BVH.

    BVH layout: node i's left child is node i + 1; ``node_tri`` >= 0 marks a
    leaf holding that triangle, -1 an inner node whose right child is
    ``node_right[i]``.  The PBR maps are (H, W, 3) float32, sRGB-encoded (the
    integrator decodes pow(x, 2.2) per sample), v = 0 at row 0, or None; a
    mesh with an albedo is PBR_MATERIAL, decided per texel.
    ``kernel_tables`` holds ``mesh_tables(mesh)`` once ``Scene.to`` has put
    the mesh on a CUDA device, else None; it is made from the soup and the
    BVH, and a mesh whose soup or BVH tensors were replaced or edited in
    place since then gets new tables (``kernel_tables_of``; the transform, the material and the
    maps are read on every call)."""

    p0: torch.Tensor  # (T, 3) float32
    p1: torch.Tensor
    p2: torch.Tensor
    n0: torch.Tensor  # (T, 3) unit vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # (T, 2); (-1, -1) when the model has no UVs
    uv1: torch.Tensor
    uv2: torch.Tensor
    node_tri: torch.Tensor  # (M,) int32: triangle id for leaves, -1 for inner nodes
    node_right: torch.Tensor  # (M,) int32: right-child id of inner nodes
    node_min: torch.Tensor  # (M, 3) float32
    node_max: torch.Tensor  # (M, 3) float32
    inv_matrix: torch.Tensor  # (4, 4) world -> object
    mat_type: torch.Tensor  # 0-d int32, the model's uniform material
    albedo: Optional[torch.Tensor] = None  # (H, W, 3) each
    normal_map: Optional[torch.Tensor] = None
    metallic_roughness: Optional[torch.Tensor] = None
    emissive: Optional[torch.Tensor] = None
    kernel_tables: Optional[MeshTables] = None


#: The PBR maps of a TriangleMesh, in the kernel's order (csrc/textures.cuh).
MAP_FIELDS = ("albedo", "normal_map", "metallic_roughness", "emissive")


def is_textured(mesh) -> bool:
    """Whether the mesh runs the kernel's textured configuration: it has an
    albedo (PBR) or a normal map."""
    return mesh is not None and (mesh.albedo is not None or mesh.normal_map is not None)


#: The TriangleMesh fields the kernel tables are made from.
TABLE_SOURCE_FIELDS = ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "node_tri", "node_right", "node_min",
                       "node_max")


def child_pair_nodes(node_tri, node_right, node_min, node_max) -> torch.Tensor:
    """The flat BVH (pre-order, left child i + 1, ``node_tri`` >= 0 at a
    leaf) as the walk's child-pair records, (R, 4, 4) float32 on its device,
    R = 1 + the inner nodes.  A reference names an inner node by its record
    (>= 1, the inner nodes numbered in pre-order) and a leaf by -1 - its
    triangle (< 0).  Record 0 is the header, (root.min.xyz, root ref),
    (root.max.xyz, 0), zeros; the record of an inner node is (left.min.xyz,
    left ref), (left.max.xyz, right ref), (right.min.xyz, 0), (right.max.xyz,
    0).  The boxes are the builder's rows bit for bit and the references
    int32 bits in the fourth lanes: the records are built as int32, so no id
    passes through float arithmetic."""
    tri = node_tri.to(torch.int64)
    inner = tri < 0
    ref = torch.where(inner, torch.cumsum(inner.to(torch.int64), 0), -1 - tri).to(torch.int32)
    lo = node_min.to(torch.float32).contiguous().view(torch.int32)
    hi = node_max.to(torch.float32).contiguous().view(torch.int32)
    parent = torch.nonzero(inner).squeeze(1)
    left, right = parent + 1, node_right.to(torch.int64)[parent]
    none = torch.zeros_like(left, dtype=torch.int32)

    def row(box, i, w):
        return torch.cat([box[i], w[:, None]], dim=1)

    head = torch.zeros((1, 4, 4), dtype=torch.int32, device=tri.device)
    head[0, 0, :3], head[0, 0, 3], head[0, 1, :3] = lo[0], ref[0], hi[0]
    records = torch.stack([row(lo, left, ref[left]), row(hi, left, ref[right]), row(lo, right, none),
                           row(hi, right, none)], dim=1)
    return torch.cat([head, records]).view(torch.float32)


def mesh_tables(mesh: TriangleMesh) -> MeshTables:
    """The CUDA kernels' tables of ``mesh``, on the mesh's device (84 MB for
    a 524,288-triangle mesh, 33.55 MB of them node records; a textured one
    adds 12.6 MB of UV records)."""
    def rows(xyz, w):  # built as int32 bits, as the node records are
        return torch.cat([xyz.to(torch.float32).contiguous().view(torch.int32), w.to(torch.int32)[:, None]], dim=1)

    zeros = torch.zeros(mesh.p0.shape[0], dtype=torch.int32, device=mesh.p0.device)
    nodes = child_pair_nodes(mesh.node_tri, mesh.node_right, mesh.node_min, mesh.node_max)
    tris = torch.stack([rows(p, zeros) for p in (mesh.p0, mesh.p1, mesh.p2)], dim=1).view(torch.float32)
    normals = torch.stack([rows(n, zeros) for n in (mesh.n0, mesh.n1, mesh.n2)], dim=1).view(torch.float32)
    tables = MeshTables(nodes, tris, normals,
                        source=tuple((t, _version(t)) for t in (getattr(mesh, f) for f in TABLE_SOURCE_FIELDS)))
    if not is_textured(mesh):
        return tables
    uvs = torch.stack([mesh.uv0, mesh.uv1, mesh.uv2], dim=1).to(torch.float32).contiguous()
    return tables._replace(uvs=uvs)


def check_walk_tables(tables: MeshTables) -> None:
    """Raise ValueError unless ``tables`` hold what csrc/bvh.cuh's walk reads:
    (R, 4, 4) node records, R >= 1, and (T, 3, 4) triangle records, T = R
    (one triangle per leaf), contiguous, fewer than 2**29 of each (the
    kernel's int offsets)."""
    nodes, tris = tables.nodes, tables.tris
    if nodes.dim() != 3 or tuple(nodes.shape[1:]) != (4, 4) or tris.dim() != 3 or tuple(tris.shape[1:]) != (3, 4):
        raise ValueError(f"node and triangle records must be (R, 4, 4) and (T, 3, 4), got {tuple(nodes.shape)} and "
                         f"{tuple(tris.shape)}")
    if not 1 <= nodes.shape[0] == tris.shape[0] < 2 ** 29:
        raise ValueError(f"{nodes.shape[0]} node records for {tris.shape[0]} triangles: a BVH of one triangle per "
                         f"leaf has one record per triangle (the header and T - 1 inner nodes), fewer than 2**29")
    if not (nodes.is_contiguous() and tris.is_contiguous()):
        raise ValueError("node and triangle records must be contiguous")


def resident_tables(mesh: TriangleMesh) -> Optional[MeshTables]:
    """The mesh's ``kernel_tables`` if they were made from the soup and BVH
    tensors it holds now, unedited since (and carry the UV records a
    textured mesh needs), else None: always None where a source tensor has
    no version (an inference tensor, ``geometry.triangles._version``)."""
    tables = mesh.kernel_tables
    if tables is None or len(tables.source) != len(TABLE_SOURCE_FIELDS):
        return None
    if not all(v is not None and t is getattr(mesh, f) and v == _version(t)
               for (t, v), f in zip(tables.source, TABLE_SOURCE_FIELDS)):
        return None
    return None if is_textured(mesh) and tables.uvs is None else tables


def kernel_tables_of(mesh: TriangleMesh) -> MeshTables:
    """The mesh's resident tables, or tables made for this call."""
    tables = resident_tables(mesh)
    return mesh_tables(mesh) if tables is None else tables


class Environment(NamedTuple):
    """Sun / sky / HDRI light parameters.  Which pieces are used is decided
    by the static IntegratorConfig."""

    sun_direction: torch.Tensor  # (3,) unit, pointing toward the sun
    sun_power: torch.Tensor  # 0-d (uSunPower)
    hdr_image: Optional[torch.Tensor] = None  # (H, W, 3) float32 equirect
    hdr_exposure: Optional[torch.Tensor] = None  # 0-d (uHDRExposure)
    env_cdf: Optional[tuple] = None  # env.EnvCDF (row_cdf, col_cdf, pdf), for nee "env"


class Scene(NamedTuple):
    """Everything the integrator needs."""

    quads: Optional[Quads] = None
    spheres: Optional[UnitSpheres] = None
    quadrics: Optional[Quadrics] = None
    mesh: Optional[TriangleMesh] = None
    env: Optional[Environment] = None

    def to(self, device) -> "Scene":
        """Every family that is set, on ``device``, field by field and into
        nested tuples (the environment's CDF tables); a host number in a 0-d
        field becomes a float32 tensor (``shape_k``, ``sun_power``,
        ``hdr_exposure``), or int32 for ``mat_type``.  On a CUDA device a mesh
        keeps its kernel tables where its soup and BVH were already there and
        the tables were made from them (an inverse-rendering step moves the
        scene every step: 84 MB of tables for a 524,288-triangle mesh), and
        gets new ones otherwise, except where a source tensor keeps no
        version (an inference tensor): no cache serves such tables, so each
        launch makes its own; elsewhere they are dropped."""

        def field(t, name):
            if t is None or name == "kernel_tables":
                return None
            if isinstance(t, torch.Tensor):
                return t.to(device)
            if isinstance(t, tuple):
                return type(t)(*(field(x, name) for x in t)) if hasattr(t, "_fields") else tuple(
                    field(x, name) for x in t)
            dtype = torch.int32 if name == "mat_type" else torch.float32
            return torch.as_tensor(np.asarray(t), dtype=dtype, device=device)

        def move(group):
            return None if group is None else type(group)(*(field(t, n) for n, t in zip(group._fields, group)))

        scene = Scene(*(move(group) for group in self))
        if scene.mesh is not None and torch.device(device).type == "cuda":
            mesh = scene.mesh._replace(kernel_tables=self.mesh.kernel_tables)
            tables = resident_tables(mesh)
            if tables is None and all(_version(getattr(mesh, f)) is not None for f in TABLE_SOURCE_FIELDS):
                tables = mesh_tables(mesh)
            scene = scene._replace(mesh=mesh._replace(kernel_tables=tables))
        return scene


def make_quad(normal, v0, v1, v2, v3, color, mat_type):
    """Row constructor for numpy-side scene assembly."""
    return (
        np.asarray(normal, np.float32),
        np.asarray(v0, np.float32),
        np.asarray(v1, np.float32),
        np.asarray(v2, np.float32),
        np.asarray(v3, np.float32),
        np.asarray(color, np.float32),
        np.int32(mat_type),
    )


def quads_from_rows(rows, device=None) -> Quads:
    cols = list(zip(*rows))
    return Quads(*(torch.as_tensor(np.stack(c), device=device) for c in cols))
