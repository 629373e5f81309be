"""Minimal glTF 2.0 / GLB reader: a de-indexed triangle soup and its PBR
textures, numpy and the standard library only.

A copy of ``GLTFModel``, ``load_gltf`` (with their helpers) and
``describe_gltf`` from ``bpt_tpu.io.gltf``, which cannot be imported without
jax.  Every mesh primitive of the default scene is merged into one soup;
node transforms are baked into the vertices; RH -> LH by negating z; a
uniform initial scale; the four PBR textures of the first textured material
(or of ``material_index``), decoded by PIL (imported only when a model has
images) into (H, W, 3) float32 sRGB-encoded maps that
``scenes.gltf_scene.mesh_from_model`` carries to the renderer.
``describe_gltf`` dumps a file's meshes and materials for the loading
debugger.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import NamedTuple, Optional

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GLTFModel(NamedTuple):
    """De-indexed triangle soup in model space (already LH, pre-scaled)."""

    p0: np.ndarray  # (T, 3) float32
    p1: np.ndarray
    p2: np.ndarray
    n0: np.ndarray  # (T, 3)
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray  # (T, 2); (-1,-1) rows when the mesh has no UVs
    uv1: np.ndarray
    uv2: np.ndarray
    albedo: Optional[np.ndarray]  # (H, W, 3) float32 in [0,1], sRGB-encoded
    normal_map: Optional[np.ndarray]
    metallic_roughness: Optional[np.ndarray]
    emissive: Optional[np.ndarray]

    @property
    def triangle_count(self) -> int:
        return self.p0.shape[0]


def _read_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    assert magic == 0x46546C67, "not a GLB file"
    offset = 12
    gltf_json = None
    bin_chunk = None
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8 : offset + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # JSON
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # BIN
            bin_chunk = chunk
        offset += 8 + chunk_len
    return gltf_json, bin_chunk


def _load_buffers(gltf: dict, base_dir: str, glb_bin: Optional[bytes]):
    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(glb_bin)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
    return buffers


def _read_accessor(gltf: dict, buffers, accessor_idx: int) -> np.ndarray:
    acc = gltf["accessors"][accessor_idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    buf = buffers[view["buffer"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    n_comp = _TYPE_SIZES[acc["type"]]
    count = acc["count"]
    item = np.dtype(dtype).itemsize * n_comp
    stride = view.get("byteStride", item)
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    if stride == item:
        arr = np.frombuffer(buf, dtype=dtype, count=count * n_comp, offset=start)
        arr = arr.reshape(count, n_comp)
    else:
        raw = np.frombuffer(buf, dtype=np.uint8)
        rows = np.stack(
            [raw[start + i * stride : start + i * stride + item] for i in range(count)]
        )
        arr = rows.view(dtype).reshape(count, n_comp)
    return arr


def _node_world_matrices(gltf: dict) -> dict:
    """Flatten the node hierarchy into per-node world matrices (column-vector
    convention, RH glTF space)."""

    def local_matrix(node: dict) -> np.ndarray:
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        if "scale" in node:
            m[:3, :3] *= np.asarray(node["scale"], np.float64)
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            r = np.array(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                ]
            )
            m = np.block([[r @ m[:3, :3], np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]])
        if "translation" in node:
            m[:3, 3] = node["translation"]
        return m

    world = {}

    def walk(idx: int, parent: np.ndarray):
        node = gltf["nodes"][idx]
        m = parent @ local_matrix(node)
        world[idx] = m
        for child in node.get("children", []):
            walk(child, m)

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    for root in scene.get("nodes", range(len(gltf.get("nodes", [])))):
        walk(root, np.eye(4))
    # Nodes not reachable from the scene (rare) get identity.
    for idx in range(len(gltf.get("nodes", []))):
        world.setdefault(idx, np.eye(4))
    return world


def _decode_image(gltf: dict, buffers, base_dir: str, image_idx: int) -> Optional[np.ndarray]:
    """Decode an image to (H, W, 3/4) float32 in [0,1]; None if undecodable."""
    import io as _io

    img = gltf["images"][image_idx]
    data = None
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            path = os.path.join(base_dir, uri)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    data = f.read()
    elif "bufferView" in img:
        view = gltf["bufferViews"][img["bufferView"]]
        buf = buffers[view["buffer"]]
        start = view.get("byteOffset", 0)
        data = buf[start : start + view["byteLength"]]
    if data is None:
        return None
    try:
        from PIL import Image
    except ImportError:
        return None
    with Image.open(_io.BytesIO(data)) as im:
        arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return arr


def load_gltf(
    path: str,
    initial_scale: float = 1.0,
    flip_z: bool = True,
    material_index: int | None = None,
) -> GLTFModel:
    """Read a .gltf/.glb file into a merged, de-indexed triangle soup.

    `initial_scale` is the per-model magnification the reference applies
    during packing (modelInitialScale, GLTF_Model_Path_Tracing.js:900-924);
    `flip_z=True` performs the RH→LH conversion (negate z of positions and
    normals, :346-365), which also flips triangle winding — matching the
    reference, which leaves vertex order unchanged.

    `material_index`, when set, takes the PBR texture set from that material
    and force-shares it across the whole merged model — the debugging demo's
    behavior of applying one mesh's albedo to everything
    (Debugging_GLTF_Loading.js:227-255).  Default: first material with a
    base-color texture, as in the main glTF demo.
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        raw = f.read()
    if head == b"glTF":
        gltf, glb_bin = _read_glb(raw)
    else:
        gltf = json.loads(raw.decode("utf-8"))
        glb_bin = None
    buffers = _load_buffers(gltf, base_dir, glb_bin)
    world = _node_world_matrices(gltf)

    positions, normals, uvs = [], [], []
    for node_idx, node in enumerate(gltf.get("nodes", [])):
        if "mesh" not in node:
            continue
        m = world[node_idx]
        nrm_m = np.linalg.inv(m[:3, :3]).T
        mesh = gltf["meshes"][node["mesh"]]
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:  # TRIANGLES only
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(gltf, buffers, attrs["POSITION"]).astype(np.float64)
            if "indices" in prim:
                idx = _read_accessor(gltf, buffers, prim["indices"]).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(pos.shape[0])
            pos = (pos @ m[:3, :3].T) + m[:3, 3]
            if "NORMAL" in attrs:
                nrm = _read_accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float64)
                nrm = nrm @ nrm_m.T
            else:
                nrm = np.zeros_like(pos)
                # face normals filled in after de-indexing below
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(gltf, buffers, attrs["TEXCOORD_0"]).astype(np.float64)
                if uv.dtype != np.float64 or uv.shape[1] != 2:
                    uv = uv.reshape(-1, 2)
            else:
                # Missing-UV sentinel (-1, -1), cf. Debugging_GLTF_Loading.js.
                uv = np.full((pos.shape[0], 2), -1.0)
            positions.append(pos[idx])
            normals.append(nrm[idx])
            uvs.append(uv[idx])

    pos = np.concatenate(positions, axis=0)
    nrm = np.concatenate(normals, axis=0)
    uv = np.concatenate(uvs, axis=0)
    assert pos.shape[0] % 3 == 0, "non-triangle vertex count"

    pos = pos * initial_scale
    if flip_z:
        pos[:, 2] *= -1.0
        nrm[:, 2] *= -1.0

    pos = pos.reshape(-1, 3, 3)
    nrm = nrm.reshape(-1, 3, 3)
    uv = uv.reshape(-1, 3, 2)

    # Keep triangle winding consistent with the vertex normals: a mirror
    # (the z-flip, or a negative-determinant node matrix) inverts
    # cross(e1, e2) relative to the transformed normals, which would make
    # single-sided backface culling keep the *inside* faces.  Swap v1/v2 on
    # triangles whose geometric normal opposes their average vertex normal.
    geo_n = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    avg_n = nrm.sum(axis=1)
    flip_tris = (geo_n * avg_n).sum(-1) < 0.0
    has_normals = np.linalg.norm(avg_n, axis=-1) > 1e-12
    flip_tris = flip_tris & has_normals
    pos[flip_tris] = pos[flip_tris][:, [0, 2, 1]]
    nrm[flip_tris] = nrm[flip_tris][:, [0, 2, 1]]
    uv[flip_tris] = uv[flip_tris][:, [0, 2, 1]]

    # Fill zero normals with face normals (models without NORMAL streams).
    face_n = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    face_len = np.linalg.norm(face_n, axis=-1, keepdims=True)
    face_n = face_n / np.maximum(face_len, 1e-20)
    zero = np.linalg.norm(nrm, axis=-1, keepdims=True) < 1e-12
    nrm = np.where(zero, face_n[:, None, :], nrm)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)

    # PBR textures from the first material that has a base-color texture
    # (the reference shares one texture set across the merged model,
    # GLTF_Model_Path_Tracing.js:252-274).
    albedo = normal_map = metallic_roughness = emissive = None

    def tex_image(tex_idx):
        source = gltf["textures"][tex_idx].get("source")
        return None if source is None else _decode_image(gltf, buffers, base_dir, source)

    all_materials = gltf.get("materials", [])
    if material_index is not None:
        candidates = [all_materials[material_index]]
    else:
        candidates = all_materials
    for mat in candidates:
        pbr = mat.get("pbrMetallicRoughness", {})
        if "baseColorTexture" in pbr and albedo is None:
            albedo = tex_image(pbr["baseColorTexture"]["index"])
            if "metallicRoughnessTexture" in pbr:
                metallic_roughness = tex_image(pbr["metallicRoughnessTexture"]["index"])
            if "normalTexture" in mat:
                normal_map = tex_image(mat["normalTexture"]["index"])
            if "emissiveTexture" in mat:
                emissive = tex_image(mat["emissiveTexture"]["index"])
            break

    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return GLTFModel(
        p0=f32(pos[:, 0]),
        p1=f32(pos[:, 1]),
        p2=f32(pos[:, 2]),
        n0=f32(nrm[:, 0]),
        n1=f32(nrm[:, 1]),
        n2=f32(nrm[:, 2]),
        uv0=f32(uv[:, 0]),
        uv1=f32(uv[:, 1]),
        uv2=f32(uv[:, 2]),
        albedo=albedo,
        normal_map=normal_map,
        metallic_roughness=metallic_roughness,
        emissive=emissive,
    )


def describe_gltf(path: str) -> dict:
    """The asset's meshes (primitives, their material, attributes, indexing,
    mode) and materials (PBR factors, texture indices, doubleSided,
    alphaMode), its image URIs (long data URIs shortened) and node count: the
    loading debugger's dump of mesh and material internals."""
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] == b"glTF":
        gltf, _ = _read_glb(raw)
    else:
        gltf = json.loads(raw.decode("utf-8"))
    meshes = []
    for i, mesh in enumerate(gltf.get("meshes", [])):
        prims = [{"material": prim.get("material"), "attributes": sorted(prim.get("attributes", {})),
                  "indexed": "indices" in prim, "mode": prim.get("mode", 4)}
                 for prim in mesh.get("primitives", [])]
        meshes.append({"name": mesh.get("name", f"mesh{i}"), "primitives": prims})
    materials = []
    for i, mat in enumerate(gltf.get("materials", [])):
        pbr = mat.get("pbrMetallicRoughness", {})
        materials.append({
            "name": mat.get("name", f"material{i}"),
            "baseColorFactor": pbr.get("baseColorFactor"),
            "baseColorTexture": pbr.get("baseColorTexture", {}).get("index"),
            "metallicFactor": pbr.get("metallicFactor"),
            "roughnessFactor": pbr.get("roughnessFactor"),
            "metallicRoughnessTexture": pbr.get("metallicRoughnessTexture", {}).get("index"),
            "normalTexture": mat.get("normalTexture", {}).get("index"),
            "emissiveTexture": mat.get("emissiveTexture", {}).get("index"),
            "doubleSided": mat.get("doubleSided", False),
            "alphaMode": mat.get("alphaMode", "OPAQUE"),
        })
    return {
        "path": path,
        "base_dir": base_dir,
        "meshes": meshes,
        "materials": materials,
        "images": [(uri[:40] + f"...<{len(uri)} chars>") if len(uri) > 60 else uri
                   for uri in (img.get("uri", "<embedded>") for img in gltf.get("images", []))],
        "nodes": len(gltf.get("nodes", [])),
    }
