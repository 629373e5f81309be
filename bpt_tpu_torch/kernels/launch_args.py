"""The kernels' shared argument block and its packers.

K1 (``csrc/megakernel.cu``) and K2 (``csrc/staged.cu``) take the same
argument block, ``TraceArgs`` of ``csrc/path.cuh`` (K2 wraps it in its
``StagedArgs``): the scene block (the camera, the parameters and the packed
quads, spheres, quadrics and mesh constants, one contiguous float32
tensor), the mesh tables, the maps' texel table, the blue-noise table, the
output planes and the switch of the parallelogram quad test.  ``trace_args`` packs and checks
one launch's block; ``empty_outputs`` / ``outputs_result`` make a launch's
output planes and read them back as a RadianceResult.  Both wrappers
(``kernels/megakernel.py``, ``kernels/staged.py``) import this module, so
the format lives in one place.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict

import numpy as np
import torch

from bpt_tpu_torch import sky
from bpt_tpu_torch.camera import Camera, film_extents
from bpt_tpu_torch.core.sampling import lobe_exponent
from bpt_tpu_torch.core.vecmath import normalize
from bpt_tpu_torch.geometry.triangles import _version, cached_on, parallelogram_constants, resolve_fast_quads
from bpt_tpu_torch.integrator.config import IntegratorConfig
from bpt_tpu_torch.integrator.radiance import RadianceResult, deferred_layout
from bpt_tpu_torch.scenes.types import (MAP_FIELDS, PBR_MATERIAL, Scene, check_walk_tables, is_textured,
                                        kernel_tables_of)
from bpt_tpu_torch.textures import texel_quads

#: The kernel's configurations, as ``configuration`` names them.
CONFIGURATIONS = ("cornell", "quadric", "sky", "mesh", "hdri", "textured")


def configuration(scene: Scene, cfg: IntegratorConfig) -> str:
    """The kernel configuration a call runs: "textured" (a mesh with an
    albedo or a normal map, any environment), "hdri" (env hdri, sun or env
    NEE), "sky" (env sky, sun NEE), "mesh" (env none, quad NEE, a BVH mesh),
    "quadric" (env none, quad NEE, the quadric set) or "cornell"."""
    if is_textured(scene.mesh):
        return "textured"
    if cfg.env in ("hdri", "sky"):
        return cfg.env
    if scene.mesh is not None:
        return "mesh"
    return "quadric" if scene.quadrics is not None else "cornell"


_MAX_QUADS = 256
_MAX_SPHERES = 64
_N_QUADRICS = 12
ENVS = {"none": 0, "sky": 1, "hdri": 2}
NEES = {"quad": 0, "sun": 1, "env": 2}
#: Floats of each part of the scene block (csrc/path.cuh): the camera, the
#: parameter pack, a quad row, a sphere row, a quadric row, the mesh
#: constants.  Every part but the last starts on a 16-byte boundary: the
#: kernels read the rows as float4s.
CAM_FLOATS, PARAM_FLOATS, QUAD_FLOATS, SPHERE_FLOATS, QUADRIC_FLOATS, MESH_FLOATS = 16, 24, 32, 24, 20, 17
#: The quad row's columns: the parallelogram test's constants first
#: (``geometry.triangles.PARALLELOGRAM_COLUMNS``: ng, c0, d1, k1, d3, k3,
#: v0), then the material, the normalized normal, a pad, v1, v2, v3 and
#: the color (csrc/path.cuh kQ*).
QUAD_COLUMNS = {"mat": 15, "n": 16, "v1": 20, "v2": 23, "v3": 26, "color": 29}


class TraceArgs(ctypes.Structure):
    """The kernel's argument block, ``TraceArgs`` of csrc/path.cuh
    (pointers first, then 32-bit fields; the C side reports its size)."""

    _POINTERS = ("scene", "mesh_nodes", "mesh_tris", "mesh_normals", "hdr", "row_cdf", "col_cdf", "env_pdf",
                 "blue_noise", "out_color", "out_normal", "out_ocolor", "out_oid", "out_sharp", "out_sg", "mesh_uvs",
                 "out_def")
    _fields_ = ([(name, ctypes.c_void_p) for name in _POINTERS]
                + [("tex", ctypes.c_void_p * 4)]
                + [(name, ctypes.c_int) for name in ("nq", "ns", "nqd", "bn_ox", "bn_oy", "width", "height", "bounces")]
                + [("eps", ctypes.c_float)]
                + [(name, ctypes.c_int) for name in ("light_index", "diffuse_indirect_max", "camera_is_moving",
                                                     "transparent_tint")]
                + [("frame_u", ctypes.c_uint32), ("frame_f", ctypes.c_float)]
                + [("tex_h", ctypes.c_int * 4), ("tex_w", ctypes.c_int * 4), ("metal_roughness_lobe", ctypes.c_int),
                   ("fast_quads", ctypes.c_int)])


def _quad_geometry(q) -> torch.Tensor:
    """The quad rows without their color, (Nq, 29): made once per quad
    geometry (the vertices, normal and material tensors)."""
    def make():
        with torch.no_grad():
            pad = torch.zeros((q.v0.shape[0], 1), dtype=torch.float32, device=q.v0.device)
            rows = [parallelogram_constants(q), q.mat_type.to(torch.float32)[:, None], normalize(q.normal), pad,
                    q.v1, q.v2, q.v3]
            return torch.cat([r.to(torch.float32) for r in rows], dim=1).contiguous()

    return cached_on((q.v0, q.v1, q.v2, q.v3, q.normal, q.mat_type), "quad rows", make)


def _material_tail(mat_type: torch.Tensor, width: int) -> torch.Tensor:
    """(N, width): the material as float32, then zeros; made once per tensor."""
    def make():
        tail = torch.zeros((mat_type.shape[0], width), dtype=torch.float32, device=mat_type.device)
        tail[:, 0] = mat_type.to(torch.float32)
        return tail

    return cached_on((mat_type,), f"material tail {width}", make)


def pack_scene(scene: Scene) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """Scene -> (quads (Nq, 32), spheres (Ns, 21) or None, quadrics (12, 20)
    or None), float32.

    Quad row (``QUAD_COLUMNS``): the parallelogram test's per-quad algebra
    (``geometry.triangles.parallelogram_constants``: ng, c0, d1, k1, d3,
    k3), v0, mat, the normalized n, a pad, v1, v2, v3, color: 128 bytes.
    Everything but the color is made once per quad geometry; the color,
    which an inverse-rendering step changes, is packed on every call.
    Sphere row: inverse 4x4 row-major (16), color3, mat and 4 pads (96
    bytes).  Quadric row: inverse 4x4 row-major (16), color3, mat.  The
    TPU kernel's ``pack_scene`` holds the same values in 20- and 21-float
    rows (n, v0..v3, color, mat, pad; its spheres as here without the last
    3 pads): the algebra and the pads are this port's.
    """
    q = scene.quads
    quads = torch.cat([_quad_geometry(q), q.color.to(torch.float32)], dim=1)
    sph = qdr = None
    if scene.spheres is not None:
        s = scene.spheres
        sph = torch.cat([s.inv_matrix.reshape(-1, 16), s.color, _material_tail(s.mat_type, 5)], dim=1)
    if scene.quadrics is not None:
        d = scene.quadrics
        qdr = torch.cat([d.inv_matrix.reshape(-1, 16), d.color, _material_tail(d.mat_type, 1)], dim=1)
    return quads, sph, qdr


_PARAMS: dict = {}


def _device_constants(key, make, device) -> torch.Tensor:
    """A small constant tensor made once per device and key: a host-to-device
    copy of pageable memory waits for the stream, so it must not happen on
    every launch."""
    key = (str(device),) + key
    if key not in _PARAMS:
        _PARAMS[key] = make().to(dtype=torch.float32, device=device).contiguous()
    return _PARAMS[key]


def _param_constants(cfg: IntegratorConfig, device) -> torch.Tensor:
    """The parameter pack of a call without quadrics, sun or HDR map, on
    ``device``; its entries 7..18 (the sun lobe, the sun-NEE weight 0.05,
    the sky constants) serve every call."""
    def make():
        rough = torch.clamp(torch.as_tensor(cfg.sun_lobe_roughness, dtype=torch.float32), 0.0, 1.0)
        head = torch.tensor([0.5, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0])
        lobe = torch.stack([lobe_exponent(cfg.sun_lobe_roughness), rough, torch.tensor(0.05)])
        consts = torch.as_tensor(np.concatenate([sky.RAYLEIGH_AT_X, sky.MIE_AT_X, sky.EXTINCTION_SUM]))
        return torch.cat([head, lobe, consts, torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0])])

    return _device_constants(("params", cfg.sun_lobe_roughness), make, device)


def pack_params(scene: Scene, cfg: IntegratorConfig, device) -> torch.Tensor:
    """(24,) float32 on ``device``, the layout of csrc/vec.cuh: shape_k, the
    sun direction, the sun-only sky terms (sun_e, gamma, blend), the sun
    lobe's exponent and roughness, the sun-NEE weight scale (0.05, or
    sun_power² 1e-7 under ``sun_weight_mode="hdri"``), the sky's
    per-channel Rayleigh, Mie and extinction constants, and the HDR map's
    exposure, height and width, then 2 pads.  Every entry is computed by the function
    the plain version calls, so the kernel sees the same floats.  Only
    device work: no copy from the host."""
    params = _param_constants(cfg, device)
    if scene.quadrics is None and cfg.env == "none":
        return params
    f32 = dict(dtype=torch.float32, device=device)
    parts = [params[:1] if scene.quadrics is None else torch.as_tensor(scene.quadrics.shape_k).to(**f32).reshape(1)]
    if cfg.env == "sky":
        sun = scene.env.sun_direction.to(**f32).reshape(3)
        parts += [sun, torch.stack(sky.sky_sun_terms(sun))]
    elif cfg.env == "hdri":
        parts += [scene.env.sun_direction.to(**f32).reshape(3), params[4:7]]
    else:
        parts.append(params[1:7])
    parts.append(params[7:9])
    if cfg.nee == "sun" and cfg.sun_weight_mode == "hdri":
        sp = scene.env.sun_power.to(**f32)
        parts.append((sp * sp * 1.0e-7).reshape(1))
    else:
        parts.append(params[9:10])
    parts.append(params[10:19])
    if cfg.env == "hdri":
        h, w = scene.env.hdr_image.shape[:2]
        parts += [scene.env.hdr_exposure.to(**f32).reshape(1),
                  _device_constants(("hdr shape", h, w), lambda: torch.tensor([float(h), float(w)]), device),
                  params[22:]]
    else:
        parts.append(params[19:])
    return torch.cat(parts).detach().contiguous()


def pack_mesh(mesh):
    """TriangleMesh -> (constants (17,), MeshTables), float32, the layouts of
    csrc/bvh.cuh (child-pair node records) and csrc/textures.cuh.

    Constants: the inverse model matrix row-major and the material
    (PBR_MATERIAL for a mesh with an albedo), made on every call.  The
    tables are the mesh's ``kernel_tables``, made once by ``Scene.to``; a
    mesh that did not pass through it, or whose soup or BVH was replaced
    since, gets them made for this call."""
    mat = torch.full_like(mesh.mat_type, PBR_MATERIAL) if mesh.albedo is not None else mesh.mat_type
    consts = torch.cat([mesh.inv_matrix.reshape(16).to(torch.float32), mat.reshape(1).to(torch.float32)])
    return consts, kernel_tables_of(mesh)


_TEXEL_TABLES: OrderedDict = OrderedDict()
#: Texel tables kept, the least recently used dropped first: a forward and
#: a grads table (without the albedo) for each of two map sets.
_TEXEL_TABLE_SIZE = 4


def texel_table_of(mesh, albedo: bool = True) -> tuple:
    """The texel tables of the mesh's maps in ``MAP_FIELDS`` order
    (``textures.texel_quads``, None for a map the mesh lacks), made once per
    map set on the maps' device.  They are keyed on the map tensors
    themselves and their in-place versions: a map that is replaced or edited
    in place (an optimiser's step on the albedo) is repacked before the next
    launch that reads it, and the set's stale tables are dropped then.  A
    map without a version (an inference tensor, ``triangles._version``) has
    its set packed anew on every call, and not kept.
    ``albedo=False`` (the grads mode, which composes the albedo outside the
    kernel) leaves the albedo out: it is neither packed nor read.  Raises
    ValueError for a map that is not (H, W, 3) or whose table the kernel's
    32-bit offsets cannot address."""
    maps = tuple(None if name == "albedo" and not albedo else getattr(mesh, name) for name in MAP_FIELDS)
    key = tuple(None if t is None else id(t) for t in maps)
    versions = tuple(None if t is None else _version(t) for t in maps)
    unversioned = any(t is not None and v is None for t, v in zip(maps, versions))
    hit = None if unversioned else _TEXEL_TABLES.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], maps)) and hit[1] == versions:
        _TEXEL_TABLES.move_to_end(key)
        return hit[2]
    for name, t in zip(MAP_FIELDS, maps):
        if t is not None and (t.dim() != 3 or t.shape[-1] != 3 or 4 * t.shape[0] * t.shape[1] >= 2 ** 31):
            raise ValueError(f"{name} must be (H, W, 3) with 4 H W below 2**31 (its texel table's 16-byte slots, "
                             f"which the kernel addresses with 32-bit offsets), got {tuple(t.shape)}")
    tables = tuple(None if t is None else texel_quads(t) for t in maps)
    if unversioned:
        return tables
    _TEXEL_TABLES.pop(key, None)
    _TEXEL_TABLES[key] = (maps, versions, tables)
    if len(_TEXEL_TABLES) > _TEXEL_TABLE_SIZE:
        _TEXEL_TABLES.popitem(last=False)
    return tables


def pack_camera(camera: Camera, width: int, height: int) -> torch.Tensor:
    """(16,) float32: position, right, up, forward, ulen, vlen, aperture, focus."""
    ulen, vlen = film_extents(camera, width, height)
    return torch.cat([camera.position, camera.right, camera.up, camera.forward,
                      torch.stack([ulen, vlen, camera.aperture_size, camera.focus_distance])]
                     ).to(torch.float32).contiguous()



def check_tensor(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")



def scene_floats(nq: int, ns: int, nqd: int, mesh: bool) -> int:
    """The scene block's floats (csrc/path.cuh scene_floats)."""
    return (CAM_FLOATS + PARAM_FLOATS + nq * QUAD_FLOATS + ns * SPHERE_FLOATS + nqd * QUADRIC_FLOATS
            + (MESH_FLOATS if mesh else 0))


def trace_args(scene: Scene, camera: Camera, cfg: IntegratorConfig, width: int, height: int,
               blue_noise: torch.Tensor, outputs: dict, film_height: int | None = None,
               fast_quads: bool | None = None) -> tuple:
    """Pack and check one launch's scene, camera and configuration into the
    kernel's argument block, with the output pointers of ``outputs``
    ({"out_color": tensor, ...}; None for a plane the call does not write).
    ``film_height`` is the height of the film the camera maps (the image's
    own unless a pool traces rows of a taller one); ``fast_quads`` switches
    the parallelogram quad test (``geometry.triangles.resolve_fast_quads``).
    The camera, the parameter pack and ``pack_scene``'s rows (and the mesh
    constants) go into one contiguous scene block, made by one
    concatenation.  Returns ``(args, mesh_arg, keep)``: ``keep`` holds the
    packed tensors until the launch is enqueued.  CUDA tensors only."""
    device = blue_noise.device
    if scene.quads is None:
        raise ValueError("the kernel needs at least one quad; a scene without quads runs on the wavefront "
                         "(trace_image)")
    fast_quads = resolve_fast_quads(scene.quads, fast_quads)
    with torch.no_grad():
        quads, sph, qdr = pack_scene(scene)
        cam = pack_camera(camera, width, height if film_height is None else film_height)
        params = pack_params(scene, cfg, device)
        mesh_consts, tables = pack_mesh(scene.mesh) if scene.mesh is not None else (None, None)
    nq = quads.shape[0]
    ns = 0 if sph is None else sph.shape[0]
    nqd = 0 if qdr is None else qdr.shape[0]
    if not 0 < nq <= _MAX_QUADS or ns > _MAX_SPHERES or nqd not in (0, _N_QUADRICS):
        raise ValueError(f"{nq} quads / {ns} spheres / {nqd} quadrics: the kernel takes 1..{_MAX_QUADS} / "
                         f"0..{_MAX_SPHERES} / 0 or {_N_QUADRICS}")
    light = 0
    if cfg.nee == "quad":
        light = cfg.light_index if cfg.light_index >= 0 else nq - 1
        if not 0 <= light < nq:
            raise ValueError(f"light_index {cfg.light_index} out of range for {nq} quads")
    textured = is_textured(scene.mesh)
    grads = outputs.get("out_sg") is not None
    maps = [getattr(scene.mesh, m) if textured and not (grads and m == "albedo") else None for m in MAP_FIELDS]
    env = scene.env if cfg.env == "hdri" else None
    hdr = (None,) * 4 if env is None else (env.hdr_image,) + tuple(env.env_cdf or (None,) * 3)
    if cfg.nee != "env":
        hdr = hdr[:1] + (None,) * 3
    parts = {"camera": cam, "params": params, "quads": quads, "spheres": sph, "quadrics": qdr, "mesh": mesh_consts}
    for key, t in parts.items():
        if t is not None:
            check_tensor(key, t, device)
    with torch.no_grad():
        block = torch.cat([t.reshape(-1) for t in parts.values() if t is not None])
    if block.numel() != scene_floats(nq, ns, nqd, scene.mesh is not None):
        raise ValueError(f"the scene block holds {block.numel()} floats, not the kernel's "
                         f"{scene_floats(nq, ns, nqd, scene.mesh is not None)}")
    tensors = {"blue_noise": blue_noise, "scene": block, "mesh_nodes": None if tables is None else tables.nodes,
               "mesh_tris": None if tables is None else tables.tris,
               "mesh_normals": None if tables is None else tables.normals, "hdr": hdr[0], "row_cdf": hdr[1],
               "col_cdf": hdr[2], "env_pdf": hdr[3], "mesh_uvs": tables.uvs if textured else None}
    for key, t in tensors.items():
        if t is not None:
            check_tensor(key, t, device)
    if tables is not None:
        check_walk_tables(tables)
    for key, t in zip(MAP_FIELDS, maps):
        if t is not None:
            check_tensor(key, t, device)
    texels = texel_table_of(scene.mesh, albedo=not grads) if textured else None
    ptrs = {key: (0 if t is None else t.data_ptr()) for key, t in (tensors | outputs).items()}
    args = TraceArgs(**ptrs, nq=nq, ns=ns, nqd=nqd, width=width, height=height, bounces=cfg.bounces,
                     eps=cfg.eps_intersect, light_index=light, diffuse_indirect_max=cfg.diffuse_indirect_max,
                     camera_is_moving=int(cfg.camera_is_moving), transparent_tint=int(cfg.transparent_tint),
                     metal_roughness_lobe=int(cfg.metal_roughness_lobe), fast_quads=int(fast_quads))
    for i, quads in enumerate(texels if textured else ()):
        if quads is not None:
            args.tex[i], args.tex_h[i], args.tex_w[i] = quads.data_ptr(), quads.shape[0], quads.shape[1]
    mesh_arg = 0 if scene.mesh is None else 2 if textured else 1
    return args, mesh_arg, (tensors, texels)


def plane_counts(scene: Scene, cfg: IntegratorConfig) -> tuple[int, int]:
    """(n_sg, n_def): the grads mode's path-replay and deferred planes."""
    n_obj = sum(0 if g is None else g.color.shape[0] for g in (scene.quads, scene.spheres, scene.quadrics))
    n_def = sum(n for _, n in deferred_layout(cfg, is_textured(scene.mesh)).values())
    return (n_obj if cfg.transparent_tint else 2 * n_obj), n_def


def empty_outputs(scene: Scene, cfg: IntegratorConfig, lead: tuple, grads: bool, device) -> dict:
    """The kernels' output planes for pixels of shape ``lead`` ((H, W), or
    (F, H, W) for a pool): {"out_color": (*lead, 3), ...}; the grads mode's
    sg (n_sg, *lead) and deferred (n_def, *lead) planes, else None."""
    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    n_sg, n_def = plane_counts(scene, cfg)
    return {"out_color": empty(*lead, 3), "out_normal": empty(*lead, 3), "out_ocolor": empty(*lead, 3),
            "out_oid": empty(*lead), "out_sharp": empty(*lead), "out_sg": empty(n_sg, *lead) if grads else None,
            "out_def": empty(n_def, *lead) if grads and n_def else None}


def outputs_result(outputs: dict, scene: Scene, cfg: IntegratorConfig, lead: tuple, grads: bool):
    """(RadianceResult, sg or None, deferred or None) of ``empty_outputs``'s
    planes (a grads call without deferred planes gets a (0, *lead) one)."""
    result = RadianceResult(color=outputs["out_color"], object_normal=outputs["out_normal"],
                            object_color=outputs["out_ocolor"], object_id=outputs["out_oid"],
                            pixel_sharpness=outputs["out_sharp"])
    deferred = outputs["out_def"]
    if grads and deferred is None:
        deferred = torch.empty((0,) + lead, dtype=torch.float32, device=outputs["out_color"].device)
    return result, outputs["out_sg"], deferred

