"""The fused radiance pass: CUDA kernel wrappers + plain versions.

``trace_image_fused`` is the port of ``bpt_tpu.kernels.megakernel``'s
``trace_image_pallas`` for six configurations of its kernel: Cornell
(quads + unit spheres, env "none", quad-light NEE), quadric (the same plus
the 12 transformed quadrics), sky (env "sky", sun NEE), mesh (an untextured
BVH mesh, env "none"), hdri (env "hdri", sun or env NEE, with an untextured
mesh) and textured (a mesh with PBR maps, ``mesh_textured``, under any of
those environments, with or without ``metal_roughness_lobe``).
On CUDA tensors it launches the hand-written kernel in
``csrc/megakernel.cu``; on CPU tensors it runs the plain PyTorch version,
``trace_image_fused_reference`` (the port's wavefront ``trace_image``).
There is no fallback: a failed build or launch raises.

``differentiable=True`` is the port of the path-replay VJP (``_prb_fn``),
in every configuration: a ``torch.autograd.Function`` whose forward runs
the kernel's grads mode (``trace_image_fused_grads``: the 11 planes, the
per-object ∂log-throughput planes and, under env "hdri" and with a
textured mesh, the deferred planes) and whose backward turns those planes
into gradients of the sphere, quadric and quad colors in plain torch, as
the JAX package leaves that part to XLA; ``compose_deferred`` then composes
the deferred environment lookup, emission and albedo factors in torch, so
that autograd reaches the HDR map, its exposure and the albedo and emissive
maps.  Geometry, the sun, the camera and the normal and metallic-roughness
maps get no gradient through this route (JAX gives them zeros; here a
tensor of theirs that requires a gradient raises); the wavefront route
(``diff.gradients.make_render_loss``, ``fused=False``) is theirs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bpt_tpu_torch.camera import Camera, film_extents
from bpt_tpu_torch import sky
from bpt_tpu_torch.core.rng import blue_noise_offsets, frame_to_u32
from bpt_tpu_torch.core.sampling import lobe_exponent
from bpt_tpu_torch.core.vecmath import INFINITY, normalize
from bpt_tpu_torch.integrator.config import IntegratorConfig
from bpt_tpu_torch.integrator.frame import trace_image
from bpt_tpu_torch.env import get_hdr_color
from bpt_tpu_torch.integrator.radiance import RadianceResult, check_supported, deferred_layout
from bpt_tpu_torch.textures import sample_bilinear
from bpt_tpu_torch.kernels import build
from bpt_tpu_torch.scenes.types import MAP_FIELDS, PBR_MATERIAL, Scene, is_textured, kernel_tables_of

KERNEL = "megakernel"
#: The kernel's configurations, as ``configuration`` names them.
CONFIGURATIONS = ("cornell", "quadric", "sky", "mesh", "hdri", "textured")
#: Launches of the forward kernel per configuration.
LAUNCHES = dict.fromkeys(CONFIGURATIONS, 0)
#: Launches of the grads-mode kernel per configuration.
GRAD_LAUNCHES = dict.fromkeys(CONFIGURATIONS, 0)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for counts in (LAUNCHES, GRAD_LAUNCHES):
        for name in counts:
            counts[name] = 0


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

def trace_image_fused_reference(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
                                lane_counts=None):
    """The plain PyTorch version of the forward kernel: ``trace_image`` with
    the plain mesh walk (the kernel is held to it, not to the closest-hit
    kernel)."""
    return trace_image(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
                       lane_counts=lane_counts, plain_walk=True)


def trace_image_fused_grads_reference(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
                                      lane_counts=None):
    """The plain PyTorch version of the grads-mode kernel: (RadianceResult,
    sg, deferred)."""
    return trace_image(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise, param_grads=True,
                       lane_counts=lane_counts, plain_walk=True)

_MAX_QUADS = 256
_MAX_SPHERES = 64
_N_QUADRICS = 12
_ENVS = {"none": 0, "sky": 1, "hdri": 2}
_NEES = {"quad": 0, "sun": 1, "env": 2}


class _TraceArgs(ctypes.Structure):
    """The kernel's argument block, ``TraceArgs`` of csrc/megakernel.cu
    (pointers first, then 32-bit fields; the C side reports its size)."""

    _POINTERS = ("cam", "params", "quads", "spheres", "quadrics", "mesh", "mesh_nodes", "mesh_tris", "mesh_normals",
                 "hdr", "row_cdf", "col_cdf", "env_pdf", "blue_noise", "out_color", "out_normal", "out_ocolor",
                 "out_oid", "out_sharp", "out_sg", "mesh_uvs", "out_def")
    _fields_ = ([(name, ctypes.c_void_p) for name in _POINTERS]
                + [("tex", ctypes.c_void_p * 4)]
                + [(name, ctypes.c_int) for name in ("nq", "ns", "nqd", "bn_ox", "bn_oy", "width", "height", "bounces")]
                + [("eps", ctypes.c_float)]
                + [(name, ctypes.c_int) for name in ("light_index", "diffuse_indirect_max", "camera_is_moving",
                                                     "transparent_tint")]
                + [("frame_u", ctypes.c_uint32), ("frame_f", ctypes.c_float)]
                + [("tex_h", ctypes.c_int * 4), ("tex_w", ctypes.c_int * 4), ("metal_roughness_lobe", ctypes.c_int)])


def pack_scene(scene: Scene) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """Scene -> (quads (Nq, 20), spheres (Ns, 21) or None, quadrics (12, 20)
    or None), float32.

    Quad row: normalized n3, v0..v3, color3, mat, pad.  Sphere row: inverse
    4x4 row-major (16), color3, mat, pad.  Quadric row: inverse 4x4
    row-major (16), color3, mat.  The layout of the TPU kernel's
    ``pack_scene``.
    """
    q = scene.quads
    zq = torch.zeros((q.v0.shape[0], 1), dtype=torch.float32, device=q.v0.device)
    quads = torch.cat([normalize(q.normal), q.v0, q.v1, q.v2, q.v3, q.color,
                       q.mat_type.to(torch.float32)[:, None], zq], dim=1)
    sph = None
    if scene.spheres is not None:
        s = scene.spheres
        zs = torch.zeros((s.color.shape[0], 1), dtype=torch.float32, device=s.color.device)
        sph = torch.cat([s.inv_matrix.reshape(-1, 16), s.color, s.mat_type.to(torch.float32)[:, None], zs], dim=1)
    qdr = None
    if scene.quadrics is not None:
        d = scene.quadrics
        qdr = torch.cat([d.inv_matrix.reshape(-1, 16), d.color, d.mat_type.to(torch.float32)[:, None]], dim=1)
    return quads.contiguous(), *(None if t is None else t.contiguous() for t in (sph, qdr))


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
        return torch.cat([head, lobe, consts, torch.tensor([1.0, 0.0, 0.0])])

    return _device_constants(("params", cfg.sun_lobe_roughness), make, device)


def pack_params(scene: Scene, cfg: IntegratorConfig, device) -> torch.Tensor:
    """(22,) float32 on ``device``, the layout of csrc/vec.cuh: shape_k, the
    sun direction, the sun-only sky terms (sun_e, gamma, blend), the sun
    lobe's exponent and roughness, the sun-NEE weight scale (0.05, or
    sun_power² 1e-7 under ``sun_weight_mode="hdri"``), the sky's
    per-channel Rayleigh, Mie and extinction constants, and the HDR map's
    exposure, height and width.  Every entry is computed by the function
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
                  _device_constants(("hdr shape", h, w), lambda: torch.tensor([float(h), float(w)]), device)]
    else:
        parts.append(params[19:])
    return torch.cat(parts).detach().contiguous()


def pack_mesh(mesh):
    """TriangleMesh -> (constants (17,), MeshTables), float32, the layouts of
    csrc/bvh.cuh and csrc/textures.cuh.

    Constants: the inverse model matrix row-major and the material
    (PBR_MATERIAL for a mesh with an albedo), made on every call.  The
    tables are the mesh's ``kernel_tables``, made once by ``Scene.to``; a
    mesh that did not pass through it, or whose soup or BVH was replaced
    since, gets them made for this call."""
    mat = torch.full_like(mesh.mat_type, PBR_MATERIAL) if mesh.albedo is not None else mesh.mat_type
    consts = torch.cat([mesh.inv_matrix.reshape(16).to(torch.float32), mat.reshape(1).to(torch.float32)])
    return consts, kernel_tables_of(mesh)


def pack_camera(camera: Camera, width: int, height: int) -> torch.Tensor:
    """(16,) float32: position, right, up, forward, ulen, vlen, aperture, focus."""
    ulen, vlen = film_extents(camera, width, height)
    return torch.cat([camera.position, camera.right, camera.up, camera.forward,
                      torch.stack([ulen, vlen, camera.aperture_size, camera.focus_distance])]
                     ).to(torch.float32).contiguous()


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    lib.bpt_trace.argtypes = [ctypes.POINTER(_TraceArgs), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
    lib.bpt_trace.restype = ctypes.c_int
    lib.bpt_trace_args_size.restype = ctypes.c_int
    if lib.bpt_trace_args_size() != ctypes.sizeof(_TraceArgs):
        raise RuntimeError(f"TraceArgs is {lib.bpt_trace_args_size()} bytes in the kernel and "
                           f"{ctypes.sizeof(_TraceArgs)} in the wrapper")
    return lib


def _check_tensor(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_call(scene: Scene, cfg: IntegratorConfig, width: int, height: int, blue_noise: torch.Tensor) -> None:
    check_supported(scene, cfg)
    if cfg.metal_roughness_lobe and (scene.mesh is None or scene.mesh.albedo is None):
        raise ValueError("metal_roughness_lobe needs a textured mesh (an albedo: the lobe's roughness is per texel)")
    if width <= 0 or height <= 0:
        raise ValueError(f"bad image size {width}x{height}")
    if tuple(blue_noise.shape) != (256, 256, 4):
        raise ValueError(f"blue_noise must be (256, 256, 4), got {tuple(blue_noise.shape)}")
    if blue_noise.device.type not in ("cpu", "cuda"):
        raise ValueError(f"trace_image_fused runs on CPU or CUDA tensors, not {blue_noise.device}")


def _launch(scene: Scene, camera: Camera, cfg: IntegratorConfig, width: int, height: int, frame_counter,
            rand_vec2, blue_noise: torch.Tensor, grads: bool):
    """Pack, check and launch one kernel configuration on the current
    stream: (RadianceResult, sg or None, deferred or None).  CUDA tensors
    only."""
    device = blue_noise.device
    if scene.quads is None:
        raise ValueError("the kernel needs at least one quad; a scene without quads runs on the wavefront "
                         "(trace_image)")
    name = configuration(scene, cfg)
    quads, sph, qdr = pack_scene(scene)
    cam = pack_camera(camera, width, height)
    params = pack_params(scene, cfg, device)
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
    mesh_consts, tables = pack_mesh(scene.mesh) if scene.mesh is not None else (None, None)
    textured = is_textured(scene.mesh)
    maps = [getattr(scene.mesh, m) if textured else None for m in MAP_FIELDS]
    env = scene.env if cfg.env == "hdri" else None
    hdr = (None,) * 4 if env is None else (env.hdr_image,) + tuple(env.env_cdf or (None,) * 3)
    if cfg.nee != "env":
        hdr = hdr[:1] + (None,) * 3
    tensors = {"blue_noise": blue_noise, "quads": quads, "camera": cam, "params": params, "spheres": sph,
               "quadrics": qdr, "mesh": mesh_consts, "mesh_nodes": None if tables is None else tables.nodes,
               "mesh_tris": None if tables is None else tables.tris,
               "mesh_normals": None if tables is None else tables.normals, "hdr": hdr[0], "row_cdf": hdr[1],
               "col_cdf": hdr[2], "env_pdf": hdr[3], "mesh_uvs": tables.uvs if textured else None}
    for key, t in tensors.items():
        if t is not None:
            _check_tensor(key, t, device)
    for key, t in zip(MAP_FIELDS, maps):
        if t is not None:
            _check_tensor(key, t, device)
            if t.dim() != 3 or t.shape[-1] != 3 or t.numel() >= 2 ** 31:
                raise ValueError(f"{key} must be (H, W, 3) with fewer than 2**31 floats, got {tuple(t.shape)}")
    ox, oy = blue_noise_offsets(rand_vec2)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    color, normal, ocolor = empty(height, width, 3), empty(height, width, 3), empty(height, width, 3)
    oid, sharp = empty(height, width), empty(height, width)
    n_obj = nq + ns + nqd
    sg = empty(n_obj if cfg.transparent_tint else 2 * n_obj, height, width) if grads else None
    n_def = sum(n for _, n in deferred_layout(cfg, textured).values())
    deferred = empty(n_def, height, width) if grads else None
    outputs = {"out_color": color, "out_normal": normal, "out_ocolor": ocolor, "out_oid": oid, "out_sharp": sharp,
               "out_sg": sg, "out_def": deferred if n_def else None}
    ptrs = {key: (0 if t is None else t.data_ptr()) for key, t in (tensors | outputs).items()}
    ptrs["cam"] = ptrs.pop("camera")
    lib = _library()
    args = _TraceArgs(**ptrs, nq=nq, ns=ns, nqd=nqd, bn_ox=ox, bn_oy=oy, width=width, height=height,
                      bounces=cfg.bounces, eps=cfg.eps_intersect, light_index=light,
                      diffuse_indirect_max=cfg.diffuse_indirect_max, camera_is_moving=int(cfg.camera_is_moving),
                      transparent_tint=int(cfg.transparent_tint), frame_u=frame_to_u32(frame_counter),
                      frame_f=float(frame_counter), metal_roughness_lobe=int(cfg.metal_roughness_lobe))
    for i, t in enumerate(maps):
        if t is not None:
            args.tex[i], args.tex_h[i], args.tex_w[i] = t.data_ptr(), t.shape[0], t.shape[1]
    mesh_arg = 0 if scene.mesh is None else 2 if textured else 1
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bpt_trace(ctypes.byref(args), int(grads), _ENVS[cfg.env], _NEES[cfg.nee], mesh_arg, stream)
    if err != 0:
        raise RuntimeError(f"trace_kernel ({name}{', grads' if grads else ''}) launch failed: CUDA error {err}")
    (GRAD_LAUNCHES if grads else LAUNCHES)[name] += 1
    return RadianceResult(color=color, object_normal=normal, object_color=ocolor, object_id=oid,
                          pixel_sharpness=sharp), sg, deferred


def trace_image_fused_grads(scene: Scene, camera: Camera, cfg: IntegratorConfig, width: int, height: int,
                            frame_counter, rand_vec2, blue_noise: torch.Tensor):
    """The kernel's grads mode: ``(RadianceResult, sg, deferred)``, sg the
    (n_sg, H, W) path-replay planes and deferred the (n_def, H, W) deferred
    planes of ``integrator.radiance.calculate_radiance`` (whose color leaves
    out what they defer; ``compose_deferred`` restores it).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check_call(scene, cfg, width, height, blue_noise)
    if blue_noise.device.type == "cpu":
        return trace_image_fused_grads_reference(scene, camera, cfg, width, height, frame_counter, rand_vec2,
                                                 blue_noise)
    return _launch(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise, grads=True)


def _pixel_sum(planes: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """sum over pixels of planes[j] * values[..., c]: (J, H, W) x (H, W, C)
    -> (J, C), as one batched product per image row.  A single
    (J, H*W) @ (H*W, C) product would hand cuBLAS a reduction of length
    H*W over a one-tile output, which it runs on one SM."""
    return torch.bmm(planes.transpose(0, 1), values).sum(0)


def compose_deferred(result: RadianceResult, deferred: torch.Tensor, scene: Scene,
                     cfg: IntegratorConfig) -> RadianceResult:
    """The grads mode's color with what it defers composed back in torch,
    the port of ``_compose_result``: + mw * get_hdr_color(mdir) under env
    "hdri" (the map and ``hdr_exposure`` differentiable), then with a
    textured mesh + emw * emission(em_uv) and the product of the albedo
    factors, each bilinear sample decoded as pow(max(x, 0), 2.2)
    (differentiable in the albedo and emissive maps; a bounce whose uv is
    -INFINITY applied no factor).  No albedo is divided by: a texel may be
    0.  The environment's CDF tables stay constants, as in JAX."""
    layout = deferred_layout(cfg, is_textured(scene.mesh))
    if not layout:
        return result

    def planes(name):  # (H, W, count), laid out as the plain version's (H, W, 3) tensors
        first, count = layout[name]
        return torch.movedim(deferred[first:first + count], 0, -1).contiguous()

    color = result.color
    if "mw" in layout:
        color = color + planes("mw") * get_hdr_color(scene.env.hdr_image, planes("mdir"), scene.env.hdr_exposure)
    mesh = scene.mesh
    if "emw" in layout:
        if mesh.emissive is not None:
            emission = torch.pow(torch.clamp(sample_bilinear(mesh.emissive, planes("em_uv")), min=0.0), 2.2)
            color = color + planes("emw") * emission
        if mesh.albedo is not None:
            uvs = planes("albedo_uv")
            prod = torch.ones_like(color)
            for b in range(cfg.bounces):
                uv = uvs[..., 2 * b:2 * b + 2]
                applied = (uv[..., :1] > -INFINITY)
                albedo = torch.pow(torch.clamp(sample_bilinear(mesh.albedo, torch.where(applied, uv, 0.0)),
                                               min=0.0), 2.2)
                prod = prod * torch.where(applied, albedo, 1.0)
            color = color * prod
    return result._replace(color=color)


class _PathReplay(torch.autograd.Function):
    """Port of ``_prb_fn``: differentiable in the sphere, quadric and quad
    colors, and through its deferred planes in what ``compose_deferred``
    composes (the HDR map and exposure, the albedo and emissive maps).

    The forward runs the grads mode (kernel or plain version, by device) and
    saves the clamped color, the first-hit ids, the sg planes, the deferred
    planes and the colors in object-id order.  The backward ports ``f_bwd``
    term for term: the hit counts carry d log f / d c = 1 / c, the Beer
    planes 0.01 t / c inside the clamp's linear region, and the first-hit
    ``object_color`` record a one-hot term; the env-terminated and
    emissive-terminated paths add their weights' terms (the cotangent of mw
    and emw times mw and emw), since those weights carry the same
    ∂log-throughput sum.  An output the loss does not use gets no term.
    """

    @staticmethod
    def forward(ctx, quad_color, sphere_color, quadric_color, scene, camera, cfg, width, height, frame_counter,
                rand_vec2, blue_noise):
        spheres = None if scene.spheres is None else scene.spheres._replace(color=sphere_color)
        quadrics = None if scene.quadrics is None else scene.quadrics._replace(color=quadric_color)
        scene = scene._replace(quads=scene.quads._replace(color=quad_color), spheres=spheres, quadrics=quadrics)
        result, sg, deferred = trace_image_fused_grads(scene, camera, cfg, width, height, frame_counter, rand_vec2,
                                                       blue_noise)
        groups = [c for c in (sphere_color, quadric_color, quad_color) if c is not None]
        colors = torch.cat(groups)
        ctx.sizes = [0 if c is None else c.shape[0] for c in (sphere_color, quadric_color, quad_color)]
        layout = deferred_layout(cfg, is_textured(scene.mesh))
        ctx.weights = [layout[k][0] for k in ("mw", "emw") if k in layout]  # the first plane of each weight
        ctx.save_for_backward(result.color, result.object_id, sg, colors, deferred)
        ctx.mark_non_differentiable(result.object_normal, result.object_id, result.pixel_sharpness)
        ctx.set_materialize_grads(False)
        return tuple(result) + (deferred,)

    @staticmethod
    def backward(ctx, g_color, g_normal, g_ocolor, g_oid, g_sharp, g_deferred):
        color, oid, sg, colors, deferred = ctx.saved_tensors
        n_obj = colors.shape[0]
        gcol = torch.zeros_like(colors)
        weighted = None if g_color is None else g_color * color
        if g_deferred is not None:
            for first in ctx.weights:
                term = torch.movedim(g_deferred[first:first + 3] * deferred[first:first + 3], 0, -1)
                weighted = term if weighted is None else weighted + term
        if weighted is not None:
            per_plane = _pixel_sum(sg, weighted)
            inv_c = 1.0 / torch.clamp(colors, min=1e-8)
            gcol = per_plane[:n_obj] * inv_c
            if sg.shape[0] > n_obj:  # Beer-Lambert planes (tint off)
                beer_gate = ((colors > 0.01) & (colors < 0.99)).to(colors.dtype)
                gcol = gcol + per_plane[n_obj:] * beer_gate * inv_c
        if g_ocolor is not None:
            ids = torch.arange(n_obj, dtype=oid.dtype, device=oid.device)
            onehot = (oid[None] == ids[:, None, None]).to(colors.dtype)
            gcol = gcol + _pixel_sum(onehot, g_ocolor)
        ns, nqd, _ = ctx.sizes
        g_sph = gcol[:ns] if ns else None
        g_qdr = gcol[ns:ns + nqd] if nqd else None
        return (gcol[ns + nqd:], g_sph, g_qdr) + (None,) * 8


#: The tensors the path-replay route differentiates, by group: the colors,
#: the HDR map and exposure, and a textured mesh's albedo and emissive maps.
#: Every other scene or camera tensor is held fixed.
DIFFERENTIABLE = {"Quads": ("color",), "UnitSpheres": ("color",), "Quadrics": ("color",),
                  "Environment": ("hdr_image", "hdr_exposure"), "TriangleMesh": ("albedo", "emissive")}


def _tensors(scene: Scene, camera: Camera):
    """(group.field, tensor) of every tensor of the scene and camera."""
    groups = [g for g in (scene.quads, scene.spheres, scene.quadrics, scene.mesh, scene.env, camera) if g is not None]
    return [(type(g).__name__, name, t) for g in groups for name, t in zip(g._fields, g) if isinstance(t, torch.Tensor)]


def _check_fixed_inputs(scene: Scene, camera: Camera) -> None:
    """Raise if a tensor the path-replay VJP holds fixed requires a gradient:
    the geometry (the mesh's transform, vertices, normals and uvs, the
    quads', spheres' and quadrics' shapes), the normal and
    metallic-roughness maps, the sun and the camera.  JAX's custom VJP gives
    them zero cotangents without a word."""
    fixed = [f"{group}.{name}" for group, name, t in _tensors(scene, camera)
             if t.requires_grad and name not in DIFFERENTIABLE.get(group, ())]
    if fixed:
        raise NotImplementedError(
            f"the path-replay gradient reaches only the sphere, quadric and quad colors, the HDR map and its "
            f"exposure and the albedo and emissive maps, not {', '.join(fixed)}; use the wavefront route "
            "(fused=False, or diff.make_render_loss) for geometry, sun, camera and the other maps' gradients")


def trace_image_fused(scene: Scene, camera: Camera, cfg: IntegratorConfig, width: int, height: int,
                      frame_counter, rand_vec2, blue_noise: torch.Tensor, differentiable: bool = False,
                      reorder: bool = False) -> RadianceResult:
    """One 1-spp frame, the same RadianceResult as
    ``integrator.frame.trace_image`` (same draws; float-level parity).

    The device is ``blue_noise``'s: CPU runs the plain version, CUDA launches
    the kernel on the current stream without synchronising.

    ``differentiable=True`` carries the path-replay VJP, in every
    configuration: gradients flow to ``scene.quads.color``,
    ``scene.spheres.color`` and ``scene.quadrics.color`` (the light's
    emission included) and, through ``compose_deferred``, to
    ``scene.env.hdr_image`` and ``hdr_exposure`` and the mesh's ``albedo``
    and ``emissive`` maps.  When none of them requires a gradient, or grad
    mode is off, the call is the plain forward, as JAX's custom_vjp runs its
    primal.  Any other scene or camera tensor that requires a gradient
    raises ``NotImplementedError``: this route would leave it without one.
    Under env "hdri" the color then equals the forward's bit for bit; with a
    textured mesh the albedo factors are multiplied in another order
    (within float rounding of the forward).  ``reorder=True`` (the staged,
    reorderable path) is not ported yet and raises ``NotImplementedError``;
    ``metal_roughness_lobe`` without a textured mesh raises ``ValueError``,
    as JAX's kernel entry refuses it.
    """
    if reorder:
        raise NotImplementedError("reorder=True (the staged kernel K2 and its VJP) is not ported yet")
    _check_call(scene, cfg, width, height, blue_noise)
    if differentiable and torch.is_grad_enabled():
        _check_fixed_inputs(scene, camera)
        if any(t.requires_grad for _, _, t in _tensors(scene, camera)):
            colors = [None if g is None else g.color for g in (scene.quads, scene.spheres, scene.quadrics)]
            *outs, deferred = _PathReplay.apply(*colors, scene, camera, cfg, width, height, frame_counter,
                                                rand_vec2, blue_noise)
            return compose_deferred(RadianceResult(*outs), deferred, scene, cfg)
    if blue_noise.device.type == "cpu":
        return trace_image_fused_reference(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise)
    return _launch(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise, grads=False)[0]
