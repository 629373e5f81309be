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

``trace_frames_fused`` (and ``trace_image_fused(reorder=True)``) is the port
of ``trace_frames_pallas``: several frames as one pool of lanes on the
staged path (``kernels/staged.py``, the kernel of ``csrc/staged.cu``),
sorted between bounces, each frame bit-equal to its monolithic launch, with
the same path-replay VJP.
"""

from __future__ import annotations

import ctypes

import torch

from bpt_tpu_torch.camera import Camera
from bpt_tpu_torch.core.rng import blue_noise_offsets, frame_to_u32
from bpt_tpu_torch.core.vecmath import INFINITY
from bpt_tpu_torch.env import get_hdr_color
from bpt_tpu_torch.geometry.triangles import resolve_fast_quads
from bpt_tpu_torch.integrator.config import IntegratorConfig
from bpt_tpu_torch.integrator.frame import trace_image
from bpt_tpu_torch.integrator.radiance import RadianceResult, check_supported, deferred_layout
from bpt_tpu_torch.kernels import build, staged
from bpt_tpu_torch.kernels.launch_args import (  # noqa: F401  (pack_*, plane_counts: this module's public names)
    CONFIGURATIONS, ENVS, NEES, TraceArgs, configuration, empty_outputs, outputs_result, pack_camera, pack_mesh,
    pack_params, pack_scene, plane_counts, trace_args)
from bpt_tpu_torch.kernels.staged import KEY_LAUNCHES, STAGED_GRAD_LAUNCHES, STAGED_LAUNCHES
from bpt_tpu_torch.kernels.texel_grad import TEXEL_GRAD_LAUNCHES, sample_learnt
from bpt_tpu_torch.scenes.types import Scene, is_textured
from bpt_tpu_torch.utils.profiling import spanned

KERNEL = "megakernel"
#: Launches of the forward kernel per configuration.
LAUNCHES = dict.fromkeys(CONFIGURATIONS, 0)
#: Launches of the grads-mode kernel per configuration.
GRAD_LAUNCHES = dict.fromkeys(CONFIGURATIONS, 0)


def reset_launches() -> None:
    """Set every launch count to 0 (K1's here, K2's and the key kernel's of
    ``kernels/staged.py``, the texel VJP's of ``kernels/texel_grad.py``)."""
    for counts in (LAUNCHES, GRAD_LAUNCHES, STAGED_LAUNCHES, STAGED_GRAD_LAUNCHES, KEY_LAUNCHES, TEXEL_GRAD_LAUNCHES):
        for name in counts:
            counts[name] = 0


def trace_image_fused_reference(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
                                lane_counts=None, fast_quads=None):
    """The plain PyTorch version of the forward kernel: ``trace_image`` with
    the plain mesh walk (the kernel is held to it, not to the closest-hit
    kernel) and the kernel's quad test (``fast_quads`` decided as the
    kernel's wrapper decides it)."""
    return trace_image(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
                       lane_counts=lane_counts, plain_walk=True, fast_quads=resolve_fast_quads(scene.quads, fast_quads))


def trace_image_fused_grads_reference(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
                                      lane_counts=None, fast_quads=None):
    """The plain PyTorch version of the grads-mode kernel: (RadianceResult,
    sg, deferred)."""
    return trace_image(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise, param_grads=True,
                       lane_counts=lane_counts, plain_walk=True, fast_quads=resolve_fast_quads(scene.quads, fast_quads))

def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    lib.bpt_trace.argtypes = [ctypes.POINTER(TraceArgs), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
    lib.bpt_trace.restype = ctypes.c_int
    lib.bpt_trace_args_size.restype = ctypes.c_int
    if lib.bpt_trace_args_size() != ctypes.sizeof(TraceArgs):
        raise RuntimeError(f"TraceArgs is {lib.bpt_trace_args_size()} bytes in the kernel and "
                           f"{ctypes.sizeof(TraceArgs)} in the wrapper")
    return lib


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


@spanned("bpt.kernels.k1")
def _launch(scene: Scene, camera: Camera, cfg: IntegratorConfig, width: int, height: int, frame_counter,
            rand_vec2, blue_noise: torch.Tensor, grads: bool, fast_quads: bool | None):
    """Pack, check and launch one kernel configuration on the current
    stream: (RadianceResult, sg or None, deferred or None).  CUDA tensors
    only."""
    device = blue_noise.device
    name = configuration(scene, cfg)
    outputs = empty_outputs(scene, cfg, (height, width), grads, device)
    args, mesh_arg, _keep = trace_args(scene, camera, cfg, width, height, blue_noise, outputs, fast_quads=fast_quads)
    args.bn_ox, args.bn_oy = blue_noise_offsets(rand_vec2)
    args.frame_u, args.frame_f = frame_to_u32(frame_counter), float(frame_counter)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bpt_trace(ctypes.byref(args), int(grads), ENVS[cfg.env], NEES[cfg.nee], mesh_arg, stream)
    if err != 0:
        raise RuntimeError(f"trace_kernel ({name}{', grads' if grads else ''}) launch failed: CUDA error {err}")
    (GRAD_LAUNCHES if grads else LAUNCHES)[name] += 1
    return outputs_result(outputs, scene, cfg, (height, width), grads)


def trace_image_fused_grads(scene: Scene, camera: Camera, cfg: IntegratorConfig, width: int, height: int,
                            frame_counter, rand_vec2, blue_noise: torch.Tensor, fast_quads: bool | None = None):
    """The kernel's grads mode: ``(RadianceResult, sg, deferred)``, sg the
    (n_sg, H, W) path-replay planes and deferred the (n_def, H, W) deferred
    planes of ``integrator.radiance.calculate_radiance`` (whose color leaves
    out what they defer; ``compose_deferred`` restores it).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    ``fast_quads``: as ``trace_image_fused``.
    """
    _check_call(scene, cfg, width, height, blue_noise)
    if blue_noise.device.type == "cpu":
        return trace_image_fused_grads_reference(scene, camera, cfg, width, height, frame_counter, rand_vec2,
                                                 blue_noise, fast_quads=fast_quads)
    return _launch(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise, grads=True,
                   fast_quads=fast_quads)


def _pixel_sum(planes: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """sum over pixels of planes[j] * values[..., c]: (J, *lead, W) x
    (*lead, W, C) -> (J, C), as one batched product per image row (the
    leading axes, (H,) or a pool's (F, H), flattened into rows).  A single
    (J, H*W) @ (H*W, C) product would hand cuBLAS a reduction of length
    H*W over a one-tile output, which it runs on one SM."""
    rows = planes.reshape(planes.shape[0], -1, planes.shape[-1])
    return torch.bmm(rows.transpose(0, 1), values.reshape(rows.shape[1], rows.shape[2], -1)).sum(0)


@spanned("bpt.replay.compose")
def compose_deferred(result: RadianceResult, deferred: torch.Tensor, scene: Scene,
                     cfg: IntegratorConfig) -> RadianceResult:
    """The grads mode's color with what it defers composed back in torch,
    the port of ``_compose_result``: + mw * get_hdr_color(mdir) under env
    "hdri" (the map and ``hdr_exposure`` differentiable), then with a
    textured mesh + emw * emission(em_uv) and the product of the albedo
    factors, each bilinear sample decoded as pow(max(x, 0), 2.2)
    (differentiable in the albedo and emissive maps; a bounce whose uv is
    -INFINITY applied no factor).  No albedo is divided by: a texel may be
    0.  The environment's CDF tables stay constants, as in JAX.  The UV
    planes are taken detached: ``_PathReplay``'s backward reads only the
    weights' cotangents, so a UV's would be computed for nothing.  The maps
    are sampled by ``texel_grad.sample_learnt``: a learnt map's gradient
    comes from the texel VJP kernel (``texel_grad.texel_kernel_route``), the
    plain routes' from autograd.  The planes may carry a leading frame
    axis (a pool's (n_def, F, H, W))."""
    layout = deferred_layout(cfg, is_textured(scene.mesh))
    if not layout:
        return result

    def planes(name):  # (..., H, W, count), laid out as the plain version's (H, W, 3) tensors
        first, count = layout[name]
        return torch.movedim(deferred[first:first + count], 0, -1).contiguous()

    color = result.color
    if "mw" in layout:
        color = color + planes("mw") * get_hdr_color(scene.env.hdr_image, planes("mdir"), scene.env.hdr_exposure)
    mesh = scene.mesh
    if "emw" in layout:
        if mesh.emissive is not None:
            em_uv = planes("em_uv").detach()
            emission = torch.pow(torch.clamp(sample_learnt(mesh.emissive, em_uv), min=0.0), 2.2)
            color = color + planes("emw") * emission
        if mesh.albedo is not None:
            uvs = planes("albedo_uv").detach()
            prod = torch.ones_like(color)
            for b in range(cfg.bounces):
                uv = uvs[..., 2 * b:2 * b + 2]
                applied = (uv[..., :1] > -INFINITY)
                albedo = torch.pow(torch.clamp(sample_learnt(mesh.albedo, torch.where(applied, uv, 0.0)), min=0.0), 2.2)
                prod = prod * torch.where(applied, albedo, 1.0)
            color = color * prod
    return result._replace(color=color)


class _PathReplay(torch.autograd.Function):
    """Port of ``_prb_fn`` and, with a pool's trace, of ``_prb_staged_fn``:
    differentiable in the sphere, quadric and quad colors, and through its
    deferred planes in what ``compose_deferred`` composes (the HDR map and
    exposure, the albedo and emissive maps).

    The forward runs ``trace(scene)``, a grads-mode trace that returns
    (RadianceResult, sg, deferred): one frame (the grads kernel or its plain
    version, by device) or a staged pool of frames (planes with a leading F
    axis; ``staged.trace_staged``), and saves the clamped color, the
    first-hit ids, the sg planes, the deferred planes and the colors in
    object-id order.  The backward ports ``f_bwd`` term for term, summing
    over every pixel of every frame: the hit counts carry
    d log f / d c = 1 / c, the Beer planes 0.01 t / c inside the clamp's
    linear region, and the first-hit ``object_color`` record a one-hot term;
    the env-terminated and emissive-terminated paths add their weights'
    terms (the cotangent of mw and emw times mw and emw), since those
    weights carry the same ∂log-throughput sum.  An output the loss does not
    use gets no term.
    """

    @staticmethod
    @spanned("bpt.replay.forward")
    def forward(ctx, quad_color, sphere_color, quadric_color, scene, cfg, trace):
        spheres = None if scene.spheres is None else scene.spheres._replace(color=sphere_color)
        quadrics = None if scene.quadrics is None else scene.quadrics._replace(color=quadric_color)
        scene = scene._replace(quads=scene.quads._replace(color=quad_color), spheres=spheres, quadrics=quadrics)
        result, sg, deferred = trace(scene)
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
    @spanned("bpt.replay.backward")
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
            ids = torch.arange(n_obj, dtype=oid.dtype, device=oid.device).reshape((-1,) + (1,) * oid.dim())
            onehot = (oid[None] == ids).to(colors.dtype)
            gcol = gcol + _pixel_sum(onehot, g_ocolor)
        ns, nqd, _ = ctx.sizes
        g_sph = gcol[:ns] if ns else None
        g_qdr = gcol[ns:ns + nqd] if nqd else None
        return gcol[ns + nqd:], g_sph, g_qdr, None, None, None


def path_replay(scene: Scene, camera: Camera, cfg: IntegratorConfig, trace) -> RadianceResult:
    """The result of ``trace`` (a grads-mode trace, see ``_PathReplay``)
    with the path-replay VJP attached and the deferred planes composed, when
    grad mode is on and a tensor the route differentiates requires a
    gradient; None otherwise (the caller then runs its plain forward, as
    JAX's custom_vjp runs its primal)."""
    if not torch.is_grad_enabled():
        return None
    _check_fixed_inputs(scene, camera)
    if not any(t.requires_grad for _, _, t in _tensors(scene, camera)):
        return None
    colors = [None if g is None else g.color for g in (scene.quads, scene.spheres, scene.quadrics)]
    *outs, deferred = _PathReplay.apply(*colors, scene, cfg, trace)
    return compose_deferred(RadianceResult(*outs), deferred, scene, cfg)


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
                      reorder: bool = False, reorder_splits=None, reorder_key: str = "oct-morton",
                      fast_quads: bool | None = None) -> RadianceResult:
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
    (within float rounding of the forward).  ``metal_roughness_lobe``
    without a textured mesh raises ``ValueError``, as JAX's kernel entry
    refuses it.

    ``reorder=True`` traces the frame as a pool of one frame on the staged
    path (``trace_frames_fused``): the staged kernel runs the bounces in
    phases split before the bounces of ``reorder_splits`` (default: every
    bounce) and the lanes are sorted by ``reorder_key`` between phases.
    The result equals the unsorted frame's bit for bit, forward and
    differentiable.

    ``fast_quads``, as JAX's ``trace_image_pallas`` takes it: None tests
    the quads with the parallelogram test exactly when every quad is a
    parallelogram (decided once per quad geometry and kept among
    ``geometry.triangles``' 64 most recently used entries, up to 5 a scene:
    no host sync per call while a caller cycles through at most 12 scenes),
    True demands it (ValueError on quads that are not
    parallelograms), False keeps the two triangle fans.  The kernel and its
    plain version take the same test.
    """
    if reorder:
        out = trace_frames_fused(scene, camera, cfg, width, height, [frame_counter], [rand_vec2], blue_noise,
                                 reorder_splits=reorder_splits, reorder_key=reorder_key,
                                 differentiable=differentiable, fast_quads=fast_quads)
        return RadianceResult(*(t[0] for t in out))
    _check_call(scene, cfg, width, height, blue_noise)
    if differentiable:
        out = path_replay(scene, camera, cfg, lambda s: trace_image_fused_grads(
            s, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise, fast_quads=fast_quads))
        if out is not None:
            return out
    if blue_noise.device.type == "cpu":
        return trace_image_fused_reference(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
                                           fast_quads=fast_quads)
    return _launch(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise, grads=False,
                   fast_quads=fast_quads)[0]


def trace_frames_fused(scene: Scene, camera: Camera, cfg: IntegratorConfig, width: int, height: int,
                       frame_counters, rand_vec2s, blue_noise: torch.Tensor, reorder_splits=None,
                       reorder_key: str = "oct-morton", full_height: int | None = None, row_offset: int = 0,
                       differentiable: bool = False, fast_quads: bool | None = None) -> RadianceResult:
    """F progressive frames traced as one pool of F·H·W lanes on the staged
    path: the port of ``trace_frames_pallas``.  Returns a RadianceResult
    whose tensors have a leading F axis, each frame equal bit for bit to
    ``trace_image_fused`` of its frame counter and blue-noise offset.

    ``frame_counters``: F numbers; ``rand_vec2s``: F host pairs.  The bounces
    run in phases split before the bounces of ``reorder_splits`` (default:
    every bounce, as JAX), and between phases the whole pool is sorted by
    ``reorder_key`` ("oct-morton", "morton-oct" or "dir-morton"; see
    ``staged.sort_key``).  ``height`` rows starting at absolute row
    ``row_offset`` of a ``full_height``-row image (default: the whole
    image): the RNG, the blue noise and the film use absolute rows, so a
    row slice equals the same rows of the whole image.  CUDA tensors launch
    the staged kernel (``STAGED_LAUNCHES`` / ``STAGED_GRAD_LAUNCHES`` count
    its phases) and the key kernel (``KEY_LAUNCHES``, one per sort); CPU
    tensors run the same loop with the plain phase
    (``staged.trace_phase_reference``).  ``differentiable=True`` carries the
    path-replay VJP, as ``trace_image_fused`` does, summed over the frames.
    ``fast_quads``: as ``trace_image_fused`` (JAX's ``trace_frames_pallas``
    takes it so).
    """
    _check_call(scene, cfg, width, height, blue_noise)

    def trace(s, grads):
        return staged.trace_staged(s, camera, cfg, width, height, frame_counters, rand_vec2s, blue_noise,
                                   splits=reorder_splits, key_mode=reorder_key, row_offset=row_offset,
                                   full_height=full_height, grads=grads, fast_quads=fast_quads)

    if differentiable:
        out = path_replay(scene, camera, cfg, lambda s: trace(s, True))
        if out is not None:
            return out
    return trace(scene, False)[0]
