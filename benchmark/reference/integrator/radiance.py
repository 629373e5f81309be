# Frozen copy of bpt_tpu_torch/integrator/radiance.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.
"""Wavefront radiance estimator (port of ``bpt_tpu.integrator.radiance``).

Every bounce intersects all live rays, evaluates every material branch over
the whole pixel array and selects by material id with per-lane masks — the
plain PyTorch version of the fused kernel.  Four configurations are
ported: env "none" with quad-light NEE (the Cornell, quadric and glTF
demos), env "sky" with sun NEE (the Preetham demo), and env "hdri" with sun
NEE or luminance-CDF env NEE (the HDRI demo), with the DIFFUSE, METAL,
TRANSPARENT and CLEARCOAT branches over spheres, quadrics, quads and a BVH
mesh.  A mesh with an albedo is PBR_MATERIAL: at each hit its albedo,
emissive and metallic-roughness texels are sampled and decoded
(pow(max(x, 0), 2.2)); an emissive texel (max > 0.01) ends a specular path
as a light; the roughness channel (g > 0.01) makes it CLEARCOAT_DIFFUSE and
the metalness channel (b > 0.01) METAL, else it is DIFFUSE; with
``metal_roughness_lobe`` a METAL bounce draws its direction from the
specular lobe of that roughness (0 off the mesh).  Other (env, nee) pairs
raise ``NotImplementedError``.

Draw order per bounce (the RNG seam shared with the kernel and the
reference): blue noise gate1, gate2; hash hem.r, hem.phi, then quad.x,
quad.y, quad.z (nee "quad"), then lobe.cos, lobe.phi (nee "sun" and "env",
where the pair feeds the inverse-CDF environment sample, and with
``metal_roughness_lobe``, under quad NEE too).  Discrete decisions are
detached from autograd (``.detach()`` where the reference has
``stop_gradient``).

With ``param_grads=True`` the pass also returns the path-replay planes of
the TPU kernel's ``param_grads`` output (``bpt_tpu/kernels/megakernel.py``,
its per-object accumulation): the plain version of the CUDA kernel's grads
mode.  Planes 0..n_obj-1 count, per pixel, the bounces whose throughput
factor is linear in object j's color (diffuse, metal, the clearcoat base,
a contributing light hit, and tinted refraction when
``cfg.transparent_tint``); with the tint off, planes n_obj..2*n_obj-1 sum
0.01*t over the refractions that leave glass object j (Beer-Lambert).
Object ids are the ``Hit.object_id`` order: spheres, quadrics, quads; a
mesh hit adds no term (its hit color is 1).  A sky miss adds no plane: the
sky radiance does not depend on any color.

The grads mode also defers what the JAX kernel hands to its outside
composition (``_compose_result``), so that autograd can reach the HDR map,
its exposure and a textured mesh's albedo and emissive maps.  The deferred
planes (``deferred_layout``) are: under env "hdri", the miss throughput
``mw`` (3) and the miss direction (3), and the color then leaves out the
environment's radiance (color + mw * get_hdr_color(mdir) restores it);
with a textured mesh, per bounce the albedo uv (2; -INFINITY where that
bounce applied no albedo factor: under REPEAT wrap -1 is a real uv), then
the emissive-terminal weight (3) and its uv (2), and the color then leaves
out the albedo factors and the emission (every path contributes at exactly
one terminal event, after all of its albedo factors, so (color + mw * env
+ emw * emission) * Π albedo restores it).
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from benchmark.reference.core.fresnel import calc_fresnel_reflectance
from benchmark.reference.core.rng import BlueNoise, RngState, bn_next, rng_next
from benchmark.reference.core.sampling import cos_hemisphere_from_uniforms, specular_lobe_from_uniforms
from benchmark.reference.core.vecmath import INFINITY, dot, face_forward, normalize, reflect, refract
from benchmark.reference.env import EnvCDF, get_hdr_color, sample_env_cdf
from benchmark.reference.integrator.config import IntegratorConfig
from benchmark.reference.integrator.intersect import scene_intersect
from benchmark.reference.lights import quad_light_from_uniforms
from benchmark.reference.scenes.types import (CLEARCOAT_DIFFUSE, DIFFUSE, LIGHT, MAP_FIELDS, METAL, PBR_MATERIAL, TRANSPARENT,
                                        Scene, is_textured)
from benchmark.reference.sky import get_sky_color
from benchmark.reference.textures import sample_bilinear, texels_read

#: The (env, nee) pairs the port runs.
SUPPORTED = (("none", "quad"), ("sky", "sun"), ("hdri", "sun"), ("hdri", "env"))


class RadianceResult(NamedTuple):
    """Per-pixel integrator outputs."""

    color: torch.Tensor  # (..., 3) radiance estimate, >= 0
    object_normal: torch.Tensor  # (..., 3) first-hit shading normal
    object_color: torch.Tensor  # (..., 3) first-hit material color
    object_id: torch.Tensor  # (...,) first-hit object id (-INFINITY on miss)
    pixel_sharpness: torch.Tensor  # (...,) denoiser flag (0 / -1 / 1.01)


def deferred_layout(cfg: IntegratorConfig, textured: bool) -> dict:
    """The grads mode's deferred planes: {name: (first plane, count)}, in
    the order the kernel writes them (``mw``, ``mdir`` under env "hdri";
    ``albedo_uv`` (2 per bounce), ``emw``, ``em_uv`` with a textured
    mesh)."""
    sizes = ([("mw", 3), ("mdir", 3)] if cfg.env == "hdri" else []) + (
        [("albedo_uv", 2 * cfg.bounces), ("emw", 3), ("em_uv", 2)] if textured else [])
    layout, first = {}, 0
    for name, count in sizes:
        layout[name] = (first, count)
        first += count
    return layout


class LaneCounts(NamedTuple):
    """One bounce's lane counts (0-d tensors), for measurement: the lanes
    still alive (those for which the kernel runs the bounce's intersection),
    of those the lanes that hit something and the lanes that missed, the
    torus march's SDF evaluations and the mesh walk's inner-node visits and
    triangle tests on live lanes, and the live shadow rays (NEE) that
    missed every surface, i.e. reached the environment.  ``mesh_reads``:
    with a mesh, the bool masks of its node, triangle and vertex-normal
    records the bounce read (``intersect_mesh_bvh``'s), else None.

    With a textured mesh, what the kernel's texel work was: ``pbr_classes``,
    the PBR hits decided DIFFUSE, CLEARCOAT_DIFFUSE and METAL, (3,);
    ``emissive_hits``, the PBR hits an emissive texel ended; ``lobe_draws``,
    the METAL bounces that drew the roughness lobe with a roughness above 0;
    ``texel_samples``, per map (albedo, normal, metallic-roughness,
    emissive) the bilinear samples an output reads, (4,): the normal map at
    every live mesh hit but a shadow ray's (which ends there, its normal
    unread), the albedo at every PBR hit, the emissive map at every PBR hit
    on a specular path (the only one its texel can end), the
    metallic-roughness map at every PBR hit that did not end (0 for a map
    the mesh lacks); and ``texel_reads``, per map the (H, W) bool mask of the
    texels those samples read, or None.  That is the work of the function
    whatever computes it: the plain version samples every lane.

    ``parallelogram_tests``: the quad tests of live lanes that the
    parallelogram test made (live lanes x quads when ``fast_quads`` ran it,
    0 when the two triangle fans did), counted where that branch runs."""

    live: torch.Tensor
    hits: torch.Tensor
    misses: torch.Tensor
    torus_steps: torch.Tensor
    node_visits: torch.Tensor
    tri_tests: torch.Tensor
    shadow_misses: torch.Tensor
    mesh_reads: tuple | None = None
    pbr_classes: torch.Tensor | None = None
    emissive_hits: torch.Tensor | None = None
    lobe_draws: torch.Tensor | None = None
    texel_samples: torch.Tensor | None = None
    texel_reads: tuple | None = None
    parallelogram_tests: torch.Tensor | None = None


def check_supported(scene: Scene, cfg: IntegratorConfig) -> None:
    """Raise NotImplementedError for a configuration the port does not run
    (ValueError for a scene that lacks what its configuration needs)."""
    if (cfg.env, cfg.nee) not in SUPPORTED:
        raise NotImplementedError(
            f"env={cfg.env!r}, nee={cfg.nee!r}: the port runs env 'none' + nee 'quad', env 'sky' + nee 'sun' and "
            "env 'hdri' + nee 'sun' or 'env'")
    if cfg.sun_weight_mode not in ("sky", "hdri"):
        raise ValueError(f"sun_weight_mode {cfg.sun_weight_mode!r} is not 'sky' or 'hdri'")
    if cfg.nee == "quad" and scene.quads is None:
        raise ValueError("quad-light NEE needs scene.quads")
    if cfg.env == "sky" and scene.env is None:
        raise ValueError("env 'sky' needs scene.env (its sun direction)")
    if cfg.env == "hdri" and (scene.env is None or scene.env.hdr_image is None or scene.env.hdr_exposure is None):
        raise ValueError("env 'hdri' needs scene.env with its sun direction, hdr_image and hdr_exposure")
    if cfg.nee == "env" and scene.env.env_cdf is None:
        raise ValueError("nee 'env' needs scene.env.env_cdf (env.build_env_cdf; hdri_scene builds it)")


def _where3(c, a, b):
    return torch.where(c[..., None], a, b)


def _texel_counts(counts: LaneCounts, mesh, uv, mesh_won, pbr_hits, pbr_lanes, emissive_hit, mat, mr_g,
                  lobe: bool, spec) -> LaneCounts:
    """``counts`` with one bounce's texel work filled in (see LaneCounts);
    ``mesh_won`` the live lanes whose mesh hit is not a shadow ray's, ``spec``
    the lanes on a specular path."""
    maps = [getattr(mesh, name) for name in MAP_FIELDS]
    sampled = (pbr_hits, mesh_won, pbr_lanes, pbr_hits & spec)  # the lanes whose sample of each map is read
    reads = tuple(None if tex is None else texels_read(tex, uv[lanes]) for tex, lanes in zip(maps, sampled))
    samples = torch.stack([lanes.sum() * (tex is not None) for tex, lanes in zip(maps, sampled)])
    classes = torch.stack([(pbr_lanes & (mat == m)).sum() for m in (DIFFUSE, CLEARCOAT_DIFFUSE, METAL)])
    lobe_draws = (pbr_lanes & (mat == METAL) & (mr_g > 0.0)).sum() if lobe else torch.zeros_like(classes[0])
    return counts._replace(pbr_classes=classes, emissive_hits=emissive_hit.sum(), lobe_draws=lobe_draws,
                           texel_samples=samples, texel_reads=reads)


class PathState(NamedTuple):
    """Everything a path carries from one bounce to the next, one entry per
    lane (any lane shape): what ``run_bounces`` resumes from.

    ``frame`` is each lane's frame counter (float32): a pool of lanes may
    mix frames.  The first-hit records, and with ``param_grads`` the sg
    accumulators and the deferred planes' values, ride along, so that a
    path traced in several bounce ranges ends where one traced at once
    does.  ``sg_lin`` / ``sg_beer`` are (n_obj,) + lanes (``sg_beer`` None
    with ``cfg.transparent_tint``); ``mw``, ``mdir`` (env "hdri") and
    ``albedo_uv`` (a tuple of one (..., 2) tensor per bounce), ``emw``,
    ``em_uv`` (a textured mesh) are None when the grads mode does not
    defer them."""

    ro: torch.Tensor
    rd: torch.Tensor
    mask: torch.Tensor
    accum: torch.Tensor
    alive: torch.Tensor
    spec: torch.Tensor  # bounceIsSpecular
    sample_light: torch.Tensor
    coat_hit: torch.Tensor  # coatTypeIntersected
    d_count: torch.Tensor  # diffuseCount, int32
    prev_mat: torch.Tensor  # int32
    sharp: torch.Tensor  # pixelSharpness
    obj_normal: torch.Tensor
    obj_color: torch.Tensor
    obj_id: torch.Tensor
    frame: torch.Tensor
    rng: RngState
    bn: BlueNoise
    sg_lin: torch.Tensor | None = None
    sg_beer: torch.Tensor | None = None
    mw: torch.Tensor | None = None
    mdir: torch.Tensor | None = None
    albedo_uv: tuple | None = None
    emw: torch.Tensor | None = None
    em_uv: torch.Tensor | None = None


def _n_objects(scene: Scene) -> int:
    return sum(0 if g is None else g.color.shape[0] for g in (scene.spheres, scene.quadrics, scene.quads))


def init_paths(scene: Scene, cfg: IntegratorConfig, ray_origin: torch.Tensor, ray_dir: torch.Tensor, rng: RngState,
               bn: BlueNoise, frame_counter, param_grads: bool = False) -> PathState:
    """The state of fresh paths, before bounce 0: one per lane of
    ``ray_origin`` (..., 3).  ``frame_counter`` is a number or a per-lane
    tensor."""
    check_supported(scene, cfg)
    shape = ray_origin.shape[:-1]
    dev = ray_origin.device
    f32 = ray_origin.dtype

    def full(value, dtype=f32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    zeros3 = torch.zeros(shape + (3,), dtype=f32, device=dev)
    frame = (frame_counter.to(dtype=f32, device=dev).expand(shape) if isinstance(frame_counter, torch.Tensor)
             else full(float(frame_counter)))
    state = PathState(ro=ray_origin, rd=ray_dir, accum=zeros3, mask=torch.ones(shape + (3,), dtype=f32, device=dev),
                      alive=full(True, torch.bool), spec=full(True, torch.bool),
                      sample_light=full(False, torch.bool), coat_hit=full(False, torch.bool),
                      d_count=full(0, torch.int32), prev_mat=full(-100, torch.int32), sharp=full(0.0),
                      obj_normal=zeros3, obj_color=zeros3, obj_id=full(-INFINITY), frame=frame, rng=rng, bn=bn)
    if not param_grads:
        return state
    sg_lin = torch.zeros((_n_objects(scene),) + shape, dtype=f32, device=dev)
    state = state._replace(sg_lin=sg_lin, sg_beer=None if cfg.transparent_tint else torch.zeros_like(sg_lin))
    if cfg.env == "hdri":
        state = state._replace(mw=zeros3, mdir=zeros3)
    if is_textured(scene.mesh):
        no_uv = torch.full(shape + (2,), -INFINITY, dtype=f32, device=dev)
        state = state._replace(albedo_uv=(no_uv,) * cfg.bounces, emw=zeros3,
                               em_uv=torch.zeros(shape + (2,), dtype=f32, device=dev))
    return state


def run_bounces(scene: Scene, cfg: IntegratorConfig, state: PathState, lo: int, hi: int,
                lane_counts: list | None = None, plain_walk: bool = False, fast_quads: bool = False) -> PathState:
    """Bounces [lo, hi) of every lane of ``state``; returns the state after
    them.  Bounce indices are absolute (bounce 0 sees the environment
    directly, bounce 1 after a mirror rewrites the first-hit records).
    Every lane is evaluated, dead ones masked, so lanes may come in any
    order.  ``lane_counts``, ``plain_walk`` and ``fast_quads``: see
    ``calculate_radiance``.
    """
    ro, rd, mask, accum = state.ro, state.rd, state.mask, state.accum
    alive, spec, sample_light, coat_hit = state.alive, state.spec, state.sample_light, state.coat_hit
    d_count, prev_mat, sharp = state.d_count, state.prev_mat, state.sharp
    obj_normal, obj_color, obj_id = state.obj_normal, state.obj_color, state.obj_id
    rng, bn = state.rng, state.bn
    shape = ro.shape[:-1]
    dev = ro.device
    f32 = ro.dtype
    eps = cfg.eps_intersect

    def full(value, dtype=f32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    one, zero = full(1.0), full(0.0)
    # the clearcoat reflection's sharpness flag on a first bounce, per lane's frame
    fc_sharp = torch.where(state.frame > 500.0, full(1.01), -one)

    has_quad_light = cfg.nee == "quad"
    if has_quad_light:
        quads = scene.quads
        li = cfg.light_index if cfg.light_index >= 0 else quads.v0.shape[0] - 1
        lv0, lv1, lv2, lv3 = quads.v0[li], quads.v1[li], quads.v2[li], quads.v3[li]
        l_normal = normalize(quads.normal[li])
    use_lobe = cfg.nee in ("sun", "env") or cfg.metal_roughness_lobe
    pbr_mesh = scene.mesh if scene.mesh is not None and scene.mesh.albedo is not None else None
    textured = is_textured(scene.mesh)  # an albedo or a normal map: the kernel's textured configuration
    mesh_id = float(_n_objects(scene))
    sun_dir = None if scene.env is None else scene.env.sun_direction
    env_cdf = EnvCDF(*scene.env.env_cdf) if cfg.nee == "env" else None
    param_grads = state.sg_lin is not None
    if param_grads:
        sg_lin, sg_beer = state.sg_lin, state.sg_beer
        obj_ids = torch.arange(sg_lin.shape[0], dtype=f32, device=dev).reshape((-1,) + (1,) * len(shape))
    defer_miss = state.mw is not None
    defer_tex = state.emw is not None
    if defer_miss:
        mw, mdir = state.mw, state.mdir
    if defer_tex:
        albedo_uv = list(state.albedo_uv)
        emw, em_uv = state.emw, state.em_uv
        no_uv = torch.full(shape + (2,), -INFINITY, dtype=f32, device=dev)

    for bounce in range(lo, hi):
        lit = full(False, torch.bool)
        torus_steps = [] if lane_counts is not None and scene.quadrics is not None else None
        mesh_steps = [] if lane_counts is not None and scene.mesh is not None else None
        quad_tests = [] if lane_counts is not None else None
        hit = scene_intersect(scene, ro, rd, torus_steps=torus_steps, active=alive, mesh_steps=mesh_steps,
                              plain_walk=plain_walk, fast_quads=fast_quads, quad_tests=quad_tests)
        miss = hit.t >= INFINITY
        if lane_counts is not None:
            none = torch.zeros((), dtype=torch.int64, device=dev)
            steps = torus_steps[0][alive].sum() if torus_steps else none
            visits, tests = (mesh_steps[0].sum(), mesh_steps[1].sum()) if mesh_steps else (none, none)
            lane_counts.append(LaneCounts(alive.sum(), (alive & ~miss).sum(), (alive & miss).sum(), steps, visits,
                                          tests, (alive & miss & sample_light).sum(),
                                          tuple(mesh_steps[2:]) if mesh_steps else None,
                                          parallelogram_tests=alive.sum() * (scene.quads.v0.shape[0] if
                                                                             quad_tests == ["parallelogram"] else 0)))
            # the lanes whose normal-map sample is read: a shadow ray that ends on the mesh reads none
            mesh_won = alive & ~miss & (hit.object_id == mesh_id) & ~sample_light

        n = normalize(hit.normal)
        nl = face_forward(n, rd)
        x = ro + rd * hit.t[..., None]
        hit_color = hit.color
        mat = hit.mat_type

        if cfg.env != "none":
            m = alive & miss
            if defer_miss:
                env_color = None  # the environment's radiance is composed outside (deferred planes)
            elif cfg.env == "sky":
                env_color = get_sky_color(rd, sun_dir)
            else:
                env_color = get_hdr_color(scene.env.hdr_image, rd, scene.env.hdr_exposure)
            if bounce == 0:  # a primary ray sees the environment
                if defer_miss:
                    mw, mdir = _where3(m, mask, mw), _where3(m, rd, mdir)
                else:
                    accum = _where3(m, env_color, accum)
                sharp = torch.where(m, full(1.01), sharp)
            else:
                # first-match case chain c2 > c3 > c4 > c5; c2 and c3 share a value
                sun_cos = dot(rd, sun_dir.expand(rd.shape))
                c2 = (d_count == 0) & spec
                c3 = sample_light
                c4 = (d_count == 1) & (prev_mat == TRANSPARENT) & spec
                if cfg.env == "hdri":
                    c4 = c4 & (bounce < 3)
                c5 = d_count > 0
                if cfg.nee == "env":
                    # env NEE covers the whole map at every diffuse vertex: a
                    # BSDF-sampled env hit after a diffuse bounce would count twice
                    sun_clip = zero
                else:
                    sun_clip = torch.where(sun_cos < 0.99, one, zero)
                if defer_miss:  # the miss throughput: the weight the environment's radiance takes
                    weight = _where3(c2 | c3 | c4, mask,
                                     _where3(c5, mask * sun_clip[..., None], torch.zeros_like(mask)))
                    mw, mdir = _where3(m, weight, mw), _where3(m, rd, mdir)
                else:
                    lit_env = mask * env_color
                    chosen = _where3(c2 | c3 | c4, lit_env,
                                     _where3(c5, lit_env * sun_clip[..., None], torch.zeros_like(lit_env)))
                    accum = _where3(m, chosen, accum)
                sharp = torch.where(m & c2, full(1.01), sharp)
                if cfg.env == "hdri":
                    sharp = torch.where(m & ~c2 & ~c3 & c4 & (sun_cos > 0.99), full(1.01), sharp)
        # a miss ends the lane (env "none": black)
        alive = alive & ~miss
        lane = alive

        # ---- first-hit records for the edge detector -----------------------
        if bounce == 0:
            obj_normal = _where3(lane, nl, obj_normal)
            obj_color = _where3(lane, hit_color, obj_color)
            obj_id = torch.where(lane, hit.object_id, obj_id)
        if bounce == 1:
            after_metal = lane & (prev_mat == METAL)
            obj_normal = _where3(after_metal, nl, obj_normal)
            obj_id = torch.where(after_metal, hit.object_id, obj_id)

        # ---- light hit terminates (quad-light NEE only) --------------------
        if has_quad_light:
            is_light = lane & (mat == LIGHT)
            sharp = torch.where(is_light & (d_count == 0), full(1.01), sharp)
            lit = is_light & (spec | sample_light)
            accum = _where3(lit, mask * hit_color, accum)
            alive = alive & ~is_light
            lane = alive

        # ---- failed shadow ray terminates ----------------------------------
        alive = alive & ~(lane & sample_light)
        lane = alive

        # ---- a textured mesh's PBR texels: albedo, emission, class, roughness
        mr_g = zero  # the METAL lobe's roughness
        if pbr_mesh is not None:
            is_pbr = lane & (mat == PBR_MATERIAL)
            pbr_hits = is_pbr
            if defer_tex:  # the albedo factor is composed outside: the throughput takes 1
                albedo = torch.ones_like(hit_color)
            else:
                albedo = torch.pow(torch.clamp(sample_bilinear(pbr_mesh.albedo, hit.uv), min=0.0), 2.2)
            hit_color = _where3(is_pbr, albedo, hit_color)
            emissive_hit = torch.zeros_like(is_pbr)
            if pbr_mesh.emissive is not None:  # an emissive texel ends a specular path, tested before the class
                emission = torch.pow(torch.clamp(sample_bilinear(pbr_mesh.emissive, hit.uv), min=0.0), 2.2)
                emissive_hit = is_pbr & spec & (torch.amax(emission, dim=-1) > 0.01)
                sharp = torch.where(emissive_hit, full(1.01), sharp)
                if defer_tex:  # the emission is composed outside: its weight and uv
                    emw, em_uv = _where3(emissive_hit, mask, emw), _where3(emissive_hit, hit.uv, em_uv)
                else:
                    accum = _where3(emissive_hit, mask * emission, accum)
                alive = alive & ~emissive_hit
                lane = alive
                is_pbr = is_pbr & ~emissive_hit
            mat = torch.where(is_pbr, torch.full_like(mat, DIFFUSE), mat)
            if pbr_mesh.metallic_roughness is not None:  # roughness: CLEARCOAT; metalness overrides: METAL
                mr = torch.pow(torch.clamp(sample_bilinear(pbr_mesh.metallic_roughness, hit.uv), min=0.0), 2.2)
                mat = torch.where(is_pbr & (mr[..., 1] > 0.01), torch.full_like(mat, CLEARCOAT_DIFFUSE), mat)
                mat = torch.where(is_pbr & (mr[..., 2] > 0.01), torch.full_like(mat, METAL), mat)
                mr_g = torch.where(is_pbr, mr[..., 1], mr_g)
        elif textured:  # a normal map alone: the mesh keeps its own material
            pbr_hits = is_pbr = emissive_hit = torch.zeros_like(alive)
        if textured and lane_counts is not None:
            lane_counts[-1] = _texel_counts(lane_counts[-1], scene.mesh, hit.uv, mesh_won, pbr_hits, is_pbr,
                                            emissive_hit, mat, mr_g, cfg.metal_roughness_lobe, spec)

        # ---- fixed-schedule RNG draws for this bounce ----------------------
        gate1, bn = bn_next(bn)
        gate2, bn = bn_next(bn)
        hem_r, rng = rng_next(rng)
        hem_p, rng = rng_next(rng)
        hem_dir = cos_hemisphere_from_uniforms(nl, hem_r, hem_p)
        if has_quad_light:
            qx, rng = rng_next(rng)
            qy, rng = rng_next(rng)
            qz, rng = rng_next(rng)
            nee_dir, nee_w = quad_light_from_uniforms(x, nl, lv0, lv1, lv2, lv3, l_normal, qx, qy, qz)
        if use_lobe:  # after the quad triple when the lobe is on under quad NEE
            lc, rng = rng_next(rng)
            lp, rng = rng_next(rng)
        if cfg.nee == "sun":  # through the specular lobe about the sun direction
            nee_dir = specular_lobe_from_uniforms(sun_dir.expand(rd.shape), cfg.sun_lobe_roughness, lc, lp)
            sun_cos_w = torch.clamp(dot(nee_dir, nl), min=0.0)
            if cfg.sun_weight_mode == "hdri":
                sp = scene.env.sun_power
                nee_w = sun_cos_w * (sp * sp * 1.0e-7)
            else:
                nee_w = sun_cos_w * 0.05
        elif cfg.nee == "env":
            # inverse-CDF draw over the luminance x sin(theta) marginals, weight
            # cos / (pi pdf); the shadow ray's miss (case c3) brings the radiance
            nee_dir, env_pdf = sample_env_cdf(env_cdf, lc, lp)
            nee_w = torch.clamp(dot(nee_dir, nl), min=0.0) / (math.pi * torch.clamp(env_pdf, min=1e-8))
        gate1, gate2 = gate1.detach(), gate2.detach()

        b_diff = lane & (mat == DIFFUSE)
        b_metal = lane & (mat == METAL)
        b_trans = lane & (mat == TRANSPARENT)
        b_coat = lane & (mat == CLEARCOAT_DIFFUSE)

        # ==== DIFFUSE =======================================================
        d_count_diff = d_count + 1
        mask_diff = mask * hit_color
        go_indirect_d = (d_count_diff <= cfg.diffuse_indirect_max) & (gate1 < 0.5)
        rd_diff = _where3(go_indirect_d, hem_dir, nee_dir)
        mask_diff = _where3(go_indirect_d, mask_diff, mask_diff * nee_w[..., None])
        ro_diff = x + nl * eps
        sl_diff = ~go_indirect_d

        # ==== METAL (a mirror, or the roughness lobe about it) ==============
        mask_metal = mask * hit_color
        rd_metal = reflect(rd, nl)
        if cfg.metal_roughness_lobe:
            rd_metal = specular_lobe_from_uniforms(rd_metal, mr_g, lc, lp)
        ro_metal = x + nl * eps

        # ==== TRANSPARENT ===================================================
        re_t, ratio_t = calc_fresnel_reflectance(rd, n, 1.0, 1.5)
        tr_t = 1.0 - re_t
        p_t = 0.25 + 0.5 * re_t
        go_reflect_t = (gate1 < p_t).detach()
        mask_t_refl = mask * (re_t / p_t)[..., None]
        inside = dot(n, rd) >= 0.0
        if cfg.transparent_tint:
            absorb = hit_color
        else:
            absorb = torch.where(
                inside[..., None],
                torch.exp(torch.log(torch.clamp(hit_color, 0.01, 0.99)) * 0.01 * hit.t[..., None]),
                torch.ones_like(hit_color),
            )
        mask_t_refr = mask * absorb * (tr_t / (1.0 - p_t))[..., None]
        rd_t = _where3(go_reflect_t, reflect(rd, nl), refract(rd, nl, ratio_t))
        ro_t = _where3(go_reflect_t, x + nl * eps, x - nl * eps)
        mask_t = _where3(go_reflect_t, mask_t_refl, mask_t_refr)
        spec_t = torch.where(go_reflect_t, spec, spec | (d_count == 1))
        sharp_t = torch.where(
            (d_count == 0) & ~coat_hit & (not cfg.camera_is_moving),
            full(1.01),
            torch.where(d_count > 0, zero, -one),
        )

        # ==== CLEARCOAT_DIFFUSE =============================================
        re_c, _ = calc_fresnel_reflectance(rd, nl, 1.0, 1.4)
        tr_c = 1.0 - re_c
        p_c = 0.25 + 0.5 * re_c
        go_reflect_c = (gate1 < p_c).detach()
        mask_c_refl = mask * (re_c / p_c)[..., None]
        sharp_c_refl = torch.where(d_count == 0, fc_sharp, zero)
        d_count_coat = d_count + 1
        mask_c_base = mask * (tr_c / (1.0 - p_c))[..., None] * hit_color
        go_indirect_c = (d_count_coat <= cfg.diffuse_indirect_max) & (gate2 < 0.5)
        rd_c_base = _where3(go_indirect_c, hem_dir, nee_dir)
        mask_c_base = _where3(go_indirect_c, mask_c_base, mask_c_base * nee_w[..., None])
        # `bounces < 3` guards against noisy coat-after-glass pixels
        sl_coat = ~go_indirect_c & (bounce < 3)

        rd_coat = _where3(go_reflect_c, reflect(rd, nl), rd_c_base)
        mask_coat = _where3(go_reflect_c, mask_c_refl, mask_c_base)
        d_count_c = torch.where(go_reflect_c, d_count, d_count_coat)
        spec_c = go_reflect_c & spec
        sl_c = ~go_reflect_c & sl_coat
        sharp_c = torch.where(go_reflect_c, sharp_c_refl, zero)

        # ---- merge the four branches ---------------------------------------
        new_rd = _where3(b_diff, rd_diff, rd)
        new_ro = _where3(b_diff, ro_diff, ro)
        new_mask = _where3(b_diff, mask_diff, mask)
        new_spec = spec & ~b_diff
        new_sl = b_diff & sl_diff
        new_dc = torch.where(b_diff, d_count_diff, d_count)
        new_sharp = sharp

        new_rd = _where3(b_metal, rd_metal, new_rd)
        new_ro = _where3(b_metal, ro_metal, new_ro)
        new_mask = _where3(b_metal, mask_metal, new_mask)

        new_rd = _where3(b_trans, rd_t, new_rd)
        new_ro = _where3(b_trans, ro_t, new_ro)
        new_mask = _where3(b_trans, mask_t, new_mask)
        new_spec = torch.where(b_trans, spec_t, new_spec)
        new_sharp = torch.where(b_trans, sharp_t, new_sharp)

        new_rd = _where3(b_coat, rd_coat, new_rd)
        new_ro = _where3(b_coat, x + nl * eps, new_ro)
        new_mask = _where3(b_coat, mask_coat, new_mask)
        new_spec = torch.where(b_coat, spec_c, new_spec)
        new_sl = torch.where(b_coat, sl_c, new_sl)
        new_dc = torch.where(b_coat, d_count_c, new_dc)
        new_sharp = torch.where(b_coat, sharp_c, new_sharp)
        coat_hit = coat_hit | b_coat

        # unknown material ids on live lanes end the path
        alive = alive & (b_diff | b_metal | b_trans | b_coat)

        rd = _where3(lane, new_rd, rd)
        ro = _where3(lane, new_ro, ro)
        mask = _where3(lane, new_mask, mask)
        spec = torch.where(lane, new_spec, spec)
        sample_light = torch.where(lane, new_sl, sample_light)
        d_count = torch.where(lane, new_dc, d_count)
        sharp = torch.where(lane, new_sharp, sharp)
        prev_mat = torch.where(lane, mat, prev_mat)

        if defer_tex:  # the bounces whose throughput took the albedo factor: DIFFUSE, METAL, CLEARCOAT's base
            factor = is_pbr & (b_diff | b_metal | (b_coat & ~go_reflect_c))
            albedo_uv[bounce] = _where3(factor, hit.uv, no_uv)
        if param_grads:
            # the hit object's color enters this bounce's throughput linearly
            # (d log f / d c = 1/c, applied in the backward) or, for a
            # Beer-Lambert exit, as exp(0.01 t log c) (0.01 t / c)
            refracted = b_trans & ~go_reflect_t
            g_lin = b_diff | b_metal | (b_coat & ~go_reflect_c) | lit
            if cfg.transparent_tint:
                g_lin = g_lin | refracted
            hit_j = hit.object_id.detach()[None] == obj_ids
            sg_lin = sg_lin + torch.where(hit_j & g_lin[None], 1.0, 0.0)
            if sg_beer is not None:
                beer = torch.where(refracted & inside, 0.01 * hit.t.detach(), zero)
                sg_beer = sg_beer + torch.where(hit_j, beer[None], 0.0)

    state = state._replace(ro=ro, rd=rd, mask=mask, accum=accum, alive=alive, spec=spec, sample_light=sample_light,
                           coat_hit=coat_hit, d_count=d_count, prev_mat=prev_mat, sharp=sharp, obj_normal=obj_normal,
                           obj_color=obj_color, obj_id=obj_id, rng=rng, bn=bn)
    if param_grads:
        state = state._replace(sg_lin=sg_lin, sg_beer=sg_beer)
    if defer_miss:
        state = state._replace(mw=mw, mdir=mdir)
    if defer_tex:
        state = state._replace(albedo_uv=tuple(albedo_uv), emw=emw, em_uv=em_uv)
    return state


def finish_paths(state: PathState):
    """The per-pixel outputs of finished paths: the RadianceResult, and in
    the grads mode ``(result, sg, deferred)`` (see ``calculate_radiance``)."""
    result = RadianceResult(color=torch.clamp(state.accum, min=0.0), object_normal=state.obj_normal,
                            object_color=state.obj_color, object_id=state.obj_id, pixel_sharpness=state.sharp)
    if state.sg_lin is None:
        return result
    sg = state.sg_lin if state.sg_beer is None else torch.cat([state.sg_lin, state.sg_beer])
    planes = (([state.mw, state.mdir] if state.mw is not None else [])
              + (list(state.albedo_uv) + [state.emw, state.em_uv] if state.emw is not None else []))
    shape = state.sharp.shape
    deferred = (torch.cat([torch.movedim(p, -1, 0) for p in planes]) if planes
                else torch.zeros((0,) + shape, dtype=state.sharp.dtype, device=state.sharp.device))
    return result, sg, deferred.detach()


def calculate_radiance(
    scene: Scene,
    cfg: IntegratorConfig,
    ray_origin: torch.Tensor,
    ray_dir: torch.Tensor,
    rng: RngState,
    bn: BlueNoise,
    frame_counter,
    param_grads: bool = False,
    lane_counts: list | None = None,
    plain_walk: bool = False,
    fast_quads: bool = False,
):
    """Trace one path per lane for up to cfg.bounces bounces:
    ``run_bounces(init_paths(...), 0, cfg.bounces)``, then ``finish_paths``.

    Returns ``(result, rng, bn)``, and with ``param_grads=True``
    ``(result, rng, bn, sg, deferred)``: sg is (n_sg,) + lanes float32,
    detached, n_sg = n_obj with ``cfg.transparent_tint`` and 2 * n_obj
    without; deferred is the (n_def,) + lanes planes of
    ``deferred_layout`` (n_def may be 0), and the color leaves out what they
    defer.

    ``lane_counts``, for measurement, receives one ``LaneCounts`` per
    bounce.  ``plain_walk`` keeps the mesh walk plain on CUDA tensors
    (``scene_intersect``).  ``fast_quads=True`` tests the quads with the
    parallelogram test of the TPU kernel's fast path (every quad must be a
    parallelogram; ``geometry.triangles.resolve_fast_quads``), the default
    with the wavefront's two triangle fans.
    """
    state = init_paths(scene, cfg, ray_origin, ray_dir, rng, bn, frame_counter, param_grads=param_grads)
    state = run_bounces(scene, cfg, state, 0, cfg.bounces, lane_counts=lane_counts, plain_walk=plain_walk,
                        fast_quads=fast_quads)
    if param_grads:
        result, sg, deferred = finish_paths(state)
        return result, state.rng, state.bn, sg, deferred
    return finish_paths(state), state.rng, state.bn
