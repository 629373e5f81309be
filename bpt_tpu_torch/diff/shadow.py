"""Edge-sampled shadow boundary gradients for sphere blockers under the quad
light (port of ``bpt_tpu.diff.shadow``, plain torch; it runs no kernel).

The NEE estimator samples one light point y per (pixel, frame) at each
diffuse vertex x; its visibility V(x, y) is a step function of the blocker's
position, so interior derivatives miss the shadow's motion as they miss the
silhouette's.  The jump set for a receiver x is the sphere's silhouette as
seen from x, carried along the tangent rays onto the light plane: a closed
curve with closed-form geometry and velocity, so the missing term is an
edge integral:

    dE(x)/dθ = −(1/A) ∮_{curve ∩ light rect} g(x, y) · (v(y)·n̂(y)) dl

g = ρ(x) · w_quad(x, y) · e the lit side's NEE integrand, A = |v1−v0|·|v3−v0|
the quad's measure, v the curve's velocity under θ (``torch.func.jvp``
through the tangent-cone construction), n̂ the outward in-plane normal.
The light sampler clamps each uniform to [0.1, 0.9], so a tenth of each
axis's probability sits on the sub-rectangle's edge lines: their crossings
with the curve add one-dimensional terms (the clamped-edge atoms).

The receivers are the frame's exact first hits (the ray generation's draws
replayed), and a receiver counts only where its first diffuse vertex took
the NEE branch.  The integrator takes NEE there unless its cosine bounce is
allowed, ``(1 <= cfg.diffuse_indirect_max) & (gate1 < 0.5)``, gate1 the
blue noise's R channel; the JAX package tests ``gate1 >= 0.5`` alone, which
is the same at the default ``diffuse_indirect_max = 1`` and wrong at 0
(every first diffuse vertex then takes NEE).
"""

from __future__ import annotations

import math

import torch

from bpt_tpu_torch.camera import Camera, generate_rays
from bpt_tpu_torch.core.rng import blue_noise_fetch, rng_seed
from bpt_tpu_torch.core.vecmath import cross, face_forward, normalize
from bpt_tpu_torch.diff.silhouette import _view_basis
from bpt_tpu_torch.integrator.config import IntegratorConfig
from bpt_tpu_torch.integrator.intersect import scene_intersect
from bpt_tpu_torch.scenes.types import DIFFUSE


def _guard(x):
    """x kept at least 1e-9 away from 0, keeping its sign (0 counts as +)."""
    return torch.where(torch.abs(x) < 1e-9, torch.where(x < 0, -1e-9, 1e-9).to(x.dtype), x)


def took_nee(cfg: IntegratorConfig, gate1: torch.Tensor) -> torch.Tensor:
    """Whether the first diffuse vertex (diffuseCount 0 -> 1) takes the NEE
    branch, as the integrator decides it."""
    return ~((1 <= cfg.diffuse_indirect_max) & (gate1 < 0.5))


def first_receivers(scene, camera: Camera, cfg: IntegratorConfig, width: int, height: int, pix, frame_counter,
                    rand_vec2, blue_noise: torch.Tensor):
    """The frame's first hits at the pixels ``pix`` (P, 2): (x, nl, rho,
    valid), valid where the hit is a DIFFUSE surface whose vertex took NEE."""
    px_i = pix[..., 0].to(torch.int32)
    py_i = pix[..., 1].to(torch.int32)
    rng = rng_seed(frame_counter, px_i, py_i)
    ro, rd, _ = generate_rays(camera, px_i, py_i, width, height, rng)
    hit = scene_intersect(scene, ro, rd)
    x = ro + rd * hit.t[..., None]
    nl = face_forward(normalize(hit.normal), rd)
    valid = (hit.t < 1.0e5) & (hit.mat_type == DIFFUSE)
    gate1 = blue_noise_fetch(blue_noise, px_i, py_i, rand_vec2).r  # bounce 0's gate1 is the R channel
    return x, nl, hit.color, valid & took_nee(cfg, gate1)


def quad_shadow_boundary_gradient(scene_fn, theta, center_fn, camera: Camera, cfg: IntegratorConfig, width: int,
                                  height: int, weight_fn, pix, frame_counter, rand_vec2, blue_noise: torch.Tensor,
                                  n_phi: int = 256) -> torch.Tensor:
    """Shadow-edge boundary term of d/dθ [ Σ_pixels weight(x)·I(x) ] for a
    sphere blocker ``center_fn(θ) -> (center (3,), radius)`` under the
    scene's quad light (``cfg.light_index``, or the last quad), for one
    frame's draws.

    ``pix``: (P, 2) pixel-centre coordinates of the receiver window; the
    receivers are the frame's first hits there (``first_receivers``), which
    must be static diffuse surfaces.  ``weight_fn(pix) -> (P, 3)`` is
    dLoss/dI.  Runs on the device of ``blue_noise``.  Average over frames
    and add to the interior gradient (and the silhouette term where the
    window meets the silhouette).
    """
    dev = blue_noise.device
    theta = torch.as_tensor(theta, dtype=torch.float32, device=dev).detach()
    with torch.no_grad():
        scene = scene_fn(theta)
        quads = scene.quads
        li = cfg.light_index if cfg.light_index >= 0 else quads.v0.shape[0] - 1
        lv0, lv1, lv3 = quads.v0[li], quads.v1[li], quads.v3[li]
        ln = normalize(quads.normal[li])
        e_light = quads.color[li]
        e1, e3 = lv1 - lv0, lv3 - lv0
        l1 = torch.sqrt((e1 * e1).sum())
        l3 = torch.sqrt((e3 * e3).sum())
        area_full = l1 * l3
        x, nl, rho, valid = first_receivers(scene, camera, cfg, width, height, pix, frame_counter, rand_vec2,
                                            blue_noise)
    phis = (torch.arange(n_phi, dtype=torch.float32, device=dev) + 0.5) / n_phi * 2.0 * math.pi
    to_plane = ((lv0[None] - x) * ln).sum(-1)  # (P,)

    def curve(th):
        """Silhouette-from-x tangent points extended to the light plane:
        (P, F, 3) points y and the ray parameter (for facing checks)."""
        c, r = center_fn(th)
        a = c[None] - x
        d = torch.sqrt(torch.clamp((a * a).sum(-1, keepdim=True), min=1e-12))
        a = a / d
        u, v = _view_basis(a)
        rr = r * torch.sqrt(torch.clamp(1.0 - (r / d[:, 0]) ** 2, min=1e-8))
        cp = c[None] - (r ** 2 / d) * a
        pt = cp[:, None] + rr[:, None, None] * (torch.cos(phis)[None, :, None] * u[:, None]
                                                + torch.sin(phis)[None, :, None] * v[:, None])
        dirv = pt - x[:, None]
        tt = to_plane[:, None] / _guard((dirv * ln).sum(-1))
        return x[:, None] + tt[..., None] * dirv, tt

    (y, tt), (vy, _) = torch.func.jvp(curve, (theta,), (torch.ones_like(theta),))

    with torch.no_grad():
        # in-plane tangent, arc length and outward normal
        dy = (torch.roll(y, -1, 1) - torch.roll(y, 1, 1)) * 0.5
        dl = torch.sqrt(torch.clamp((dy * dy).sum(-1), min=1e-18))
        nrm = cross(ln.expand(y.shape), dy)
        nrm = nrm / torch.clamp(torch.sqrt((nrm * nrm).sum(-1, keepdim=True)), min=1e-12)
        # outward: away from the blocked region's centre, the sphere centre's central projection
        c0, _ = center_fn(theta)
        dir_c = c0[None] - x
        t_c = to_plane / _guard((dir_c * ln).sum(-1))
        y_c = x + t_c[:, None] * dir_c
        sgn = torch.sign((nrm * (y - y_c[:, None])).sum(-1))
        nrm = nrm * torch.where(sgn == 0.0, torch.ones_like(sgn), sgn)[..., None]

        # inside the sampled sub-rectangle, in front of the receiver
        s1 = ((y - lv0) * e1).sum(-1) / (l1 * l1)
        s3 = ((y - lv0) * e3).sum(-1) / (l3 * l3)
        inside = (s1 > 0.1) & (s1 < 0.9) & (s3 > 0.1) & (s3 < 0.9) & (tt > 0.0) & valid[:, None]

        # the lit side's NEE integrand at y (lights.quad_light_from_uniforms)
        dirl = y - x[:, None]
        d2 = (dirl * dirl).sum(-1)
        dirl = dirl / torch.sqrt(torch.clamp(d2, min=1e-18))[..., None]
        cos_a_max = torch.sqrt(torch.clamp(1.0 - torch.clamp(area_full / torch.clamp(d2, min=1e-20), 0.0, 1.0),
                                           min=0.0))
        dot_nl = torch.clamp((dirl * nl[:, None]).sum(-1), min=0.0)
        w_quad = torch.clamp(2.0 * (1.0 - cos_a_max) * torch.clamp(-(dirl * ln).sum(-1), min=0.0) * dot_nl,
                             0.0, 1.0)
        g = rho[:, None] * w_quad[..., None] * e_light[None, None]  # (P, F, 3)

        wpx = weight_fn(pix)  # (P, 3)
        vn = (vy * nrm).sum(-1)
        total = (-(wpx[:, None] * g).sum(-1) * vn * dl * inside / area_full).sum()

        # the clamped-edge atoms: along an edge line s_e == lvl the sample is
        # uniform in the other axis's coordinate, and V flips where the curve
        # crosses the line; each crossing carries 0.1 (the collapsed mass) x g
        # x the crossing's velocity along the line (the implicit function
        # theorem on s_e(phi, theta) = lvl) x its orientation
        ds1_dth = (vy * e1).sum(-1) / (l1 * l1)
        ds3_dth = (vy * e3).sum(-1) / (l3 * l3)
        ds1_dph = (dy * e1).sum(-1) / (l1 * l1)
        ds3_dph = (dy * e3).sum(-1) / (l3 * l3)
        sc1 = ((y_c - lv0) * e1).sum(-1) / (l1 * l1)
        sc3 = ((y_c - lv0) * e3).sum(-1) / (l3 * l3)
        gw = (g * wpx[:, None]).sum(-1)

        def edge_term(s_e, s_o, ds_e_dth, ds_o_dth, ds_e_dph, ds_o_dph, lvl, sc_o):
            def nxt(a):
                return torch.roll(a, -1, 1)

            f_e = s_e - lvl
            cross_ = (f_e * nxt(f_e) < 0.0) & valid[:, None]
            step = f_e - nxt(f_e)
            tau = f_e / torch.where(torch.abs(step) < 1e-12, torch.full_like(step, 1e-12), step)

            def lerp(a):
                return a + tau * (nxt(a) - a)

            s_o_x = lerp(s_o)
            in_seg = (s_o_x > 0.1) & (s_o_x < 0.9) & (lerp(tt) > 0.0)
            v_o = lerp(ds_o_dth) - lerp(ds_o_dph) * (lerp(ds_e_dth) / _guard(lerp(ds_e_dph)))
            sigma = torch.sign(s_o_x - sc_o[:, None])
            term = -0.1 * lerp(gw) * v_o * sigma
            return torch.where(cross_ & in_seg, term, torch.zeros_like(term)).sum()

        for lvl in (0.1, 0.9):
            total = total + edge_term(s1, s3, ds1_dth, ds3_dth, ds1_dph, ds3_dph, lvl, sc3)
            total = total + edge_term(s3, s1, ds3_dth, ds1_dth, ds3_dph, ds1_dph, lvl, sc1)
        return total
