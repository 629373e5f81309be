"""Edge-sampled silhouette gradients for sphere transforms.

Port of ``bpt_tpu.diff.silhouette``, in plain torch (it runs no kernel).
Detached-sampling autograd differentiates the integrand but drops the
boundary term: moving a sphere moves its silhouette, and the visibility
jump across it carries a gradient no interior derivative sees.  This adds
that term with the edge-sampling estimator (Li et al. 2018's boundary
integral, for the one shape whose silhouette is closed-form):

    dL/dθ |boundary = ∮_edge  w(x) · (L_in(x) − L_out(x)) · (v(x)·n̂(x)) dl

over the sphere's image-space silhouette: w the loss's weight at pixel x,
L_in / L_out the radiance just inside and outside the edge, v = ∂x/∂θ the
edge velocity (``torch.func.jvp`` through the silhouette construction) and
n̂ the outward edge normal.  For a sphere of centre c, radius r seen from o
the 3-D silhouette is the circle of centre c − (r²/d)·a and radius
r·sqrt(1 − r²/d²), a = (c − o)/d, d = |c − o|.  L_in and L_out come from the
wavefront integrator on rays through film points ±ε pixels along n̂, with
common random numbers per edge sample.
"""

from __future__ import annotations

import math

import torch

from bpt_tpu_torch.camera import Camera, film_extents
from bpt_tpu_torch.core.rng import RngState, blue_noise_fetch
from bpt_tpu_torch.core.vecmath import cross, normalize
from bpt_tpu_torch.integrator.config import IntegratorConfig
from bpt_tpu_torch.integrator.radiance import calculate_radiance

_U32 = 0xFFFFFFFF


def _project(camera: Camera, p, width: int, height: int):
    """World point -> continuous pixel coordinates (gl_FragCoord space)."""
    ulen, vlen = film_extents(camera, width, height)
    rel = p - camera.position
    z = (rel * camera.forward).sum(-1)
    x = (rel * camera.right).sum(-1) / (ulen * z)
    y = (rel * camera.up).sum(-1) / (vlen * z)
    return torch.stack([(x + 1.0) * 0.5 * width, (y + 1.0) * 0.5 * height], -1)


def _rays_through(camera: Camera, pix, width: int, height: int):
    """Pinhole rays through continuous film coords pix (..., 2)."""
    ulen, vlen = film_extents(camera, width, height)
    ndc_x = pix[..., 0] / width * 2.0 - 1.0
    ndc_y = pix[..., 1] / height * 2.0 - 1.0
    rd = normalize(ndc_x[..., None] * camera.right * ulen + ndc_y[..., None] * camera.up * vlen + camera.forward)
    return camera.position.expand(rd.shape).contiguous(), rd


def _view_basis(a):
    """(u, v) orthonormal to the unit vectors a (..., 3), as the JAX
    package builds them."""
    y = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    x = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    h = torch.where((torch.abs(a[..., 1:2]) < 0.9), y, x)
    u = normalize(cross(h, a))
    return u, cross(a, u)


def _silhouette_points(camera: Camera, center, radius, phis):
    """3-D silhouette circle points of the sphere, one per angle."""
    a = center - camera.position
    d = torch.sqrt(torch.clamp((a * a).sum(), min=1e-12))
    a = a / d
    u, v = _view_basis(a)
    rr = radius * torch.sqrt(torch.clamp(1.0 - (radius / d) ** 2, min=1e-8))
    cprime = center - (radius ** 2 / d) * a
    return cprime[None] + rr * (torch.cos(phis)[:, None] * u[None] + torch.sin(phis)[:, None] * v[None])


def crn_streams(n: int, k: int, device) -> tuple[RngState, torch.Tensor, torch.Tensor]:
    """Replicate k's common random numbers for n edge samples: the hash
    state (sx·(k+3), sx + 17k) of the pseudo-pixel ids sx = (7919·i + 13)
    mod 104729, and the blue-noise texel (sx mod 256, (sx div 7) mod 256).
    The uint32 arithmetic is int64 masked to 32 bits (torch's CPU uint32
    has no ``+`` or ``*``)."""
    sx = (torch.arange(n, dtype=torch.int64, device=device) * 7919 + 13) % 104729
    rng = RngState(sx=(sx * (k + 3)) & _U32, sy=(sx + 17 * k) & _U32)
    return rng, sx % 256, (sx // 7) % 256


def sphere_silhouette_gradient(scene_fn, theta, center_fn, camera: Camera, cfg: IntegratorConfig, width: int,
                               height: int, weight_fn, frame_counter, rand_vec2, blue_noise: torch.Tensor,
                               n_samples: int = 512, n_paths: int = 8, eps_px: float = 0.35) -> torch.Tensor:
    """Boundary term of d/dθ [ Σ_pixels weight(x) · I(x) ] for a sphere whose
    centre and radius depend on the scalar tensor θ.

    ``scene_fn(θ) -> Scene`` (the radiance just inside and outside the edge,
    at the current θ); ``center_fn(θ) -> (center (3,), radius)``, the
    closed-form silhouette geometry, differentiated with ``torch.func.jvp``;
    ``weight_fn(pix (..., 2)) -> (..., 3)``, dLoss/dI at continuous pixel
    positions.  ``n_paths`` replicates per edge sample share their random
    numbers across the in/out pair.  Runs on the device of ``blue_noise``
    (``frame_counter`` a host number, ``rand_vec2`` a host pair).  Returns
    the scalar boundary gradient, to be added to the interior gradient.
    """
    theta = torch.as_tensor(theta, dtype=torch.float32, device=blue_noise.device).detach()
    scene = scene_fn(theta)
    dev = blue_noise.device
    phis = (torch.arange(n_samples, dtype=torch.float32, device=dev) + 0.5) / n_samples * 2.0 * math.pi

    def pix_of(th):
        c, r = center_fn(th)
        return _project(camera, _silhouette_points(camera, c, r, phis), width, height)

    pix, vel = torch.func.jvp(pix_of, (theta,), (torch.ones_like(theta),))

    with torch.no_grad():
        c0, _ = center_fn(theta)
        c_pix = _project(camera, c0[None], width, height)[0]
        nrm = pix - c_pix[None]
        nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), min=1e-9)
        dpix = (torch.roll(pix, -1, 0) - torch.roll(pix, 1, 0)) * 0.5
        dl = torch.linalg.vector_norm(dpix, dim=-1)

        def radiance(p):
            ro, rd = _rays_through(camera, p, width, height)
            acc = 0.0
            for k in range(n_paths):
                rng, bx, by = crn_streams(p.shape[0], k, dev)
                bn = blue_noise_fetch(blue_noise, bx, by, rand_vec2)
                res, _, _ = calculate_radiance(scene, cfg, ro, rd, rng, bn, frame_counter)
                acc = acc + res.color
            return acc / n_paths

        l_in = radiance(pix - eps_px * nrm)
        l_out = radiance(pix + eps_px * nrm)
        w = weight_fn(pix)
        vn = (vel * nrm).sum(-1)
        # moving the edge outward by vn replaces L_out with L_in over a strip of vn·dl pixels
        return ((w * (l_in - l_out)).sum(-1) * vn * dl).sum()
